"""Command-line interface.

The reference ships 19 standalone ``main()`` binaries, each a hard-wired
variant run (``./binary <block_dim_x> <block_dim_y>``,
``naivePar/...BlockPerElement-Naive.cu:345-348``).  Here one CLI covers the
same surface:

  python -m fluidsimulationcuda_tpu run      --n 510 --steps 100 --save out.npz
  python -m fluidsimulationcuda_tpu run      --resume out.npz --steps 50
  python -m fluidsimulationcuda_tpu profile  --n 2046
  python -m fluidsimulationcuda_tpu datagen  --n 254 --batch 64 --steps 20 --out traj.npz
  python -m fluidsimulationcuda_tpu info
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .utils.cache import enable_compilation_cache

enable_compilation_cache()

import jax  # noqa: E402

from . import SimConfig, make_step_fn, zero_sources  # noqa: E402
from .utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402


def _add_common(p):
    p.add_argument("--n", type=int, default=510)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--backend", default="auto",
                   choices=["auto", "reference", "hopper"],
                   help="hopper: Jacobi solves in the fused CUDA kernel "
                        "(NVIDIA Hopper, float32 2-D); auto: hopper where it "
                        "qualifies, plain XLA ops otherwise")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dt", type=float, default=0.016)
    p.add_argument("--visc", type=float, default=0.0025)
    p.add_argument("--diff", type=float, default=0.1,
                   help="the reference's alpha = dt*diff*n^2 scaling makes "
                        "large grids hyper-diffusive; lower for demos")
    p.add_argument("--ndim", type=int, default=2, choices=(2, 3),
                   help="3 runs the smoke-volume solver (reference scenario "
                        "only; scenarios/PNG are 2-D)")
    # The solver knobs --perf overrides default to None (a sentinel) so
    # "explicitly passed" is detectable even when the passed value equals
    # the resolved default — _cfg() resolves None to the real defaults.
    p.add_argument("--pressure-solver", default=None,
                   choices=["jacobi", "multigrid", "cg", "chebyshev"],
                   help="pressure solve (default jacobi)")
    p.add_argument("--diffusion-solver", default=None,
                   choices=["jacobi", "chebyshev", "chebyshev-dens"],
                   help="default jacobi; chebyshev-dens accelerates only "
                        "the density solve (velocity stays bit-parity; "
                        "see core/config.py)")
    p.add_argument("--cheby-iters", type=int, default=None,
                   help="sweeps per solve in chebyshev modes (default 8)")
    p.add_argument("--cheby-press-iters", type=int, default=None,
                   help="decoupled pressure sweep count (default 0 = "
                        "follow --cheby-iters); the compensated perf mode "
                        "is --diffusion-solver chebyshev --pressure-solver "
                        "chebyshev --cheby-iters 10 --cheby-press-iters 14 "
                        "--cheby-rho 0.9")
    p.add_argument("--cheby-rho", type=float, default=None,
                   help="Chebyshev interval parameter (default 0.99; free "
                        "knob, not a stability bound; ops/chebyshev.py)")
    p.add_argument("--perf", action="store_true",
                   help="apply the validated compensated perf-mode preset "
                        "for --ndim/--n (size-coupled, from "
                        "core/config.PERF_POINTS_2D — e.g. 2-D 2048²: "
                        "cheby-10 @ rho=0.9 + 14 pressure sweeps; 3-D: "
                        "cheby-10 @ rho=0.85 + 12 sweeps).  "
                        "Operating points are validated per "
                        "dimensionality/size (core/config.py); "
                        "explicit solver flags are overridden (with a "
                        "warning).  Pair with --validate to run the "
                        "solver-quality bars at YOUR size before trusting "
                        "the preset there")


# Solver knobs --perf overrides; (flag dest, resolved default when the
# None sentinel survives to _build_cfg).
_PERF_OVERRIDDEN = (
    ("pressure_solver", "jacobi"), ("diffusion_solver", "jacobi"),
    ("cheby_iters", 8), ("cheby_press_iters", 0), ("cheby_rho", 0.99),
)


def _cfg(args):
    if getattr(args, "perf", False):
        # None is the "not passed" sentinel, so ANY explicit flag —
        # including one passing the default value — triggers the warning.
        clobbered = [f for f, _ in _PERF_OVERRIDDEN
                     if getattr(args, f, None) is not None]
        if clobbered:
            print("WARNING: --perf overrides explicitly passed "
                  + ", ".join("--" + f.replace("_", "-")
                              for f in clobbered)
                  + " (the preset is a validated operating POINT; drop "
                    "--perf to tune knobs individually)", file=sys.stderr)
        from .core.config import perf_operating_point

        ndim = getattr(args, "ndim", 2)
        rho, k_d, k_p = perf_operating_point(args.n + 2, ndim)
        args.pressure_solver = "chebyshev"
        args.diffusion_solver = "chebyshev"
        args.cheby_iters = k_d
        args.cheby_press_iters = k_p
        args.cheby_rho = rho
    return _build_cfg(args)


def _build_cfg(args):
    def knob(f, default):
        v = getattr(args, f, None)
        return default if v is None else v

    return SimConfig(n=args.n, jacobi_iters=args.iters, backend=args.backend,
                     dt=args.dt, visc=args.visc, diff=args.diff,
                     pressure_solver=knob("pressure_solver", "jacobi"),
                     diffusion_solver=knob("diffusion_solver", "jacobi"),
                     cheby_iters=knob("cheby_iters", 8),
                     cheby_press_iters=knob("cheby_press_iters", 0),
                     cheby_rho=knob("cheby_rho", 0.99),
                     ndim=getattr(args, "ndim", 2))


def cmd_run(args) -> None:
    continuous = False
    if args.resume:
        state, cfg, start_step = load_checkpoint(args.resume)
        sources = None
        print(f"resumed step {start_step}, n={cfg.n}", file=sys.stderr)
    else:
        from .models.scenarios import SCENARIOS

        cfg = _cfg(args)
        if cfg.ndim == 3:
            from .core.state import reference_init

            state, sources = reference_init(jax.random.key(args.seed), cfg)
        else:
            state, sources, continuous = SCENARIOS[args.scenario](
                jax.random.key(args.seed), cfg
            )
        start_step = 0
    if getattr(args, "validate", False):
        if cfg.ndim == 3:
            print("--validate: bars are 2-D (bench.py --ndim 3 runs the "
                  "3-D twins); skipping", file=sys.stderr)
        elif (cfg.pressure_solver == "jacobi"
              and cfg.diffusion_solver == "jacobi"):
            print("--validate: parity jacobi config IS the bar; skipping",
                  file=sys.stderr)
        else:
            import dataclasses

            from .utils.validate import validate_perf_point

            parity = dataclasses.replace(
                cfg, pressure_solver="jacobi", diffusion_solver="jacobi")
            print(f"validating solver point at n={cfg.n} against "
                  f"jacobi-{cfg.jacobi_iters} (the bench.py bars)...",
                  file=sys.stderr)
            bars = validate_perf_point(parity, cfg)
            for k, v in bars.items():
                print(f"  {k}: {v:.3e}" if isinstance(v, float)
                      else f"  {k}: {v}", file=sys.stderr)
            if bars["ok"]:
                print("validation PASSED: the solver point is no worse "
                      "than the parity solve at this size", file=sys.stderr)
            else:
                print("validation FAILED at this size — operating points "
                      "are size-coupled (core/config.py); tune "
                      "--cheby-iters/--cheby-press-iters/--cheby-rho or "
                      "drop --perf.  Continuing the run with the "
                      "requested config.", file=sys.stderr)
    # The audited step returns the max backtrace displacement alongside the
    # state (device-side; one extra reduction pair — effectively free).
    import functools

    from .kernels.dispatch import resolve_backend

    backend, reason = resolve_backend(cfg)
    print(f"backend: {backend} ({reason})", file=sys.stderr)

    if cfg.ndim == 3:
        from .models.stable_fluids_3d import step_audited3

        step = jax.jit(functools.partial(step_audited3, cfg))
    else:
        from .models.stable_fluids_2d import step_audited

        step = jax.jit(functools.partial(step_audited, cfg))
    zeros = zero_sources(cfg)
    disps = []
    t0 = time.perf_counter()
    for k in range(args.steps):
        if sources is not None and (continuous or (k == 0 and start_step == 0)):
            src = sources
        else:
            src = zeros
        state, d = step(state, src)
        disps.append(d)
    jax.block_until_ready(state)
    dt_total = time.perf_counter() - t0
    dens = np.asarray(state.dens)
    dmax = max((float(d) for d in disps), default=0.0)
    # The stability check the reference stubbed out and never wrote
    # (FluidSequential.c:309) — finite fields of the FINAL state.
    from .utils.stability import check_stability

    rep = check_stability(cfg, state)
    stable = ("stable" if bool(rep.finite) else "UNSTABLE (non-finite!)")
    print(
        f"{args.steps} steps in {dt_total:.3f}s "
        f"({dt_total / args.steps * 1e3:.2f} ms/step incl. dispatch); "
        f"dens sum={dens.sum():.4f} max={dens.max():.5f}; "
        f"audited displacement {dmax:.3f} cells; {stable}, "
        f"max speed {float(rep.max_speed):.4f}",
        file=sys.stderr,
    )
    if args.save:
        save_checkpoint(args.save, state, cfg, step=start_step + args.steps)
        print(f"saved {args.save}", file=sys.stderr)
    if args.png:
        from .utils.viz import save_density_png

        dens_img = state.dens
        title = (f"{args.scenario if not args.resume else 'resumed'}"
                 f" @ step {start_step + args.steps}")
        if dens_img.ndim == 3:  # 3-D run: render the mid-z plane
            mid = dens_img.shape[0] // 2
            dens_img = dens_img[mid]
            title += f" (z={mid} slice)"
        save_density_png(args.png, dens_img, title=title)
        print(f"wrote {args.png}", file=sys.stderr)


def cmd_profile(args) -> None:
    from .utils.timing import profile_phases

    cfg = _cfg(args)
    if args.trace:
        # jax.profiler trace around a few steps (viewable in TensorBoard /
        # xprof) — the deep-dive companion to the phase table, standing in
        # for the reference's external Nsight Compute workflow
        # (document/main.tex:219).
        from . import make_step_fn, reference_init, zero_sources

        state, sources = reference_init(jax.random.key(args.seed), cfg)
        step = make_step_fn(cfg)
        zeros = zero_sources(cfg)
        state = jax.block_until_ready(step(state, sources))
        with jax.profiler.trace(args.trace):
            for _k in range(5):
                state = step(state, zeros)
            jax.block_until_ready(state)
        print(f"trace written to {args.trace}", file=sys.stderr)
    report = profile_phases(cfg, jax.random.key(args.seed))
    print(report.pretty())


def cmd_datagen(args) -> None:
    from .models.batched import generate_trajectories

    cfg = _cfg(args)
    key = jax.random.key(args.seed)
    final, snaps, max_disp = generate_trajectories(
        key, cfg, args.batch, args.steps,
        snapshot_every=args.snapshot_every,
    )
    payload = {"dens_final": np.asarray(final.dens)}
    if snaps is not None:
        payload["dens_snapshots"] = np.asarray(snaps)
    np.savez_compressed(args.out, **payload)
    print(f"audited max backtrace displacement {float(max_disp):.3f} cells",
          file=sys.stderr)
    print(f"wrote {args.out}: "
          + ", ".join(f"{k}{v.shape}" for k, v in payload.items()),
          file=sys.stderr)


def cmd_info(_args) -> None:
    print(f"jax {jax.__version__}")
    print(f"backend: {jax.default_backend()}")
    print(f"devices: {jax.devices()}")
    from .oracle import native

    print(f"native C++ engine: {'available' if native.available() else 'unavailable'}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="fluidsimulationcuda_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run a simulation")
    _add_common(p)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--save", default=None, help="checkpoint path to write")
    p.add_argument("--resume", default=None, help="checkpoint path to load")
    p.add_argument("--scenario", default="reference",
                   choices=["reference", "plume", "vortex-pair", "jets"])
    p.add_argument("--png", default=None, help="render final density to PNG")
    p.add_argument("--validate", action="store_true",
                   help="run the solver-quality bars (bench.py's live "
                        "validation: divergence + residual ratios vs the "
                        "parity jacobi solve) once at THIS size/solver "
                        "before the timed run — operating points are "
                        "size-coupled, so a preset validated at 2048² "
                        "must be re-checked elsewhere")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("profile", help="per-phase timing report")
    _add_common(p)
    p.add_argument("--trace", default=None,
                   help="also write a jax.profiler trace to this directory")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("datagen", help="batched trajectory generation")
    _add_common(p)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--snapshot-every", type=int, default=0)
    p.add_argument("--out", default="trajectories.npz")
    p.set_defaults(fn=cmd_datagen)

    p = sub.add_parser("info", help="environment info")
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
