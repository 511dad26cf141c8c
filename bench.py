"""Benchmark harness — prints the headline JSON line (first), then a
clearly-labeled performance-mode line (Chebyshev-accelerated solves by
default — see ``--perf-solver`` — divergence- and residual-validated
against the parity solves live on every run).

Headline (BASELINE.json): full-step throughput in Mcell-updates/s at 2048²
(n = 2046, padded side 2048 — same padding convention as the reference's
N = 2^13-2, ``FluidSequential.c:6``) with 20 Jacobi iterations.

vs_baseline: the reference GPU (RTX 3050 Laptop) ran 102.6 ms/step at 2^22
cells with 40 Jacobi iters (BASELINE.md scaling table).  Scaling its diffuse
cost to 20 iters (per-sweep 4.61 ms at 2^26 → 0.29 ms at 2^22; 200→100
sweeps) gives ≈ 73.8 ms/step → ≈ 56.8 Mcell-updates/s.  That derived number
is the denominator.

Usage:
  python bench.py                 # headline: 2048², 20 iters
  python bench.py --sweep         # scaling sweep (stderr table)
  python bench.py --n 1022 --iters 40 --steps 20
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp

from fluidsimulationcuda_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

import dataclasses  # noqa: E402
import functools  # noqa: E402

from fluidsimulationcuda_tpu import (  # noqa: E402
    SimConfig,
    make_step_fn,
    reference_init,
    zero_sources,
)
from fluidsimulationcuda_tpu.core.config import (  # noqa: E402
    perf_operating_point,
)
from fluidsimulationcuda_tpu.utils.validate import (  # noqa: E402
    # Shared with the CLI's ``run --perf --validate``.
    audit_dens_residual,
    audit_diffusion_residual,
    audit_displacement,
    audit_divergence,
    inject_exact,
)

BASELINE_MCELLS_PER_S = 56.8  # derived above


def _run(step_fn, state, drive, steps) -> float:
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step_fn(state, drive)
    jax.block_until_ready(state)
    return time.perf_counter() - t0


def bench_step(cfg: SimConfig, steps: int, warmup: int = 3,
               forcing: float = 0.0) -> float:
    """Marginal seconds per step (the reference's 50-step averaged loop,
    ``optPar/LOOPUNROLLED-Interleaved2.cu:680-727``).

    ``forcing=0``: steady decay with zero sources (the reference harness —
    sources fire on step 1 only, ``FluidSequential.c:289-303``).
    ``forcing=s``: the reference's random sources, scaled by ``s``, fire
    EVERY step — continuous inflow with sustained multi-cell displacement.

    Measured as the slope between a short and a long run, so the fixed
    dispatch latency of a run drops out.
    """
    state, transient = inject_exact(cfg)
    if forcing:
        _, sources = reference_init(jax.random.key(0), cfg)
        drive = jax.tree.map(lambda s: forcing * s, sources)
    else:
        drive = None

    disp = audit_displacement(cfg, state, warmup + steps, drive=drive)

    drive_t = zero_sources(cfg) if drive is None else drive
    step_fn = make_step_fn(cfg)
    for _ in range(warmup):
        state = step_fn(state, drive_t)
    jax.block_until_ready(state)

    short = max(2, steps // 5)
    t_short = min(_run(step_fn, state, drive_t, short) for _ in range(2))
    t_long = min(_run(step_fn, state, drive_t, steps) for _ in range(2))
    bench_step.last_max_displacement = disp
    bench_step.last_transient = transient
    return max((t_long - t_short) / (steps - short), 1e-9)


def perf_mode_line(cfg: SimConfig, steps: int, headline_mcells: float,
                   solver: str = "chebyshev", forcing: float = 0.0) -> dict:
    """Measure the performance-mode step at the headline grid, validated
    against the parity Jacobi-20 numerics on the same trajectory.

    ``forcing``: validate AND time on the continuous-forcing trajectory
    (the reference's random sources scaled by ``forcing`` fire every
    step) — the divergence and velocity-residual bars then run under the
    sustained multi-cell displacement the forcing headline reports.

    ``solver="compensated"`` (default): ALL solves Chebyshev-10 at
    rho=0.9 with the pressure solve raised to 14 sweeps — the extra
    pressure sweeps remove exactly the mid-frequency divergence the
    diffusion swap injects.  Validated
    by (a) post-projection max|divergence| <= the Jacobi-20 solve's,
    (b) velocity diffusion-solve residual ratio <= 1, and (c) the density
    residual bar on a forcing twin, all live on every run.

    ``solver="multigrid"``: one V-cycle per pressure solve (the
    reference's named future work, ``document/main.tex:356``); divergence-
    validated (``--perf-solver multigrid``)."""
    if solver == "multigrid":
        perf_cfg = dataclasses.replace(cfg, pressure_solver="multigrid",
                                       mg_cycles=1)
        label = "multigrid pressure"
    elif solver == "compensated":
        # The compensated diffusion swap: ALL solves Chebyshev-k_d with the
        # pressure solve raised to k_p sweeps to remove the swap's extra
        # mid-frequency divergence.  Validated by divergence + velocity
        # residual + density residual bars below.  Operating points are
        # SIZE-COUPLED; the single source of truth is
        # core/config.PERF_POINTS_2D (shared with ``run --perf``), and the
        # live bars catch a failed transfer to an unprobed side.
        rho, k_d, k_p = perf_operating_point(cfg.n + 2, ndim=2)
        perf_cfg = dataclasses.replace(
            cfg, pressure_solver="chebyshev", diffusion_solver="chebyshev",
            cheby_rho=rho, cheby_iters=k_d, cheby_press_iters=k_p)
        label = (f"chebyshev-{k_d} diffusion + chebyshev-{k_p} pressure "
                 f"(rho={rho}, compensated)")
    elif solver == "chebyshev-all":
        # All five solves accelerated at equal sweeps: FAILS the divergence
        # bar — swapping the diffusion solver changes the trajectory itself,
        # so it cannot be validated against parity the way a pressure-only
        # swap can.  Reported with divergence_ok=false; not default.
        perf_cfg = dataclasses.replace(
            cfg, pressure_solver="chebyshev", diffusion_solver="chebyshev")
        label = (f"chebyshev-{perf_cfg.cheby_iters} ALL solves "
                 f"(rho={perf_cfg.cheby_rho})")
    elif solver == "chebyshev+dens":
        # Pressure swap (divergence-validated as below) PLUS the density
        # solve on Chebyshev (velocity trajectory identical to the
        # pressure-only mode by construction — density feeds no
        # divergence); the density swap is validated by its own residual
        # bar on a forcing twin (audit_dens_residual).
        perf_cfg = dataclasses.replace(
            cfg, pressure_solver="chebyshev",
            diffusion_solver="chebyshev-dens")
        label = (f"chebyshev-{perf_cfg.cheby_iters} pressure + "
                 f"chebyshev-{perf_cfg.cheby_dens_iters} dens "
                 f"(rho={perf_cfg.cheby_rho})")
    else:
        perf_cfg = dataclasses.replace(cfg, pressure_solver="chebyshev")
        label = (f"chebyshev-{perf_cfg.cheby_iters} pressure "
                 f"(rho={perf_cfg.cheby_rho})")
    state, _ = inject_exact(cfg)
    fdrive = None
    if forcing:
        _, sources = reference_init(jax.random.key(0), cfg)
        fdrive = jax.tree.map(lambda s: jnp.float32(forcing) * s, sources)
    val_steps = min(20, steps)
    div_jac = audit_divergence(cfg, state, val_steps, drive=fdrive)
    div_perf = audit_divergence(perf_cfg, state, val_steps, drive=fdrive)
    rec = {
        "metric": f"perf-mode throughput @ {cfg.n + 2}^2 ({label}), "
                  f"vs jacobi-{cfg.jacobi_iters} parity mode"
                  + (f", forcing x{forcing}" if forcing else ""),
        "max_abs_divergence": float(f"{div_perf:.3e}"),
        "jacobi_max_abs_divergence": float(f"{div_jac:.3e}"),
        "divergence_ok": bool(div_perf <= div_jac),
    }
    if solver in ("chebyshev-all", "compensated"):
        if fdrive is not None:
            ratio, (rc, rj) = audit_diffusion_residual(
                perf_cfg, state, val_steps, drive=fdrive)
            traj = f"continuous forcing x{forcing}"
        else:
            # Decay velocities can be EXTINCT at large alpha (8192²/40it:
            # residuals ~1e-34 — a denormal-noise ratio), so the
            # velocity bar runs on a x0.05 forcing twin, the same
            # construction audit_dens_residual has always used.
            from fluidsimulationcuda_tpu.utils.validate import (
                audit_diffusion_residual_twin,
            )

            ratio, (rc, rj) = audit_diffusion_residual_twin(
                perf_cfg, state, val_steps)
            traj = ("continuous forcing x0.05 twin (decay velocity "
                    "residuals can be extinct)")
        rec["diffusion_residual_ratio"] = round(ratio, 3)
        rec["diffusion_ok"] = bool(ratio <= 1.0)
        rec["diffusion_residual_trajectory"] = traj
        print(f"perf-mode diffusion residual ({traj}): cheby {rc:.3e} vs "
              f"jacobi-{cfg.jacobi_iters} {rj:.3e} (worst ratio "
              f"{ratio:.3f})", file=sys.stderr)
        if solver == "compensated":
            # the swap also puts density on cheby-k_d: its own bar
            dratio, (dc, dj) = audit_dens_residual(
                dataclasses.replace(perf_cfg,
                                    cheby_dens_iters=perf_cfg.cheby_iters),
                state, val_steps)
            rec["dens_residual_ratio"] = round(dratio, 3)
            rec["dens_ok"] = bool(dratio <= 1.0)
            print(f"perf-mode dens residual (forcing twin): "
                  f"cheby-{perf_cfg.cheby_iters} {dc:.3e} vs "
                  f"jacobi-{cfg.jacobi_iters} {dj:.3e} (worst ratio "
                  f"{dratio:.3f})", file=sys.stderr)
    elif solver == "chebyshev+dens":
        ratio, (rc, rj) = audit_dens_residual(cfg, state, val_steps)
        rec["dens_residual_ratio"] = round(ratio, 3)
        rec["dens_ok"] = bool(ratio <= 1.0)
        rec["dens_residual_trajectory"] = \
            "continuous forcing x0.05 (the decay density is extinct)"
        print(f"perf-mode dens residual (forcing twin): "
              f"cheby-{cfg.cheby_dens_iters} {rc:.3e} vs "
              f"jacobi-{cfg.jacobi_iters} {rj:.3e} (worst ratio "
              f"{ratio:.3f})", file=sys.stderr)
    sec = bench_step(perf_cfg, steps=steps, forcing=forcing)
    mcells = perf_cfg.num_cells / sec / 1e6
    disp = bench_step.last_max_displacement
    print(f"perf mode ({label}): {sec * 1e3:.3f} ms/step, "
          f"max|div| {div_perf:.2e} vs jacobi {div_jac:.2e} over "
          f"{val_steps} steps, displacement {disp:.3f} cells",
          file=sys.stderr)
    rec.update({
        "value": round(mcells, 1),
        "unit": "Mcell-updates/s",
        "vs_baseline": round(mcells / BASELINE_MCELLS_PER_S, 2),
        "vs_parity_headline": round(mcells / headline_mcells, 2),
        "max_displacement_cells": round(disp, 3),
    })
    return rec


def bench_3d(args) -> None:
    """BASELINE config 5 as a first-class bench lane (``--ndim 3``): 256³
    smoke volume, audited displacement, plus the 3-D compensated perf-mode line
    with all three bars validated live on a forced twin (the 3-D decay
    trajectory's velocities collapse to sub-mcell scales, so a decay bar
    would compare noise — same reasoning as audit_dens_residual).

    The validated 3-D operating point is (rho=0.85, k_d=10, k_p=12) — NOT
    the 2-D compensated point, which fails the 3-D velocity-residual bar.
    The pressure count is also SIZE-coupled: k_p=12 is the fewest sweeps
    that passed the 256³ bars with margin.  vs_baseline is null: the
    reference is strictly 2-D (its report has no 3-D row to compare
    against)."""
    from fluidsimulationcuda_tpu.models.stable_fluids_3d import (
        make_step_fn_3d, step_audited3,
    )
    from fluidsimulationcuda_tpu.ops import three_d as o3
    from fluidsimulationcuda_tpu.ops.chebyshev import cheby_diffuse3

    n = args.n if args.n != 2046 else 254  # 2-D default -> config 5's 256³
    cfg = SimConfig(n=n, ndim=3, jacobi_iters=args.iters,
                    backend=args.backend)
    state0, sources = reference_init(jax.random.key(0), cfg)
    # --forcing: the reference's random sources (scaled) fire EVERY step —
    # the sustained-displacement regime.
    forcing = float(getattr(args, "forcing", 0.0) or 0.0)
    fdrive = (jax.tree.map(lambda s: jnp.float32(forcing) * s, sources)
              if forcing else None)

    # --- audited displacement (injection displaces < 1 cell at 256³)
    def audit(cfg, steps):
        audited = jax.jit(functools.partial(step_audited3, cfg))
        s, worst = state0, 0.0
        src = fdrive if forcing else sources
        for _ in range(steps):
            s, d = audited(s, src)
            if not forcing:
                src = zero_sources(cfg)
            worst = max(worst, float(d))
        return worst

    steps = args.steps
    disp = audit(cfg, min(steps, 20))
    print(f"audited 3-D displacement {disp:.3f} cells"
          + (f" (forcing x{forcing})" if forcing else ""), file=sys.stderr)

    def timed(cfg):
        step_fn = make_step_fn_3d(cfg)
        state = step_fn(state0, sources)  # injection + warm compile
        zeros = fdrive if forcing else zero_sources(cfg)

        def run(k):
            s = state
            for _ in range(k):
                s = step_fn(s, zeros)
            jax.block_until_ready(s)

        run(1)
        short, long_ = max(2, steps // 5), steps

        def t(k):
            t0 = time.perf_counter()
            run(k)
            return time.perf_counter() - t0

        t(short)
        t_s = min(t(short) for _ in range(2))
        t_l = min(t(long_) for _ in range(2))
        return max((t_l - t_s) / (long_ - short), 1e-9)

    sec = timed(cfg)
    mcells = cfg.num_cells / sec / 1e6
    print(f"{sec * 1e3:.3f} ms/step at {cfg.n + 2}^3, {cfg.jacobi_iters} "
          f"Jacobi iters", file=sys.stderr)
    print(json.dumps({
        "metric": f"3-D full-step throughput @ {cfg.n + 2}^3, "
                  f"{cfg.jacobi_iters} Jacobi iters"
                  + (f", forcing x{forcing}" if forcing else ""),
        "value": round(mcells, 1),
        "unit": "Mcell-updates/s",
        "vs_baseline": None,
        "note": "the reference is strictly 2-D; no 3-D baseline exists",
        "max_displacement_cells": round(disp, 3),
    }))
    if args.no_perf_mode:
        return

    # --- perf-mode line: 3-D compensated, bars live on a forced twin
    rho3, kd3, kp3 = perf_operating_point(cfg.n + 2, ndim=3)
    perf_cfg = dataclasses.replace(
        cfg, diffusion_solver="chebyshev", pressure_solver="chebyshev",
        cheby_rho=rho3, cheby_iters=kd3, cheby_press_iters=kp3)
    drive = (fdrive if forcing
             else jax.tree.map(lambda s: 0.05 * s, sources))
    val_steps = min(8, steps)

    def forced_states(c):
        f = make_step_fn_3d(c)
        s, out = state0, []
        for _ in range(val_steps):
            s = f(s, drive)
            out.append(s)
        return out

    @jax.jit
    def div_inf(s):
        return jnp.max(jnp.abs(o3.divergence3(s.u, s.v, s.w, cfg.n)))

    a_v = cfg.diffusion_alpha_visc
    b_v = 1.0 + 6.0 * a_v
    a_d = cfg.diffusion_alpha_diff
    b_d = 1.0 + 6.0 * a_d

    @jax.jit
    def resid_pair(u, dens, ddens):
        def resid(x, rhs, alpha, beta):
            c = x[1:-1, 1:-1, 1:-1]
            nb = (x[1:-1, 1:-1, :-2] + x[1:-1, 1:-1, 2:]
                  + x[1:-1, :-2, 1:-1] + x[1:-1, 2:, 1:-1]
                  + x[:-2, 1:-1, 1:-1] + x[2:, 1:-1, 1:-1])
            return jnp.max(jnp.abs(jnp.float32(beta) * c
                                   - rhs[1:-1, 1:-1, 1:-1]
                                   - jnp.float32(alpha) * nb))

        zero = jnp.zeros_like(u)
        rj_v = resid(o3.diffuse3(1, zero, u, a_v, b_v, cfg.jacobi_iters),
                     u, a_v, b_v)
        rc_v = resid(cheby_diffuse3(1, zero, u, a_v, b_v,
                                    perf_cfg.cheby_iters,
                                    perf_cfg.cheby_rho), u, a_v, b_v)
        rhs_d = dens + jnp.float32(cfg.dt) * ddens
        rj_d = resid(o3.diffuse3(0, rhs_d, rhs_d, a_d, b_d,
                                 cfg.jacobi_iters), rhs_d, a_d, b_d)
        rc_d = resid(cheby_diffuse3(0, rhs_d, rhs_d, a_d, b_d,
                                    perf_cfg.cheby_iters,
                                    perf_cfg.cheby_rho), rhs_d, a_d, b_d)
        return rc_v, rj_v, rc_d, rj_d

    bar = max(float(div_inf(s)) for s in forced_states(cfg))
    perf_states = forced_states(perf_cfg)
    div_perf = max(float(div_inf(s)) for s in perf_states)
    wv = wd = 0.0
    for s in perf_states:
        rc_v, rj_v, rc_d, rj_d = map(float,
                                     resid_pair(s.u, s.dens, drive.dens))
        if rj_v > 0:
            wv = max(wv, rc_v / rj_v)
        if rj_d > 0:
            wd = max(wd, rc_d / rj_d)
    sec_p = timed(perf_cfg)
    mcells_p = perf_cfg.num_cells / sec_p / 1e6
    print(f"3-D perf mode (compensated rho={rho3} k_d={kd3} k_p={kp3}): "
          f"{sec_p * 1e3:.3f} ms/step; max|div| {div_perf:.2e} vs jacobi "
          f"{bar:.2e}, v_res {wv:.3f}, d_res {wd:.3f} over {val_steps} "
          f"forced steps", file=sys.stderr)
    print(json.dumps({
        "metric": f"3-D perf-mode throughput @ {cfg.n + 2}^3 (compensated: "
                  f"all solves chebyshev-{kd3} @ rho={rho3}, pressure "
                  f"{kp3} sweeps), vs jacobi-{cfg.jacobi_iters} parity",
        "value": round(mcells_p, 1),
        "unit": "Mcell-updates/s",
        "vs_baseline": None,
        "vs_parity_headline": round(mcells_p / mcells, 2),
        "max_abs_divergence": float(f"{div_perf:.3e}"),
        "jacobi_max_abs_divergence": float(f"{bar:.3e}"),
        "divergence_ok": bool(div_perf <= bar),
        "diffusion_residual_ratio": round(wv, 3),
        "diffusion_ok": bool(wv <= 1.0),
        "dens_residual_ratio": round(wd, 3),
        "dens_ok": bool(wd <= 1.0),
        "validation_trajectory": f"continuous forcing "
                                 f"x{forcing if forcing else 0.05}, "
                                 f"{val_steps} steps (3-D decay "
                                 f"velocities collapse to noise scales)",
    }))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2046)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "reference", "hopper"))
    ap.add_argument("--no-perf-mode", action="store_true",
                    help="skip the second (perf-mode) JSON line")
    ap.add_argument("--perf-solver", default="compensated",
                    choices=("compensated", "chebyshev", "chebyshev+dens",
                             "chebyshev-all", "multigrid"),
                    help="solver for the perf-mode line: compensated "
                         "(ALL solves chebyshev-10 at rho=0.9 with the "
                         "pressure solve raised to 14 sweeps to absorb the "
                         "diffusion swap's divergence — validated by "
                         "divergence + velocity-residual + dens-residual "
                         "bars, default), chebyshev+dens (pressure + "
                         "density solves only), chebyshev (pressure-only), "
                         "chebyshev-all (all five at equal sweeps — fails "
                         "the divergence bar, labeled), or multigrid")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--forcing", type=float, nargs="?", const=0.05,
                    default=0.0, metavar="SCALE",
                    help="drive the reference's random sources (scaled) "
                         "EVERY step — continuous inflow with sustained "
                         "displacement")
    ap.add_argument("--ndim", type=int, default=2, choices=(2, 3),
                    help="3 runs BASELINE config 5 (256^3 smoke volume) "
                         "with the 3-D compensated perf-mode line")
    args = ap.parse_args()

    print(f"jax {jax.__version__} backend={jax.default_backend()} "
          f"devices={jax.devices()}", file=sys.stderr)

    if args.ndim == 3:
        if args.steps == 100:
            args.steps = 15
        bench_3d(args)
        return

    if args.sweep:
        # Reference scaling study: 2^10 .. 2^26 cells (Slide10/Slide11 +
        # the reference's own 8192^2 headline size).
        for side_pow in range(5, 14):
            side = 2 ** side_pow
            cfg = SimConfig(n=side - 2, jacobi_iters=args.iters,
                            backend=args.backend)
            # small grids need long runs for the slope to rise above the
            # host's timing noise
            steps = 400 if side <= 512 else (100 if side <= 2048 else 15)
            sec = bench_step(cfg, steps=steps)
            mcells = cfg.num_cells / sec / 1e6
            print(
                f"{side:>6}² ({cfg.num_cells:>10} cells): "
                f"{sec * 1e3:9.3f} ms/step  {mcells:10.1f} Mcell/s",
                file=sys.stderr,
            )
        return

    cfg = SimConfig(n=args.n, jacobi_iters=args.iters, backend=args.backend)
    sec = bench_step(cfg, steps=args.steps, forcing=args.forcing)
    mcells = cfg.num_cells / sec / 1e6
    disp = bench_step.last_max_displacement
    mode = (f"continuous forcing x{args.forcing}" if args.forcing
            else "steady decay")
    print(f"{sec * 1e3:.3f} ms/step at {cfg.n + 2}², {args.iters} Jacobi "
          f"iters, {mode}; injection step untimed (transient "
          f"{bench_step.last_transient:.1f} cells); audited timed-"
          f"trajectory displacement {disp:.3f} cells", file=sys.stderr)
    print(json.dumps({
        "metric": f"full-step throughput @ {cfg.n + 2}^2, {args.iters} Jacobi iters"
                  + (f", forcing x{args.forcing}" if args.forcing else ""),
        "value": round(mcells, 1),
        "unit": "Mcell-updates/s",
        "vs_baseline": round(mcells / BASELINE_MCELLS_PER_S, 2),
        "max_displacement_cells": round(disp, 3),
        "injection_transient_cells": round(bench_step.last_transient, 2),
    }))
    if not (args.no_perf_mode or args.backend == "reference"):
        # Second, clearly-labeled line: the non-parity performance mode
        # (opt-in solver the reference names as future work), validated by
        # divergence residual on the same trajectory.  Under --forcing the
        # bars and the timing both run on the forcing trajectory.
        print(json.dumps(perf_mode_line(cfg, args.steps, mcells,
                                        solver=args.perf_solver,
                                        forcing=args.forcing)))


if __name__ == "__main__":
    main()
