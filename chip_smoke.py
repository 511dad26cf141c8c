"""Smoke test of the stable-fluids solver on an NVIDIA GPU.

    python chip_smoke.py          # one card: every user-facing path
    python chip_smoke.py --four   # four cards: the sharded steps only

Drives the main path through the entry points a user calls
(``StableFluids2D``, ``make_step_fn``, the CLI ``run``, the 3-D model,
batched datagen), with the fused Jacobi kernel compiled for the card, and
compares each with the plain XLA opset (``backend="reference"``) on the
same inputs, and the 2048² step with the NumPy oracle.  The kernel's
solves are also compared alone at 8192² on O(1) random fields, since the
reference's constants make that grid hyper-diffusive (after three steps
its density peaks near 5e-10 and its velocity near 8e-6).  Prints one
JSON line per phase, then the card's ``name, power.limit`` as
``nvidia-smi`` gives them, then the verdict line.  Exits non-zero, with
no verdict line, when JAX finds no GPU or any phase fails.

Tolerances (float32 everywhere; no matmul on these paths, so TF32 does not
enter): the kernel sums every stencil in the reference's order, but the
card and XLA may contract multiply-adds differently, ~1 ulp per
operation.  Jacobi sweeps are contractions and do not grow that, but the
semi-Lagrangian gather turns a velocity difference into a displacement
difference ``dt*n`` times larger (33 cells per unit velocity at 2048², 131
at 8192²), which the field's gradient then scales: on an H100 the kernel
step differed from the plain XLA step and from the NumPy oracle by up to
6.1e-5 of ``max|want|`` after one 2048² step.  So each field is held to
``max|got - want| <= rtol * max|want|`` with ``rtol = 3e-4``: several
times that float32 spread, and three orders below a wrong boundary rule,
a stale halo or a zeroed output, which move a field by O(max|want|).  The
bound is relative with no absolute floor, so it holds at any field scale;
a reference field that is all zeros fails the check, because it would
compare nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

RTOL = 3e-4
ROOT = os.path.dirname(os.path.abspath(__file__))


def nvidia_smi() -> str:
    """``name, power.limit`` of the cards, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def check(name, got, want) -> dict:
    """Worst difference of one field against its reference, and its bound
    ``RTOL * max|want|``; raises where the bound fails."""
    import numpy as np

    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shape {g.shape} != {w.shape}")
    if not np.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite values")
    scale = float(np.abs(w).max())
    if not scale > 0:
        raise AssertionError(f"{name}: reference field is all zeros")
    err = float(np.abs(g - w).max())
    bound = RTOL * scale
    if not err <= bound:
        raise AssertionError(f"{name}: max|diff| {err:.3e} > {bound:.3e}")
    return {"max_abs_diff": err, "max_abs_want": scale, "bound": bound}


def compare(got, want) -> dict:
    """:func:`check` for every field of two states."""
    return {name: check(name, getattr(got, name), getattr(want, name))
            for name in ("dens", "u", "v", "w")
            if getattr(got, name) is not None}


def run_steps(step, state, sources, zeros, steps):
    import jax

    for k in range(steps):
        state = step(state, sources if k == 0 else zeros)
    return jax.block_until_ready(state)


def phase_device():
    import jax
    import numpy as np

    dev = jax.devices()[0]
    return {"jax": jax.__version__, "numpy": np.__version__,
            "python": sys.version.split()[0], "devices": len(jax.devices()),
            "compute_capability": getattr(dev, "compute_capability", None)}


def phase_step_8192():
    """The reference's headline grid, N = 2^13 - 2, 40 Jacobi iterations."""
    import jax

    from fluidsimulationcuda_tpu import (
        SimConfig, StableFluids2D, reference_init, zero_sources,
    )

    cfg = SimConfig(n=8190, jacobi_iters=40)
    sim = StableFluids2D(cfg)
    if sim.backend != "hopper":
        raise AssertionError(f"auto did not select the kernel: "
                             f"{sim.backend_reason}")
    state, sources = reference_init(jax.random.key(0), cfg)
    zeros = zero_sources(cfg)
    mem = sim._step.lower(state, sources).compile().memory_analysis()
    got = run_steps(sim.step, state, sources, zeros, 3)
    # Peak of this process so far: the kernel's steps, their inputs and
    # outputs, before the reference allocates its own.
    peak = int(jax.devices()[0].memory_stats()["peak_bytes_in_use"])
    ref = StableFluids2D(cfg.replace(backend="reference"))
    want = run_steps(ref.step, state, sources, zeros, 3)
    rec = {"backend": sim.backend, "steps": 3,
           "vs_reference": compare(got, want), "peak_bytes_in_use": peak}
    rec["memory_analysis"] = {
        k: int(getattr(mem, k)) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")}
    return rec


def phase_solves_8192():
    """The kernel's solves alone at 8192² against the plain XLA solves, on
    an O(1) random field: Jacobi with the step's density, velocity and
    pressure coefficients for each boundary mode, and Chebyshev at the
    8192² perf-mode point."""
    import jax
    import jax.numpy as jnp

    from fluidsimulationcuda_tpu import SimConfig
    from fluidsimulationcuda_tpu.core.config import perf_operating_point
    from fluidsimulationcuda_tpu.kernels.dispatch import (
        kernel_ops, reference_ops,
    )

    cfg = SimConfig(n=8190, jacobi_iters=40, backend="hopper")
    kernel, plain = kernel_ops(cfg), reference_ops(cfg)
    a_d, a_v = cfg.diffusion_alpha_diff, cfg.diffusion_alpha_visc
    rho, k_d, k_p = perf_operating_point(cfg.n + 2)
    it = cfg.jacobi_iters
    cases = {
        "dens_jacobi_b0": (0, a_d, 1 + 4 * a_d, it, None),
        "u_jacobi_b1": (1, a_v, 1 + 4 * a_v, it, None),
        "v_jacobi_b2": (2, a_v, 1 + 4 * a_v, it, None),
        "pressure_jacobi_b0": (0, 1.0, 4.0, it, None),
        "pressure_cheby_b0": (0, 1.0, 4.0, k_p, rho),
        "u_cheby_b1": (1, a_v, 1 + 4 * a_v, k_d, rho),
    }
    x = jax.random.uniform(jax.random.key(6), cfg.grid_shape, jnp.float32,
                           -1.0, 1.0)
    rec = {}
    for name, (b, alpha, beta, iters, r) in cases.items():
        def solve(ops):
            return jax.jit(lambda x0: ops.diffuse(b, x0, x0, alpha, beta,
                                                  iters, cheby_rho=r))(x)
        rec[name] = check(name, solve(kernel), solve(plain))
    return rec


def phase_step_2048():
    """bench.py's grid, 20 iterations: kernel vs plain XLA and vs the
    NumPy oracle; then one perf-mode step at the validated point."""
    import jax
    import numpy as np

    from fluidsimulationcuda_tpu import (
        FluidState, SimConfig, make_step_fn, reference_init,
    )
    from fluidsimulationcuda_tpu.core.config import perf_operating_point
    from fluidsimulationcuda_tpu.oracle import numpy_ref as oracle

    cfg = SimConfig(n=2046, jacobi_iters=20)
    step = make_step_fn(cfg)
    if step.backend != "hopper":
        raise AssertionError(f"auto did not select the kernel: "
                             f"{step.backend_reason}")
    state, sources = reference_init(jax.random.key(1), cfg)
    got = jax.block_until_ready(step(state, sources))
    want = make_step_fn(cfg.replace(backend="reference"))(state, sources)
    dens, u, v = oracle.step(
        *(np.asarray(a) for a in (state.dens, state.u, state.v,
                                  sources.dens, sources.u, sources.v)),
        dt=cfg.dt, visc=cfg.visc, diff=cfg.diff, n=cfg.n,
        iters=cfg.jacobi_iters)
    rec = {"backend": step.backend,
           "vs_reference": compare(got, want),
           "vs_numpy_oracle": compare(got, FluidState(dens=dens, u=u, v=v))}
    rho, k_d, k_p = perf_operating_point(cfg.n + 2)
    perf = cfg.replace(pressure_solver="chebyshev",
                       diffusion_solver="chebyshev", cheby_rho=rho,
                       cheby_iters=k_d, cheby_press_iters=k_p)
    got = jax.block_until_ready(make_step_fn(perf)(state, sources))
    want = make_step_fn(perf.replace(backend="reference"))(state, sources)
    rec["perf_mode"] = {"cheby_rho": rho, "k_d": k_d, "k_p": k_p,
                        "vs_reference": compare(got, want)}
    return rec


def phase_cli():
    """``python -m fluidsimulationcuda_tpu run --n 2046 --steps 5
    --scenario plume --save ...``, in this process; the saved state is
    compared with the plain opset's five steps of the same scenario.  The
    plume feeds its sources every step, so the fields stay O(0.1); the
    reference scenario's impulse has decayed below 1e-4 by step 5."""
    import jax

    from fluidsimulationcuda_tpu import __main__ as cli
    from fluidsimulationcuda_tpu import make_step_fn
    from fluidsimulationcuda_tpu.models.scenarios import SCENARIOS
    from fluidsimulationcuda_tpu.utils.checkpoint import load_checkpoint

    path = os.path.join(ROOT, ".cache", "chip_smoke", "cli_run.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    steps = 5
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            cli.main(["run", "--n", "2046", "--steps", str(steps),
                      "--scenario", "plume", "--save", path])
        got, cfg, _ = load_checkpoint(path)
    finally:
        if os.path.exists(path):
            os.remove(path)
    lines = err.getvalue().splitlines()
    backend = [ln for ln in lines if ln.startswith("backend: ")]
    if not backend or not backend[0].startswith("backend: hopper"):
        raise AssertionError(f"CLI did not run the kernel: {backend}")
    summary = [ln for ln in lines if " steps in " in ln]
    if not summary or "; stable," not in summary[0]:
        raise AssertionError(f"CLI run did not finish stable: {lines[-3:]}")
    ref = make_step_fn(cfg.replace(backend="reference"))
    want, sources, _ = SCENARIOS["plume"](jax.random.key(0), cfg)
    for _ in range(steps):
        want = ref(want, sources)
    return {"backend_line": backend[0], "summary": summary[0],
            "vs_reference": compare(got, want)}


def phase_3d():
    """256³ smoke volume (plain XLA ops), 2 steps."""
    import jax
    import numpy as np

    from fluidsimulationcuda_tpu import SimConfig, reference_init, zero_sources
    from fluidsimulationcuda_tpu.models.stable_fluids_3d import StableFluids3D

    cfg = SimConfig(n=254, ndim=3, jacobi_iters=20)
    state, sources = reference_init(jax.random.key(2), cfg)
    sim = StableFluids3D(cfg)
    out = run_steps(sim.step, state, sources, zero_sources(cfg), 2)
    for name in ("dens", "u", "v", "w"):
        a = np.asarray(getattr(out, name))
        if a.shape != cfg.grid_shape or not np.isfinite(a).all():
            raise AssertionError(f"3-D {name}: bad shape or non-finite")
    return {"shape": list(cfg.grid_shape), "backend": sim.backend,
            "backend_reason": sim.backend_reason,
            "dens_sum": float(np.asarray(out.dens, np.float64).sum())}


def phase_batched():
    """Batched datagen, 1024 sims of 256², 2 steps: the kernel under vmap
    vs the vmapped plain step."""
    import jax

    from fluidsimulationcuda_tpu import SimConfig
    from fluidsimulationcuda_tpu.models.batched import (
        batched_init, make_batched_step_fn,
    )

    cfg = SimConfig(n=254, jacobi_iters=20)
    states, sources = batched_init(jax.random.key(3), cfg, 1024)
    zeros = jax.tree.map(jax.numpy.zeros_like, sources)
    got = run_steps(make_batched_step_fn(cfg), states, sources, zeros, 2)
    want = run_steps(make_batched_step_fn(cfg.replace(backend="reference")),
                     states, sources, zeros, 2)
    return {"batch": 1024, "side": cfg.n + 2, "steps": 2,
            "vs_reference": compare(got, want)}


def phase_sharded_2d():
    """The 2-D sharded step at 8192²/40 on (4, 1) and (2, 2) meshes vs the
    single-device step on the same inputs (exact advection: the
    reference's semantics at any displacement)."""
    import jax

    from fluidsimulationcuda_tpu import (
        SimConfig, make_step_fn, reference_init, zero_sources,
    )
    from fluidsimulationcuda_tpu.parallel.mesh import make_mesh
    from fluidsimulationcuda_tpu.parallel.sharded import (
        make_sharded_step_fn, shard_state,
    )

    cfg = SimConfig(n=8190, jacobi_iters=40, backend="reference")
    state, sources = reference_init(jax.random.key(4), cfg)
    zeros = zero_sources(cfg)
    want = run_steps(make_step_fn(cfg), state, sources, zeros, 2)
    rec = {}
    for shape in ((4, 1), (2, 2)):
        mesh = make_mesh(jax.devices()[:4], shape)
        step = make_sharded_step_fn(cfg, mesh, advect_mode="exact")
        got = run_steps(step, shard_state(state, mesh),
                        shard_state(sources, mesh), shard_state(zeros, mesh),
                        2)
        rec[f"mesh_{shape[0]}x{shape[1]}"] = {
            "devices": len(got.dens.sharding.device_set),
            "vs_single_device": compare(got, want)}
    return rec


def phase_sharded_3d():
    """The 3-D z-slab step at 256³ on four cards vs the single-device
    step."""
    import jax

    from fluidsimulationcuda_tpu import SimConfig, reference_init, zero_sources
    from fluidsimulationcuda_tpu.models.stable_fluids_3d import make_step_fn_3d
    from fluidsimulationcuda_tpu.parallel.mesh import make_mesh
    from fluidsimulationcuda_tpu.parallel.sharded3d import (
        make_sharded_step_fn_3d, shard_state_3d,
    )

    cfg = SimConfig(n=254, ndim=3, jacobi_iters=20)
    state, sources = reference_init(jax.random.key(5), cfg)
    zeros = zero_sources(cfg)
    want = run_steps(make_step_fn_3d(cfg), state, sources, zeros, 2)
    mesh = make_mesh(jax.devices()[:4])
    step = make_sharded_step_fn_3d(cfg, mesh, advect_mode="exact")
    got = run_steps(step, shard_state_3d(state, mesh),
                    shard_state_3d(sources, mesh),
                    shard_state_3d(zeros, mesh), 2)
    return {"devices": len(got.dens.sharding.device_set),
            "vs_single_device": compare(got, want)}


ONE_CARD = (("device", phase_device), ("step_8192_40", phase_step_8192),
            ("solves_8192", phase_solves_8192),
            ("step_2048_20", phase_step_2048), ("cli_run_2046", phase_cli),
            ("step_3d_256", phase_3d), ("batched_1024x256", phase_batched))
FOUR_CARDS = (("device", phase_device), ("sharded_2d_8192_40",
                                          phase_sharded_2d),
              ("sharded_3d_256", phase_sharded_3d))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded steps, on four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX sees {len(devices)}",
              file=sys.stderr)
        return 2

    from fluidsimulationcuda_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    card = nvidia_smi()
    kind = devices[0].device_kind
    ok = True
    for name, phase in (FOUR_CARDS if args.four else ONE_CARD):
        t0 = time.perf_counter()
        rec = {"phase": name, "device_kind": kind, "nvidia_smi": card}
        try:
            rec.update(phase())
            rec["ok"] = True
        except Exception as e:  # report every phase, then fail the run
            rec.update(ok=False, error=f"{type(e).__name__}: {e}"[:2000])
            ok = False
        rec["seconds"] = round(time.perf_counter() - t0, 3)
        print(json.dumps(rec), flush=True)
    if not ok:
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
