"""Time the 2-D step, and one solve alone, with the Jacobi kernel against
the plain XLA opset.

    python dev/time_step_backends.py                    # 2048²/20 and 8192²/40
    python dev/time_step_backends.py --sizes 4096:20 --steps 20
    python dev/time_step_backends.py --sweeps 4,6,8,12  # also sweeps/launch

For each size, both steps are compiled and warmed up first, then timed in
windows of ``--steps`` steps in the order plain, kernel, kernel, plain, on
the host clock up to ``jax.block_until_ready``.  Then one density-diffusion
solve (``jacobi_iters`` sweeps, Jacobi and Chebyshev) is timed the same
way in windows of ``--reps`` calls on an O(1) random field, and, with
``--sweeps``, the kernel's Jacobi solve at each number of sweeps per
launch.  Prints one JSON line per size with every window's ms, the card
as ``nvidia-smi`` names it and its power limit.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


ORDER = ("plain", "kernel", "kernel", "plain")


def _windows(run):
    """``[name, ms]`` for each window of ``ORDER``; ``run(name)`` times one
    window and returns its ms per call."""
    return [[name, run(name)] for name in ORDER]


def _mean(windows, name):
    ts = [t for n, t in windows if n == name]
    return sum(ts) / len(ts)


def time_steps(cfg, steps):
    import jax

    from fluidsimulationcuda_tpu import make_step_fn, reference_init, zero_sources

    fns = {"plain": make_step_fn(cfg.replace(backend="reference")),
           "kernel": make_step_fn(cfg.replace(backend="hopper"))}
    state, sources = reference_init(jax.random.key(0), cfg)
    zeros = zero_sources(cfg)
    start, first_call_s = {}, {}
    for name, fn in fns.items():
        t0 = time.perf_counter()
        s = jax.block_until_ready(fn(state, sources))
        first_call_s[name] = time.perf_counter() - t0
        start[name] = jax.block_until_ready(fn(s, zeros))

    def run(name):
        fn, s = fns[name], start[name]
        t0 = time.perf_counter()
        for _ in range(steps):
            s = fn(s, zeros)
        jax.block_until_ready(s)
        return (time.perf_counter() - t0) / steps * 1e3

    windows = _windows(run)
    return {"windows_ms": windows, "plain_ms": _mean(windows, "plain"),
            "kernel_ms": _mean(windows, "kernel"),
            "speedup": _mean(windows, "plain") / _mean(windows, "kernel"),
            "first_call_s": first_call_s}


def time_solves(cfg, reps, sweeps):
    import jax
    import jax.numpy as jnp

    from fluidsimulationcuda_tpu.kernels import hopper_jacobi as hj
    from fluidsimulationcuda_tpu.ops.chebyshev import cheby_diffuse
    from fluidsimulationcuda_tpu.ops.diffuse import diffuse

    a = cfg.diffusion_alpha_diff
    bt = 1.0 + 4.0 * a
    it = cfg.jacobi_iters
    rho = 0.99
    x = jax.random.uniform(jax.random.key(1), cfg.grid_shape, jnp.float32,
                           -1.0, 1.0)

    def timed(fn):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(x)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps * 1e3

    solves = {
        "jacobi": {
            "plain": jax.jit(lambda x: diffuse(0, x, x, a, bt, it)),
            "kernel": jax.jit(lambda x: hj.jacobi(0, x, x, a, bt, it))},
        "chebyshev": {
            "plain": jax.jit(lambda x: cheby_diffuse(0, x, x, a, bt, it,
                                                     rho)),
            "kernel": jax.jit(lambda x: hj.jacobi(0, x, x, a, bt, it,
                                                  cheby_rho=rho))},
    }
    rec = {}
    for kind, fns in solves.items():
        for fn in fns.values():
            jax.block_until_ready(fn(x))
        windows = _windows(lambda name: timed(fns[name]))
        rec[kind] = {"windows_ms": windows,
                     "plain_ms": _mean(windows, "plain"),
                     "kernel_ms": _mean(windows, "kernel")}
    per_launch = {}
    for k in sweeps:
        fn = jax.jit(lambda x, k=k: hj.jacobi(0, x, x, a, bt, it,
                                              max_sweeps=k))
        jax.block_until_ready(fn(x))
        per_launch[str(k)] = [timed(fn), timed(fn)]
    if per_launch:
        rec["jacobi_kernel_ms_by_sweeps_per_launch"] = per_launch
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="2048:20,8192:40",
                    help="comma-separated side:jacobi_iters pairs")
    ap.add_argument("--steps", type=int, default=20,
                    help="steps per timed step window")
    ap.add_argument("--reps", type=int, default=10,
                    help="solves per timed solve window")
    ap.add_argument("--sweeps", default="",
                    help="comma-separated sweeps per launch to time the "
                         "kernel's Jacobi solve at (default: none)")
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        print("needs a GPU", file=sys.stderr)
        return 2
    from fluidsimulationcuda_tpu import SimConfig
    from fluidsimulationcuda_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    sweeps = [int(k) for k in args.sweeps.split(",") if k]
    for item in args.sizes.split(","):
        side, iters = (int(v) for v in item.split(":"))
        cfg = SimConfig(n=side - 2, jacobi_iters=iters)
        print(json.dumps({
            "side": side, "jacobi_iters": iters,
            "steps_per_window": args.steps, "solves_per_window": args.reps,
            "step": time_steps(cfg, args.steps),
            "solve": time_solves(cfg, args.reps, sweeps),
            "device_kind": jax.devices()[0].device_kind, "nvidia_smi": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
