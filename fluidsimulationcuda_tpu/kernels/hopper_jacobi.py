"""Fused multi-sweep Jacobi kernel for NVIDIA Hopper (``csrc/jacobi_hopper.cu``).

The solver's Jacobi sweeps (``FluidSequential.c:85-104``) are most of the
step's memory traffic: as plain XLA ops every sweep reads ``x`` and the
rhs from device memory and writes ``x`` back.  The CUDA kernel runs up to
``MAX_SWEEPS`` sweeps per launch on shared-memory tiles with a halo ring
one cell deeper than the sweep count, applying the mode-``b`` boundary
rule at the grid edge after every sweep — the shared-memory halo tiles of
the reference's ``smPar`` family (``smPar/...BlockPerElement-SM.cu``), with
the reuse a single sweep could not give them.

The library is compiled with ``nvcc`` from the repository's sources into
``build/`` at first use and called through ``jax.ffi``.  CUDA has no
interpret mode: :func:`reference_launch` is the plain specification of one
launch, and everything around the launch (the sweep plan, the Chebyshev
weights and the carry of ``x_{k-1}`` across launches) runs through it on
the CPU.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.boundary import embed_interior
from ..ops.chebyshev import cheby_omegas
from ..ops.diffuse import jacobi_sweep

__all__ = [
    "MAX_SWEEPS", "DEFAULT_SWEEPS", "build", "launch_plan", "sweep_weights",
    "launch", "reference_launch", "jacobi",
]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "csrc", "jacobi_hopper.cu")
_LIB = os.path.join(_ROOT, "build", "libjacobi_hopper.so")

# kMaxSweeps in the CUDA source: the most sweeps one launch may fuse.
MAX_SWEEPS = 16
# Sweeps per launch of the solver's solves: the fastest of 4, 6, 8 and 12
# for the 20-sweep 2048² and 40-sweep 8192² solves on an H100
# (``dev/time_step_backends.py``).
DEFAULT_SWEEPS = 8

_lock = threading.Lock()
_registered = False


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> str:
    """Compile the kernel library if it is missing or older than its
    source; returns its path."""
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return _LIB
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", tmp, _SRC,
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, _LIB)
    return _LIB


def _register() -> None:
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            "fluid_jacobi", jax.ffi.pycapsule(lib.FluidJacobi),
            platform="CUDA")
        jax.ffi.register_ffi_target(
            "fluid_jacobi_cheby", jax.ffi.pycapsule(lib.FluidJacobiCheby),
            platform="CUDA")
        _registered = True


def launch_plan(iters: int, max_sweeps: int = DEFAULT_SWEEPS) -> tuple:
    """Sweeps per launch for an ``iters``-sweep solve: the fewest launches
    of at most ``max_sweeps``, as even as possible (the halo, and with it
    the redundant work, follows the largest launch)."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if not 1 <= max_sweeps <= MAX_SWEEPS:
        raise ValueError(f"max_sweeps must be in [1, {MAX_SWEEPS}]")
    count = -(-iters // max_sweeps)
    size, extra = divmod(iters, count)
    return tuple(size + 1 if k < extra else size for k in range(count))


def sweep_weights(iters: int, cheby_rho: float | None) -> tuple:
    """The weight of every sweep: 1 for plain Jacobi; for Chebyshev 1 on
    the first sweep (``x_1 = S(x_0)``) and then ``w_2 .. w_iters``
    (``ops/chebyshev.py``).  A weight of 1 makes the three-term update
    ``w*S(x) + (1-w)*x_{k-1}`` the plain sweep exactly."""
    if cheby_rho is None:
        return (1.0,) * iters
    return (1.0,) + cheby_omegas(float(cheby_rho), iters)


def launch(b, x, xm, rhs, alpha, beta, weights, *, cheby: bool):
    """One kernel launch: ``len(weights)`` sweeps on (..., side, side)
    float32 grids.  Returns ``(x, x_prev)``; ``x_prev`` (the iterate
    before the last) is returned for Chebyshev launches only, else None."""
    _register()
    shape = jax.ShapeDtypeStruct(x.shape, jnp.float32)
    attrs = dict(alpha=np.float32(alpha), beta=np.float32(beta),
                 b=np.int32(b), weights=np.asarray(weights, np.float32))
    if cheby:
        out, prev = jax.ffi.ffi_call(
            "fluid_jacobi_cheby", (shape, shape),
            vmap_method="broadcast_all")(x, xm, rhs, **attrs)
        return out, prev
    out = jax.ffi.ffi_call("fluid_jacobi", shape,
                           vmap_method="broadcast_all")(x, rhs, **attrs)
    return out, None


def reference_launch(b, x, xm, rhs, alpha, beta, weights, *, cheby: bool):
    """Plain-XLA specification of :func:`launch` on one (side, side) grid:
    the same sweeps, weights and returned iterates."""
    dt = x.dtype
    a = jnp.asarray(alpha, dt)
    bt = jnp.asarray(beta, dt)
    one = jnp.asarray(1.0, dt)
    rhs_int = rhs[1:-1, 1:-1]
    for w in weights:
        s = jacobi_sweep(b, x, rhs_int, a, bt)
        if cheby:
            wc = jnp.asarray(w, dt)
            s = embed_interior(b, (wc * s + (one - wc) * xm)[1:-1, 1:-1])
        xm, x = x, s
    return x, (xm if cheby else None)


def jacobi(b: int, x_init, rhs, alpha: float, beta: float, iters: int, *,
           cheby_rho: float | None = None,
           max_sweeps: int = DEFAULT_SWEEPS,
           launch_fn: Callable = launch):
    """``iters`` Jacobi (or, with ``cheby_rho``, Chebyshev) sweeps from the
    guess ``x_init`` with right-hand side ``rhs`` — the semantics of
    ``ops.diffuse.diffuse`` / ``ops.chebyshev.cheby_diffuse`` — in
    ``launch_plan(iters, max_sweeps)`` launches.  Chebyshev launches carry
    ``x_{k-1}`` from one launch to the next."""
    cheby = cheby_rho is not None
    ws = sweep_weights(iters, cheby_rho)
    x, xm = x_init, (x_init if cheby else None)
    done = 0
    for k in launch_plan(iters, max_sweeps):
        x, xm = launch_fn(b, x, xm, rhs, alpha, beta, ws[done:done + k],
                          cheby=cheby)
        done += k
    return x
