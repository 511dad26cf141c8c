"""Backend dispatch.

The reference maintains five whole *source-tree families* (sequential,
SIMD-SSE, naivePar, smPar, optPar) that all implement the same five ops; here
backends are one enum on ``SimConfig`` and every op is selected per-call:

- ``reference``: plain jnp/XLA ops — runs anywhere; the oracle for the kernel.
- ``hopper``: the Jacobi and Chebyshev sweeps of the diffusion and pressure
  solves run in the fused CUDA kernel (``kernels/hopper_jacobi.py``); every
  other op is the plain XLA one.  Needs an NVIDIA Hopper GPU and float32
  2-D grids, and raises elsewhere.
- ``auto``: ``hopper`` where it qualifies, ``reference`` otherwise.
  :func:`resolve_backend` says which ran and why, and every step builder's
  function carries both (``.backend`` / ``.backend_reason``): the 2-D,
  3-D, batched and sharded steps.  The 3-D and sharded steps never take
  the kernel, so ``hopper`` raises there.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from ..ops.advect import advect as _advect
from ..ops.chebyshev import cheby_diffuse as _cheby_diffuse
from ..ops.diffuse import diffuse as _diffuse_jacobi
from ..ops.project import (
    apply_pressure_gradient as _apg,
    divergence as _divergence,
)

__all__ = ["OpSet", "get_ops", "resolve_backend", "reference_ops", "kernel_ops"]


class OpSet(NamedTuple):
    """The five-op compute surface (reference §2.2) plus the compositions
    the step uses: the u/v pair advection (same velocity, shared
    backtrace), the whole projection, and a diffusion with its source
    added to the rhs."""

    diffuse: Callable
    advect: Callable
    divergence: Callable
    pressure_solve: Callable
    apply_pressure_gradient: Callable
    advect_pair: Callable
    project: Callable
    diffuse_src: Callable


def _platform() -> tuple[str, str]:
    """(platform, compute capability) of the default device."""
    dev = jax.devices()[0]
    return dev.platform, str(getattr(dev, "compute_capability", ""))


def _hopper_unsupported(cfg: SimConfig) -> str | None:
    """Why the Jacobi kernel cannot run this config here, or None."""
    platform, cc = _platform()
    if platform != "gpu":
        return f"the Jacobi kernel needs a CUDA GPU; platform is {platform!r}"
    if not cc.startswith("9."):
        return (f"the Jacobi kernel is built for sm_90a (Hopper); device "
                f"compute capability is {cc or 'unknown'}")
    if cfg.ndim != 2:
        return f"the Jacobi kernel is 2-D; ndim={cfg.ndim}"
    if jnp.dtype(cfg.dtype) != jnp.float32:
        return f"the Jacobi kernel is float32; dtype={jnp.dtype(cfg.dtype)}"
    return None


def resolve_backend(cfg: SimConfig,
                    unsupported: str | None = None) -> tuple[str, str]:
    """``(backend that runs, why)`` for ``cfg.backend``.  An explicit
    ``"hopper"`` that cannot run raises instead of falling back.
    ``unsupported`` is the caller's own reason why its step cannot take
    the kernel at all (the sharded steps)."""
    if cfg.backend == "reference":
        return "reference", "requested"
    reason = unsupported or _hopper_unsupported(cfg)
    if cfg.backend == "hopper":
        if reason is not None:
            raise ValueError(f"backend='hopper' cannot run: {reason}")
        return "hopper", "requested"
    if reason is not None:
        return "reference", f"auto declined the Jacobi kernel: {reason}"
    return "hopper", "auto: Hopper GPU, float32 2-D grid"


def _opset(diffuse: Callable, advect: Callable) -> OpSet:
    def pressure_solve(div, iters, cheby_rho=None):
        # p is zeroed before the solve (FluidSequential.c:153).
        return diffuse(0, jnp.zeros_like(div), div, 1.0, 4.0, iters,
                       cheby_rho=cheby_rho)

    def project(u, v, n, iters, cheby_rho=None):
        p = pressure_solve(_divergence(u, v, n), iters, cheby_rho=cheby_rho)
        return _apg(u, v, p, n)

    def diffuse_src(b, src, base, alpha, beta, iters, dt, cheby_rho=None):
        rhs = base + jnp.asarray(dt, base.dtype) * src
        return diffuse(b, src, rhs, alpha, beta, iters, cheby_rho=cheby_rho)

    def advect_pair(b1, b2, d1, d2, u, v, dt, n):
        return advect(b1, d1, u, v, dt, n), advect(b2, d2, u, v, dt, n)

    return OpSet(
        diffuse=diffuse,
        advect=advect,
        divergence=_divergence,
        pressure_solve=pressure_solve,
        apply_pressure_gradient=_apg,
        advect_pair=advect_pair,
        project=project,
        diffuse_src=diffuse_src,
    )


def reference_ops(cfg: SimConfig) -> OpSet:
    """Every op as plain jnp/XLA."""
    def diffuse(b, x_init, x0, alpha, beta, iters, cheby_rho=None):
        if cheby_rho is not None:
            return _cheby_diffuse(b, x_init, x0, alpha, beta, iters,
                                  cheby_rho)
        return _diffuse_jacobi(b, x_init, x0, alpha, beta, iters)

    return _opset(diffuse, _advect)


def kernel_ops(cfg: SimConfig, launch_fn: Callable | None = None) -> OpSet:
    """Jacobi and Chebyshev solves through the kernel's launch plan
    (``kernels/hopper_jacobi.py``), every other op plain XLA.
    ``launch_fn`` replaces the kernel launch: ``reference_launch`` runs
    the same plan as plain XLA ops on any device."""
    from . import hopper_jacobi as hj

    launch = hj.launch if launch_fn is None else launch_fn

    def diffuse(b, x_init, x0, alpha, beta, iters, cheby_rho=None):
        return hj.jacobi(b, x_init, x0, alpha, beta, iters,
                         cheby_rho=cheby_rho, launch_fn=launch)

    return _opset(diffuse, _advect)


def get_ops(cfg: SimConfig) -> OpSet:
    backend, _ = resolve_backend(cfg)
    return kernel_ops(cfg) if backend == "hopper" else reference_ops(cfg)
