"""Stable Fluids 3-D — smoke volumes (BASELINE config 5).

Same step composition as the 2-D flagship (``FluidSequential.c:176-241``)
lifted to three dimensions: three velocity components, 6-neighbor Jacobi
solves, trilinear advection gather.  Plain jnp/XLA ops (``ops/three_d.py``).
"""
from __future__ import annotations

import functools
from typing import Callable

import jax

from ..core.config import SimConfig
from ..core.state import FluidState, Sources, zero_sources
from ..kernels.dispatch import resolve_backend
from ..ops.source import add_source
from ..ops import three_d as o3

__all__ = ["vel_step3", "dens_step3", "step3", "step_audited3", "make_step_fn_3d", "StableFluids3D"]


class _Ops3:
    """3-D op selection: Jacobi or Chebyshev solves as the config asks,
    the exact trilinear gather."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg

    def diffuse(self, b, x_init, x0, alpha, beta, iters, cheby_rho=None):
        if cheby_rho is not None:
            from ..ops.chebyshev import cheby_diffuse3

            return cheby_diffuse3(b, x_init, x0, alpha, beta, iters,
                                  cheby_rho)
        return o3.diffuse3(b, x_init, x0, alpha, beta, iters)

    def advect(self, b, d0, u, v, w):
        return o3.advect3(b, d0, u, v, w, self.cfg.dt, self.cfg.n)

    def advect_self(self, u, v, w):
        return (self.advect(1, u, u, v, w), self.advect(2, v, u, v, w),
                self.advect(3, w, u, v, w))

    def project(self, u, v, w, iters):
        cfg = self.cfg
        if cfg.pressure_solver == "chebyshev":
            from ..ops.chebyshev import cheby_pressure_solve3

            div = o3.divergence3(u, v, w, cfg.n)
            p = cheby_pressure_solve3(div, cfg.press_cheby_iters,
                                      cfg.cheby_rho)
            return o3.apply_pressure_gradient3(u, v, w, p, cfg.n)
        return o3.project3(u, v, w, cfg.n, iters)


def vel_step3(cfg: SimConfig, u, v, w, u_src, v_src, w_src):
    ops = _Ops3(cfg)
    u = add_source(u, u_src, cfg.dt)
    v = add_source(v, v_src, cfg.dt)
    w = add_source(w, w_src, cfg.dt)
    alpha = cfg.diffusion_alpha_visc
    beta = 1.0 + 6.0 * alpha
    it = cfg.jacobi_iters
    if cfg.diffusion_solver == "chebyshev":
        # 3-D compensated mode: velocity diffusion on Chebyshev sweeps,
        # with the extra mid-frequency divergence absorbed by the raised
        # pressure sweep count (``cheby_press_iters``) — the 3-D twin of
        # the 2-D compensated point.
        d_it, d_rho = cfg.cheby_iters, cfg.cheby_rho
    else:
        d_it, d_rho = it, None
    u = ops.diffuse(1, u_src, u, alpha, beta, d_it, cheby_rho=d_rho)
    v = ops.diffuse(2, v_src, v, alpha, beta, d_it, cheby_rho=d_rho)
    w = ops.diffuse(3, w_src, w, alpha, beta, d_it, cheby_rho=d_rho)
    u, v, w = ops.project(u, v, w, it)
    u, v, w = ops.advect_self(u, v, w)
    return ops.project(u, v, w, it)


def dens_step3(cfg: SimConfig, dens, dens_src, u, v, w):
    ops = _Ops3(cfg)
    dens = add_source(dens, dens_src, cfg.dt)
    alpha = cfg.diffusion_alpha_diff
    beta = 1.0 + 6.0 * alpha
    if cfg.diffusion_solver == "chebyshev-dens":
        # Density-only Chebyshev (see core/config.py): the velocity
        # trajectory stays bit-parity; validated by the dens residual bar.
        dens = ops.diffuse(0, dens_src, dens, alpha, beta,
                           cfg.cheby_dens_iters, cheby_rho=cfg.cheby_rho)
    elif cfg.diffusion_solver == "chebyshev":
        # Full swap (2-D compensated-mode semantics, _diffusion_args):
        # density rides the same cheby_iters/rho as the velocity solves.
        dens = ops.diffuse(0, dens_src, dens, alpha, beta,
                           cfg.cheby_iters, cheby_rho=cfg.cheby_rho)
    else:
        dens = ops.diffuse(0, dens_src, dens, alpha, beta, cfg.jacobi_iters)
    return ops.advect(0, dens, u, v, w)


def step3(cfg: SimConfig, state: FluidState, sources: Sources) -> FluidState:
    u, v, w = vel_step3(
        cfg, state.u, state.v, state.w, sources.u, sources.v, sources.w
    )
    dens = dens_step3(cfg, state.dens, sources.dens, u, v, w)
    return FluidState(dens=dens, u=u, v=v, w=w)


def step_audited3(cfg: SimConfig, state: FluidState, sources: Sources):
    """``step3`` plus the max trilinear backtrace displacement (cells) its
    advection call sites actually see — the 3-D twin of ``step_audited``.
    The sharded step's windowed gather is exact for a step iff this value
    stays below ``cfg.max_courant``."""
    import jax.numpy as jnp

    dt0 = cfg.dt * cfg.n

    def _disp(u, v, w):
        m = jnp.maximum(jnp.abs(u).max(), jnp.abs(v).max())
        return jnp.maximum(m, jnp.abs(w).max()) * dt0

    ops = _Ops3(cfg)
    u = add_source(state.u, sources.u, cfg.dt)
    v = add_source(state.v, sources.v, cfg.dt)
    w = add_source(state.w, sources.w, cfg.dt)
    alpha = cfg.diffusion_alpha_visc
    beta = 1.0 + 6.0 * alpha
    it = cfg.jacobi_iters
    if cfg.diffusion_solver == "chebyshev":  # keep the audit replay on the
        # SAME trajectory as step3() under every diffusion_solver mode
        d_it, d_rho = cfg.cheby_iters, cfg.cheby_rho
    else:
        d_it, d_rho = it, None
    u = ops.diffuse(1, sources.u, u, alpha, beta, d_it, cheby_rho=d_rho)
    v = ops.diffuse(2, sources.v, v, alpha, beta, d_it, cheby_rho=d_rho)
    w = ops.diffuse(3, sources.w, w, alpha, beta, d_it, cheby_rho=d_rho)
    u, v, w = ops.project(u, v, w, it)
    d_vel = _disp(u, v, w)  # what self-advection backtraces with
    u, v, w = ops.advect_self(u, v, w)
    u, v, w = ops.project(u, v, w, it)
    d_dens = _disp(u, v, w)  # what density advection backtraces with
    dens = dens_step3(cfg, state.dens, sources.dens, u, v, w)
    return (FluidState(dens=dens, u=u, v=v, w=w),
            jnp.maximum(d_vel, d_dens))


def make_step_fn_3d(cfg: SimConfig) -> Callable:
    """A jitted 3-D step.  It runs plain XLA ops; like the 2-D
    ``make_step_fn`` it carries ``.backend`` / ``.backend_reason``
    (``auto`` declines the 2-D Jacobi kernel, ``hopper`` raises)."""
    if cfg.ndim != 3:
        raise ValueError("make_step_fn_3d requires ndim == 3")
    backend, reason = resolve_backend(cfg)
    fn = jax.jit(functools.partial(step3, cfg))
    fn.backend, fn.backend_reason = backend, reason
    return fn


class StableFluids3D:
    def __init__(self, cfg: SimConfig):
        if cfg.ndim != 3:
            raise ValueError("StableFluids3D requires ndim == 3")
        self.cfg = cfg
        self._step = make_step_fn_3d(cfg)
        self.backend = self._step.backend
        self.backend_reason = self._step.backend_reason

    def step(self, state: FluidState, sources: Sources | None = None):
        if sources is None:
            sources = zero_sources(self.cfg)
        return self._step(state, sources)
