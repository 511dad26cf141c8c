"""Stable Fluids 2-D — the flagship solver.

One functional, jit-compiled step that collapses the reference's five variant
families into a single XLA program.  Step composition mirrors
``vel_step``/``dens_step`` (``FluidSequential.c:176-241``) exactly, including
the quirks that matter for parity:

- the Jacobi initial guess for the velocity/density diffusions is the raw
  source buffer (the reference's post-SWAP ``*_prev`` contents, ``:201-204``);
- both self-advections read the same *pre-advection* velocity (``:232,237``);
- the velocity step projects twice (``:213-226`` and ``:238-240``).

What is deliberately *not* replicated: host-side launch loops (P9), divergent
``__syncthreads`` barriers, and the duplicate-source first step — sources are
explicit per-step inputs.
"""
from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.state import FluidState, Sources, zero_sources
from ..kernels.dispatch import get_ops, resolve_backend

__all__ = [
    "vel_step", "dens_step", "step", "step_audited", "make_step_fn",
    "simulate", "StableFluids2D",
]


def _make_project(cfg: SimConfig, ops):
    """Pressure-projection closure honoring ``cfg.pressure_solver``."""
    if cfg.pressure_solver == "multigrid":
        from ..ops.multigrid import mg_pressure_solve_fast

        def _project(u, v):
            div = ops.divergence(u, v, cfg.n)
            p = mg_pressure_solve_fast(div, cycles=cfg.mg_cycles)
            return ops.apply_pressure_gradient(u, v, p, cfg.n)
    elif cfg.pressure_solver == "cg":
        from ..ops.cg import cg_pressure_solve

        def _project(u, v):
            div = ops.divergence(u, v, cfg.n)
            p = cg_pressure_solve(div, iters=cfg.cg_iters)
            return ops.apply_pressure_gradient(u, v, p, cfg.n)
    elif cfg.pressure_solver == "chebyshev":
        # Chebyshev-accelerated pressure sweeps through the same solve as
        # parity Jacobi (ops/chebyshev.py; validated by bench.py's
        # perf-mode divergence audit).
        def _project(u, v):
            return ops.project(u, v, cfg.n, cfg.press_cheby_iters,
                               cheby_rho=cfg.cheby_rho)
    else:
        def _project(u, v):
            return ops.project(u, v, cfg.n, cfg.jacobi_iters)
    return _project


def _diffusion_args(cfg: SimConfig, dens: bool = False) -> tuple[int, dict]:
    """(iters, extra-kwargs) for a diffusion solve, honoring
    ``cfg.diffusion_solver``.  ``dens``: this is the density solve —
    "chebyshev-dens" accelerates only that one (the velocity trajectory
    stays bit-identical to parity; see core/config.py)."""
    if cfg.diffusion_solver == "chebyshev":
        return cfg.cheby_iters, {"cheby_rho": cfg.cheby_rho}
    if dens and cfg.diffusion_solver == "chebyshev-dens":
        return cfg.cheby_dens_iters, {"cheby_rho": cfg.cheby_rho}
    return cfg.jacobi_iters, {}


def vel_step(
    cfg: SimConfig, u: jax.Array, v: jax.Array, u_src: jax.Array, v_src: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Velocity update (``FluidSequential.c:189-241``)."""
    ops = get_ops(cfg)
    alpha = cfg.diffusion_alpha_visc
    beta = 1.0 + 4.0 * alpha
    # add_source folded into the diffusion rhs (FluidSequential.c:198-200).
    d_iters, d_kw = _diffusion_args(cfg)
    u = ops.diffuse_src(1, u_src, u, alpha, beta, d_iters, cfg.dt, **d_kw)
    v = ops.diffuse_src(2, v_src, v, alpha, beta, d_iters, cfg.dt, **d_kw)
    _project = _make_project(cfg, ops)

    u, v = _project(u, v)
    u0, v0 = u, v
    u, v = ops.advect_pair(1, 2, u0, v0, u0, v0, cfg.dt, cfg.n)
    return _project(u, v)


def dens_step(
    cfg: SimConfig, dens: jax.Array, dens_src: jax.Array, u: jax.Array, v: jax.Array
) -> jax.Array:
    """Density update (``FluidSequential.c:176-186``)."""
    ops = get_ops(cfg)
    alpha = cfg.diffusion_alpha_diff
    beta = 1.0 + 4.0 * alpha
    d_iters, d_kw = _diffusion_args(cfg, dens=True)
    dens = ops.diffuse_src(0, dens_src, dens, alpha, beta, d_iters, cfg.dt,
                           **d_kw)
    return ops.advect(0, dens, u, v, cfg.dt, cfg.n)


def step(cfg: SimConfig, state: FluidState, sources: Sources) -> FluidState:
    """One full timestep: ``vel_step`` then ``dens_step``
    (``FluidSequential.c:305-306``)."""
    u, v = vel_step(cfg, state.u, state.v, sources.u, sources.v)
    dens = dens_step(cfg, state.dens, sources.dens, u, v)
    return FluidState(dens=dens, u=u, v=v)


def step_audited(
    cfg: SimConfig, state: FluidState, sources: Sources
) -> tuple[FluidState, jax.Array]:
    """``step`` plus the max semi-Lagrangian backtrace displacement (cells)
    seen by this step's advection call sites.

    The velocity self-advection backtraces through the *post-projection*
    intermediate velocities (``FluidSequential.c:232,237``), not the
    between-steps state, so auditing the stored state alone under-reports.
    The sharded step's windowed gather (``ops/advect.py:advect_windowed``)
    is exact for a step iff this value stays strictly below
    ``cfg.max_courant``.
    """
    dt0 = cfg.dt * cfg.n

    def _disp(u, v):
        return jnp.maximum(jnp.abs(u).max(), jnp.abs(v).max()) * dt0

    ops = get_ops(cfg)
    alpha = cfg.diffusion_alpha_visc
    beta = 1.0 + 4.0 * alpha
    d_iters, d_kw = _diffusion_args(cfg)  # keep the audit replay on the
    # SAME trajectory as step() under every diffusion_solver mode
    u = ops.diffuse_src(1, sources.u, state.u, alpha, beta,
                        d_iters, cfg.dt, **d_kw)
    v = ops.diffuse_src(2, sources.v, state.v, alpha, beta,
                        d_iters, cfg.dt, **d_kw)
    _project = _make_project(cfg, ops)
    u, v = _project(u, v)
    d_vel = _disp(u, v)  # what the self-advection actually backtraces with
    u, v = ops.advect_pair(1, 2, u, v, u, v, cfg.dt, cfg.n)
    u, v = _project(u, v)
    d_dens = _disp(u, v)  # what the density advection backtraces with
    dens = dens_step(cfg, state.dens, sources.dens, u, v)
    return FluidState(dens=dens, u=u, v=v), jnp.maximum(d_vel, d_dens)


def make_step_fn(cfg: SimConfig) -> Callable[[FluidState, Sources], FluidState]:
    """A jitted step closed over the (static) config — the analogue of
    uploading ``__constant__`` config once and launching forever
    (``naivePar/...BlockPerElement-Naive.cu:386-389``).

    The function carries ``.backend`` (the backend that runs) and
    ``.backend_reason`` (why: requested, or why ``auto`` declined the
    kernel), from ``kernels.dispatch.resolve_backend``."""
    fn = jax.jit(functools.partial(step, cfg))
    fn.backend, fn.backend_reason = resolve_backend(cfg)
    return fn


def simulate(
    cfg: SimConfig,
    state: FluidState,
    sources: Sources,
    num_steps: int,
    *,
    sources_every_step: bool = False,
) -> FluidState:
    """Run ``num_steps`` inside a single compiled ``lax.scan``.

    By default sources fire on step 1 only, matching the reference harness
    (``FluidSequential.c:289-303``: init on the first iteration, prev buffers
    zeroed afterwards).  ``sources_every_step=True`` turns them into a
    continuous inflow — the generalization the reference couldn't express.
    """
    zeros = zero_sources(cfg)

    def body(carry, k):
        if sources_every_step:
            src = sources
        else:
            src = jax.tree.map(
                lambda s, z: jnp.where(k == 0, s, z),
                sources,
                zeros,
            )
        return step(cfg, carry, src), None

    def scan_fn(state):
        out, _ = jax.lax.scan(body, state, jnp.arange(num_steps))
        return out

    return jax.jit(scan_fn)(state)


class StableFluids2D:
    """Object-style wrapper with a cached jitted step."""

    def __init__(self, cfg: SimConfig):
        if cfg.ndim != 2:
            raise ValueError("StableFluids2D requires ndim == 2")
        self.cfg = cfg
        self._step = make_step_fn(cfg)
        self.backend = self._step.backend
        self.backend_reason = self._step.backend_reason

    def step(self, state: FluidState, sources: Sources | None = None) -> FluidState:
        if sources is None:
            sources = zero_sources(self.cfg)
        return self._step(state, sources)

    def simulate(self, state, sources, num_steps, **kw) -> FluidState:
        return simulate(self.cfg, state, sources, num_steps, **kw)
