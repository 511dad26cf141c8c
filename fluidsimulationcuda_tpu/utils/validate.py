"""Live solver-quality validation bars (shared by bench.py and the CLI).

The performance modes (Chebyshev-accelerated solves, ``ops/chebyshev.py``)
are honest only if measured: every claim rides on three bars evaluated on
the ACTUAL trajectory at the ACTUAL size — operating points are
size-coupled (k_p=8 passes at 128³ and fails at 256³; rho=0.9 passes 2-D
and fails 3-D), so a point validated at one grid must be re-validated at
another.

Bars (all "perf solve no worse than the parity jacobi solve on the same
states"):

- ``audit_divergence``      — post-projection max|div| (incompressibility)
- ``audit_diffusion_residual`` — velocity diffusion-solve residual ratio
- ``audit_dens_residual``   — density solve residual ratio on a forcing
  twin (the decay density is extinct by steady state)

Plus the displacement audit (``audit_displacement``): the backtrace
displacement in cells that the trajectory's advections see.

The reference has no analogue — its parity story is a one-off eyeball diff
(``document/main.tex:349``); here validation is machinery that runs on
every bench invocation and on ``run --perf --validate``.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.state import reference_init, zero_sources
from ..models.stable_fluids_2d import make_step_fn, step_audited

__all__ = [
    "inject_exact",
    "audit_displacement",
    "audit_divergence",
    "audit_diffusion_residual",
    "audit_diffusion_residual_twin",
    "audit_dens_residual",
    "validate_perf_point",
]


def inject_exact(cfg: SimConfig):
    """Run the source-injection step on the plain path, untimed.

    The reference init's velocity impulse backtraces ~``0.01 * dt * n``
    cells on the very first step — ~21 cells at 2048² — before viscosity
    (``a = dt * visc * n²`` ≈ 167) flattens the field to sub-cell
    displacements by step 3; the timed steady state starts after it.
    Returns (post-injection state, transient displacement in cells)."""
    ref_cfg = dataclasses.replace(cfg, backend="reference")
    state, sources = reference_init(jax.random.key(0), ref_cfg)
    audited = jax.jit(functools.partial(step_audited, ref_cfg))
    state, disp = audited(state, sources)
    return state, float(disp)


def audit_displacement(cfg: SimConfig, state, steps: int,
                       drive=None) -> float:
    """Max backtrace displacement (cells) actually seen by every advection
    call site over ``steps`` steps from ``state`` (``drive``: per-step
    sources; None = zero-source steady decay).  The trajectory is
    deterministic, so replaying it untimed observes exactly what the
    timed loop will do."""
    drive = zero_sources(cfg) if drive is None else drive
    audited = jax.jit(functools.partial(step_audited, cfg))
    disps = []
    for _ in range(steps):
        state, d = audited(state, drive)
        disps.append(d)
    return max(float(d) for d in disps)


def audit_divergence(cfg: SimConfig, state, steps: int, drive=None) -> float:
    """Max post-projection |divergence| of the stored velocity over
    ``steps`` steps from ``state`` — the solver-quality metric that
    validates the performance-mode headline: the perf mode is
    honest only if its incompressibility residual is no worse than the
    parity Jacobi solve's on the same trajectory."""
    from ..ops.project import divergence

    drive = zero_sources(cfg) if drive is None else drive
    step_fn = make_step_fn(cfg)

    @jax.jit
    def div_inf(s):
        return jnp.max(jnp.abs(divergence(s.u, s.v, cfg.n)))

    worst = 0.0
    for _ in range(steps):
        state = step_fn(state, drive)
        worst = max(worst, float(div_inf(state)))
    return worst


def audit_diffusion_residual(cfg: SimConfig, state, steps: int,
                             drive=None) -> tuple:
    """Worst relative sup-norm residual ratio (perf-solve / jacobi-iters
    solve) across the trajectory's velocity-diffusion solves — the honest
    bar for replacing the diffusion solver: <= 1 means the perf solve
    leaves every state at least as converged as the parity solve did."""
    from ..ops.chebyshev import cheby_diffuse
    from ..ops.diffuse import diffuse

    alpha = cfg.diffusion_alpha_visc
    beta = 1.0 + 4.0 * alpha
    step_fn = make_step_fn(dataclasses.replace(cfg))
    drive = zero_sources(cfg) if drive is None else drive

    @jax.jit
    def ratio(u):
        zero = jnp.zeros_like(u)

        def resid(x):
            nb = ((x[1:-1, :-2] + x[1:-1, 2:]) + x[:-2, 1:-1]) + x[2:, 1:-1]
            r = (jnp.float32(beta) * x[1:-1, 1:-1] - u[1:-1, 1:-1]
                 - jnp.float32(alpha) * nb)
            return jnp.max(jnp.abs(r))

        rj = resid(diffuse(1, zero, u, alpha, beta, cfg.jacobi_iters))
        rc = resid(cheby_diffuse(1, zero, u, alpha, beta, cfg.cheby_iters,
                                 cfg.cheby_rho))
        return rc, rj

    worst = 0.0
    worst_pair = (0.0, 0.0)
    for _ in range(steps):
        state = step_fn(state, drive)
        rc, rj = ratio(state.u)
        rc, rj = float(rc), float(rj)
        if rj > 0 and rc / rj > worst:
            worst, worst_pair = rc / rj, (rc, rj)
    return worst, worst_pair


def audit_diffusion_residual_twin(cfg: SimConfig, state, steps: int,
                                  forcing: float = 0.05) -> tuple:
    """``audit_diffusion_residual`` on a continuous-forcing twin of the
    trajectory — the bar for the velocity diffusion swap when the decay
    trajectory's velocities are extinct.  At 2048²/20it the decay
    residuals stay meaningful; at 8192²/40it (alpha ≈ 2.7e3) diffusion
    extinguishes the velocity within steps and the decay residuals
    collapse to ~1e-34 — denormal noise whose ratio is meaningless
    (measured 1.214 of 3e-34 in round 4).  Same reasoning, same twin
    construction as ``audit_dens_residual``."""
    _, sources = reference_init(jax.random.key(0), cfg)
    drive = jax.tree.map(lambda s: jnp.float32(forcing) * s, sources)
    return audit_diffusion_residual(cfg, state, steps, drive=drive)


def audit_dens_residual(cfg: SimConfig, state, steps: int,
                        forcing: float = 0.05) -> tuple:
    """Worst density-solve residual ratio (chebyshev-``cheby_dens_iters``
    / jacobi-``jacobi_iters``) along a continuous-forcing twin of the
    trajectory — the bar for the "chebyshev-dens" diffusion swap.  The
    decay trajectory's density is extinct (~1e-34 sup) by the timed
    steady state, so its ratio compares denormal noise; under forcing the
    density solve does real work."""
    from ..ops.chebyshev import cheby_diffuse
    from ..ops.diffuse import diffuse

    alpha = cfg.diffusion_alpha_diff
    beta = 1.0 + 4.0 * alpha
    _, sources = reference_init(jax.random.key(0), cfg)
    drive = jax.tree.map(lambda s: forcing * s, sources)
    step_fn = make_step_fn(cfg)

    @jax.jit
    def ratio(dens, drive_dens):
        # drive_dens is an ARGUMENT, not a closure capture: a captured
        # array is baked into the program as a 268 MB constant at 8192².
        rhs = dens + jnp.float32(cfg.dt) * drive_dens

        def resid(x):
            nb = ((x[1:-1, :-2] + x[1:-1, 2:]) + x[:-2, 1:-1]) + x[2:, 1:-1]
            r = (jnp.float32(beta) * x[1:-1, 1:-1] - rhs[1:-1, 1:-1]
                 - jnp.float32(alpha) * nb)
            return jnp.max(jnp.abs(r))

        rj = resid(diffuse(0, rhs, rhs, alpha, beta, cfg.jacobi_iters))
        rc = resid(cheby_diffuse(0, rhs, rhs, alpha, beta,
                                 cfg.cheby_dens_iters, cfg.cheby_rho))
        return rc, rj

    worst, worst_pair = 0.0, (0.0, 0.0)
    for _ in range(steps):
        state = step_fn(state, drive)
        rc, rj = ratio(state.dens, drive.dens)
        rc, rj = float(rc), float(rj)
        if rj > 0 and rc / rj > worst:
            worst, worst_pair = rc / rj, (rc, rj)
    return worst, worst_pair


def validate_perf_point(cfg: SimConfig, perf_cfg: SimConfig,
                        steps: int = 20) -> dict:
    """Run the three bars once for ``perf_cfg`` against the parity ``cfg``
    at the REQUESTED size/solver (2-D) — the machinery ``bench.py``'s
    perf-mode line runs on every invocation, packaged so ``run --perf
    --validate`` shares it.  Returns a dict of bar values and booleans;
    ``ok`` is the conjunction of the bars that apply to the perf config's
    solver combination."""
    state, _ = inject_exact(cfg)
    out = {}
    div_jac = audit_divergence(cfg, state, steps)
    div_perf = audit_divergence(perf_cfg, state, steps)
    out["max_abs_divergence"] = div_perf
    out["jacobi_max_abs_divergence"] = div_jac
    out["divergence_ok"] = bool(div_perf <= div_jac)
    ok = out["divergence_ok"]
    if perf_cfg.diffusion_solver == "chebyshev":
        # forcing twin: decay velocities can be extinct (see
        # audit_diffusion_residual_twin) and a denormal-noise ratio
        # would fail the bar meaninglessly
        ratio, _pair = audit_diffusion_residual_twin(perf_cfg, state,
                                                     min(8, steps))
        out["diffusion_residual_ratio"] = ratio
        out["diffusion_ok"] = bool(ratio <= 1.0)
        ok = ok and out["diffusion_ok"]
    if perf_cfg.diffusion_solver in ("chebyshev", "chebyshev-dens"):
        dcfg = perf_cfg
        if perf_cfg.diffusion_solver == "chebyshev":
            dcfg = dataclasses.replace(perf_cfg,
                                       cheby_dens_iters=perf_cfg.cheby_iters)
        dratio, _pair = audit_dens_residual(dcfg, state, min(8, steps))
        out["dens_residual_ratio"] = dratio
        out["dens_ok"] = bool(dratio <= 1.0)
        ok = ok and out["dens_ok"]
    out["ok"] = ok
    return out
