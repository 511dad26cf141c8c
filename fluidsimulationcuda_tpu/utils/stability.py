"""Stability diagnostics — the check the reference never implemented.

``FluidSequential.c:309`` calls ``//checkStability(u, v);`` — commented
out, and the function exists nowhere in the reference.  This module is
that missing subsystem: one jitted reduction pass returning a small
pytree of scalars (cheap to compute, cheap to read back).

Semi-Lagrangian advection with the solver's clamped gather is
unconditionally stable in the never-blows-up sense, so "stability" here
means *trustworthiness* of a trajectory:

- ``finite``: no NaN/Inf anywhere (the only hard-failure mode left);
- ``max_displacement``: the CFL-like number ``dt·N·max(|u|,|v|)`` in
  cells — the same quantity the audited step measures per call site
  (``models.stable_fluids_2d.step_audited``), computed here from the
  stored state;
- ``max_speed`` / ``max_density``: magnitude watermarks for drift
  monitoring across a long run.

Use ``check_stability`` for a one-shot verdict or inside a host loop;
it is jit-compatible (returns arrays, no Python branching).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.state import FluidState

__all__ = ["StabilityReport", "check_stability", "is_stable"]


class StabilityReport(NamedTuple):
    """Scalar diagnostics of a :class:`FluidState` (all 0-d arrays)."""

    finite: jax.Array            # bool: every field free of NaN/Inf
    max_displacement: jax.Array  # cells: dt * N * max component speed
    max_speed: jax.Array         # max(|u|, |v|[, |w|])
    max_density: jax.Array       # max|dens|


def check_stability(cfg: SimConfig, state: FluidState) -> StabilityReport:
    """One reduction pass of stability diagnostics (jit-compatible).

    The displacement bound uses the per-component max, matching the
    solver's axis-separable gather window (a backtrace moves at most
    ``dt·N·|u|`` lanes and ``dt·N·|v|`` sublanes — the window condition
    is per-axis, ``ops/advect.py:advect_windowed``).
    """
    fields = [state.dens, state.u, state.v]
    if state.w is not None:
        fields.append(state.w)
    finite = jnp.array(True)
    for f in fields:
        finite = jnp.logical_and(finite, jnp.all(jnp.isfinite(f)))
    vels = fields[1:]
    max_speed = jnp.maximum(jnp.max(jnp.abs(vels[0])),
                            jnp.max(jnp.abs(vels[1])))
    if len(vels) == 3:
        max_speed = jnp.maximum(max_speed, jnp.max(jnp.abs(vels[2])))
    disp = jnp.asarray(cfg.dt * cfg.n, state.dens.dtype) * max_speed
    return StabilityReport(
        finite=finite,
        max_displacement=disp,
        max_speed=max_speed,
        max_density=jnp.max(jnp.abs(state.dens)),
    )


def is_stable(cfg: SimConfig, state: FluidState) -> bool:
    """Host-side verdict: finite everywhere AND the *stored state's*
    displacement bound fits the configured gather window.

    This is a heuristic screen, not an exactness proof: the step's
    advections backtrace with post-diffusion/post-projection intermediate
    velocities, which the projection can push past the stored-state bound
    (exactly why ``step_audited`` measures at the call sites).  A state
    passing here with displacement near ``max_courant`` can still clamp
    inside the next step — use ``step_audited``'s returned displacement
    for the authoritative per-step verdict.  Forces a device read-back —
    host loops only."""
    rep = check_stability(cfg, state)
    return bool(rep.finite) and float(rep.max_displacement) < cfg.max_courant
