"""Batched simulation — vmap datagen (BASELINE config 4).

The reference runs exactly one simulation per process (``main`` owns the six
grids, ``FluidSequential.c:273-334``).  Here ``jax.vmap`` over the step
turns the same solver into a data generator: thousands of independent small
sims per device, each with its own randomized sources, in one compiled
program.  The Jacobi kernel takes the batch axis as one more grid
dimension (``kernels/hopper_jacobi.py``), so the vmapped step keeps it.

Sharding: batched state can additionally be distributed over a mesh axis
("batch" data parallelism) via ``jax.sharding``; spatial sharding stays the
domain of ``parallel.sharded`` (the two compose for large-grid datagen).
"""
from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.state import reference_init
from ..kernels.dispatch import resolve_backend
from .stable_fluids_2d import step, step_audited

__all__ = ["batched_init", "make_batched_step_fn", "generate_trajectories"]


def batched_init(key: jax.Array, cfg: SimConfig, batch: int):
    """``batch`` independent reference-style initial conditions, each from
    its own PRNG fold (randomized center-square density + uniform velocity
    sources, mirroring ``initializeParameters``, ``FluidSequential.c:244-271``)."""
    keys = jax.random.split(key, batch)
    return jax.vmap(lambda k: reference_init(k, cfg))(keys)


def make_batched_step_fn(cfg: SimConfig) -> Callable:
    """Jitted step over a leading batch axis (``vmap`` of ``step``); it
    carries ``.backend`` / ``.backend_reason`` like ``make_step_fn``."""
    fn = jax.jit(jax.vmap(functools.partial(step, cfg)))
    fn.backend, fn.backend_reason = resolve_backend(cfg)
    return fn


def generate_trajectories(
    key: jax.Array,
    cfg: SimConfig,
    batch: int,
    num_steps: int,
    *,
    snapshot_every: int = 0,
):
    """Run ``batch`` sims for ``num_steps`` (sources on step 1 only, like the
    reference harness).  Returns ``(final_state, snapshots, max_disp)``:
    the final batched state; with ``snapshot_every=k`` stacked density
    snapshots every k steps (the datagen payload, shape
    ``(num_snaps, batch, side, side)``), else None; and the max backtrace
    displacement (cells) seen by any advection over the whole run (audit
    carried inside the scan, two reductions per step — effectively free).
    """
    state, sources = batched_init(key, cfg, batch)
    runner = _trajectory_runner(cfg, num_steps, snapshot_every)
    return runner(state, sources)


@functools.lru_cache(maxsize=16)
def _trajectory_runner(cfg: SimConfig, num_steps: int, snapshot_every: int):
    """Compiled trajectory scan, cached per (cfg, steps, cadence) — a fresh
    jit per call would re-trace the whole scan every time (measured ~19s of
    pure tracing overhead per datagen call)."""
    _vs = jax.vmap(functools.partial(step_audited, cfg))

    def vstep(st, src):
        st, d = _vs(st, src)
        return st, jnp.max(d)

    @jax.jit
    def run(state, sources):
        zeros = jax.tree.map(jnp.zeros_like, sources)

        def src_at(k):
            return jax.tree.map(
                lambda s, z: jnp.where(k == 0, s, z), sources, zeros
            )

        # Audit accumulator stays f32: displacements are O(1) cells and a
        # bf16 running max would quantize the exactness evidence.
        dm0 = jnp.zeros((), jnp.float32)

        if not snapshot_every:
            def body(carry, k):
                st, dm = carry
                st, d = vstep(st, src_at(k))
                return (st, jnp.maximum(dm, d)), None

            (final, dmax), _ = jax.lax.scan(
                body, (state, dm0), jnp.arange(num_steps)
            )
            return final, None, dmax

        # Snapshots accumulate into a (num_snaps, ...) carry buffer via
        # dynamic_update_slice — peak memory scales with num_snaps, not
        # num_steps (a per-step stacked scan output would be prohibitive
        # for long runs: 1024 sims x 256^2 x 1000 steps ~ 270 GB).
        num_snaps = num_steps // snapshot_every
        buf0 = jnp.zeros(
            (max(num_snaps, 1),) + state.dens.shape, state.dens.dtype
        )

        def body(carry, k):
            st, buf, dm = carry
            st, d = vstep(st, src_at(k))
            idx = (k + 1) // snapshot_every - 1
            buf = jax.lax.cond(
                ((k + 1) % snapshot_every == 0) & (idx < num_snaps),
                lambda b: jax.lax.dynamic_update_slice(
                    b, st.dens[None], (idx,) + (0,) * st.dens.ndim
                ),
                lambda b: b,
                buf,
            )
            return (st, buf, jnp.maximum(dm, d)), None

        (final, buf, dmax), _ = jax.lax.scan(
            body, (state, buf0, dm0), jnp.arange(num_steps)
        )
        return final, buf[:num_snaps], dmax

    return run
