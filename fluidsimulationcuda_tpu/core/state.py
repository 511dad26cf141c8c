"""Simulation state pytrees.

The reference's L0 layer is six raw ``float*`` grids —
``dens, dens_prev, u, u_prev, v, v_prev`` (``FluidSequential.c:277-282``) —
where the ``*_prev`` buffers double as (a) per-step external sources and
(b) scratch for pointer-swap double buffering.  Here the scratch role
disappears (XLA manages buffers; ops are functional), so the state splits
cleanly into *fields* (carried across steps) and *sources* (per-step inputs).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import SimConfig

__all__ = ["FluidState", "Sources", "zero_state", "zero_sources", "reference_init"]


class FluidState(NamedTuple):
    """Fields carried across timesteps.  Each has shape ``cfg.grid_shape``.

    2-D: ``u`` is the x (column) velocity, ``v`` the y (row) velocity, and
    arrays are indexed ``[i, j] = [row, col]`` exactly like the reference's
    ``x[j + i*(N+2)]`` flat layout (``FluidSequential.c:24``).
    3-D adds ``w`` (depth velocity); ``w`` is None for 2-D.
    """

    dens: jax.Array
    u: jax.Array
    v: jax.Array
    w: jax.Array | None = None


class Sources(NamedTuple):
    """Per-step external sources, integrated as ``x += dt * src``
    (``FluidSequential.c:78-82``).  Shapes match the state fields."""

    dens: jax.Array
    u: jax.Array
    v: jax.Array
    w: jax.Array | None = None


def zero_state(cfg: SimConfig) -> FluidState:
    z = jnp.zeros(cfg.grid_shape, cfg.dtype)
    w = jnp.zeros(cfg.grid_shape, cfg.dtype) if cfg.ndim == 3 else None
    return FluidState(dens=z, u=z, v=z, w=w)


def zero_sources(cfg: SimConfig) -> Sources:
    z = jnp.zeros(cfg.grid_shape, cfg.dtype)
    w = jnp.zeros(cfg.grid_shape, cfg.dtype) if cfg.ndim == 3 else None
    return Sources(dens=z, u=z, v=z, w=w)


def reference_init(key: jax.Array, cfg: SimConfig) -> tuple[FluidState, Sources]:
    """Initial condition mirroring ``initializeParameters``
    (``FluidSequential.c:244-271``): density source uniform in [0, 0.099]
    inside a centered square of half-width ``(n+2)//8``, zero elsewhere;
    velocity sources uniform in [0, 0.99] everywhere; all carried fields
    zero.  Sources are meant to be injected on step 1 only
    (``FluidSequential.c:297-303`` re-zeroes the prev buffers afterwards).

    Uses JAX PRNG rather than C ``rand()`` — parity testing is against our
    own oracle fed the same arrays, not against the C binary's RNG stream.
    """
    side = cfg.n + 2
    kd, ku, kv, kw = jax.random.split(key, 4)
    dens_src = jax.random.uniform(kd, cfg.grid_shape, cfg.dtype, 0.0, 0.099)

    center = side // 2
    radius = side // 8
    idx = [jnp.arange(side)] * cfg.ndim
    mask = jnp.ones(cfg.grid_shape, bool)
    for d, ax in enumerate(idx):
        in_band = (ax >= center - radius) & (ax < center + radius)
        shape = [1] * cfg.ndim
        shape[d] = side
        mask &= in_band.reshape(shape)
    dens_src = jnp.where(mask, dens_src, 0.0).astype(cfg.dtype)

    u_src = jax.random.uniform(ku, cfg.grid_shape, cfg.dtype, 0.0, 0.99)
    v_src = jax.random.uniform(kv, cfg.grid_shape, cfg.dtype, 0.0, 0.99)
    w_src = (
        jax.random.uniform(kw, cfg.grid_shape, cfg.dtype, 0.0, 0.99)
        if cfg.ndim == 3
        else None
    )
    return zero_state(cfg), Sources(dens=dens_src, u=u_src, v=v_src, w=w_src)
