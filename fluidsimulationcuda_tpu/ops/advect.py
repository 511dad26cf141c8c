"""Semi-Lagrangian advection (jnp reference backend).

Backtrace + bilinear gather, matching ``advect`` in
``FluidSequential.c:107-141``: departure point
``(x, y) = (j, i) - dt*n*(u, v)``, clamped to ``[0.5, n+0.5]``
(``:117-127``), truncated to the lower cell (safe: clamp makes trunc ==
floor), bilinearly interpolated from ``d0`` (``:136-137``).

The gather is expressed as a flat ``jnp.take`` so XLA lowers one fused
gather instead of four; displacement is CFL-bounded by the clamp so every
read stays inside the padded grid.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .boundary import embed_interior

__all__ = ["advect", "advect_windowed", "backtrace"]


def backtrace(u: jnp.ndarray, v: jnp.ndarray, dt: float, n: int):
    """Departure coordinates for every interior cell, clamped.  Returns
    float32 arrays (x, y) of shape (n, n) in grid units (column, row).

    Coordinates are ALWAYS f32 even for bf16 fields: a grid index up to
    ``n`` is not representable in bf16 (8-bit mantissa — spacing 2 above
    256), so bf16 backtrace coordinates would gather from wrong cells."""
    dtype = jnp.promote_types(u.dtype, jnp.float32)
    u = u.astype(dtype)
    v = v.astype(dtype)
    dt0 = jnp.asarray(dt, dtype) * n
    jj = jnp.arange(1, n + 1, dtype=dtype)[None, :]
    ii = jnp.arange(1, n + 1, dtype=dtype)[:, None]
    x = jj - dt0 * u[1:-1, 1:-1]
    y = ii - dt0 * v[1:-1, 1:-1]
    lo = jnp.asarray(0.5, dtype)
    hi = jnp.asarray(n + 0.5, dtype)
    return jnp.clip(x, lo, hi), jnp.clip(y, lo, hi)


def advect(
    b: int,
    d0: jnp.ndarray,
    u: jnp.ndarray,
    v: jnp.ndarray,
    dt: float,
    n: int,
) -> jnp.ndarray:
    dtype = jnp.promote_types(d0.dtype, jnp.float32)  # blend in f32
    x, y = backtrace(u, v, dt, n)
    j0 = x.astype(jnp.int32)
    i0 = y.astype(jnp.int32)
    s1 = x - j0.astype(dtype)
    s0 = jnp.asarray(1.0, dtype) - s1
    t1 = y - i0.astype(dtype)
    t0 = jnp.asarray(1.0, dtype) - t1

    side = n + 2
    flat = d0.reshape(-1)
    base = i0 * side + j0

    g00 = jnp.take(flat, base, unique_indices=False, indices_are_sorted=False)
    g10 = jnp.take(flat, base + side)
    g01 = jnp.take(flat, base + 1)
    g11 = jnp.take(flat, base + side + 1)

    interior = s0 * (t0 * g00 + t1 * g10) + s1 * (t0 * g01 + t1 * g11)
    return embed_interior(b, interior.astype(d0.dtype))


def advect_windowed(
    b: int,
    d0: jnp.ndarray,
    u: jnp.ndarray,
    v: jnp.ndarray,
    dt: float,
    n: int,
    cmax: int,
) -> jnp.ndarray:
    """Window-clamped advection: the masked-shift gather the sharded step
    uses to bound its halo depth (``parallel/sharded.py``) — the backtrace
    is additionally clamped to ±``cmax`` cells around each output cell, and
    the gather is a sum of (2C+1)² masked shifts.

    **Exactness condition (the canonical statement — every other doc refers
    here).**  Let ``d = max |dt*n*velocity|`` over interior cells (the
    audited displacement).  Then ``advect_windowed == advect`` exactly
    whenever ``d <= cmax``; all audits in this repo enforce the strict
    inequality ``d < cmax``.  Proof: for an interior output cell at column
    ``j``, the box clamp to ``[0.5, n+0.5]`` (``FluidSequential.c:117-127``)
    only moves the departure point toward ``j`` (``j ∈ [1, n] ⊂
    [0.5, n+0.5]``), so ``|x - j| <= d``.  If ``d <= cmax`` the window clamp
    ``clip(x, j-cmax, j+cmax)`` is the identity, so both paths compute the
    same coordinates.  The mask then covers the gather: ``x ∈ [j-cmax,
    j+cmax]`` and ``x >= 0.5 > 0`` give ``j0 = trunc(x) = floor(x) ∈
    [j-cmax, j+cmax]``, i.e. ``dj ∈ [-cmax, cmax]`` (one of the (2C+1)²
    mask keys), and the ``+1`` corner reads reach at most ``j+cmax+1``,
    inside the ``cmax``-padded buffer (rows identically).  For ``d > cmax``
    the window clamp fires on some cell and the results differ.  The
    boundary is pinned by ``tests/test_exactness_boundary.py`` (2-D & 3-D)."""
    dtype = jnp.promote_types(d0.dtype, jnp.float32)  # f32 coords + blend
    x, y = backtrace(u, v, dt, n)
    jj = jnp.arange(1, n + 1, dtype=dtype)[None, :]
    ii = jnp.arange(1, n + 1, dtype=dtype)[:, None]
    x = jnp.clip(x, jj - cmax, jj + cmax)
    y = jnp.clip(y, ii - cmax, ii + cmax)
    j0 = x.astype(jnp.int32)
    i0 = y.astype(jnp.int32)
    s1 = x - j0.astype(dtype)
    s0 = jnp.asarray(1.0, dtype) - s1
    t1 = y - i0.astype(dtype)
    t0 = jnp.asarray(1.0, dtype) - t1

    nshift = 2 * cmax + 1
    di = i0 - ii.astype(jnp.int32)
    dj = j0 - jj.astype(jnp.int32)
    key = (di + cmax) * nshift + (dj + cmax)

    pad = cmax  # padded reads stay in range: indices in [0, n+1] +- cmax
    dp = jnp.pad(d0, pad)
    zero = jnp.zeros((n, n), dtype)
    g00 = g01 = g10 = g11 = zero
    t = 0
    for a in range(-cmax, cmax + 1):
        for bb in range(-cmax, cmax + 1):
            r0, c0 = pad + 1 + a, pad + 1 + bb
            m = key == t
            g00 = jnp.where(m, jax.lax.slice(dp, (r0, c0), (r0 + n, c0 + n)), g00)
            g01 = jnp.where(
                m, jax.lax.slice(dp, (r0, c0 + 1), (r0 + n, c0 + 1 + n)), g01
            )
            g10 = jnp.where(
                m, jax.lax.slice(dp, (r0 + 1, c0), (r0 + 1 + n, c0 + n)), g10
            )
            g11 = jnp.where(
                m,
                jax.lax.slice(dp, (r0 + 1, c0 + 1), (r0 + 1 + n, c0 + 1 + n)),
                g11,
            )
            t += 1
    interior = s0 * (t0 * g00 + t1 * g10) + s1 * (t0 * g01 + t1 * g11)
    return embed_interior(b, interior.astype(d0.dtype))
