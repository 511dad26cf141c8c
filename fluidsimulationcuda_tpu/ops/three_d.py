"""3-D stable fluids operators (jnp backend).

The reference is strictly 2-D; this is the natural Stam generalization
(BASELINE config 5: smoke volumes), specified here since the reference has
nothing to cite:

- grid ``(n+2)³``, ghost cells on all six faces, index order [z, y, x];
- boundary modes b: 0 copy, 1 flip at x walls (u), 2 flip at y walls (v),
  3 flip at z walls (w);
- ghost layer is derived from the interior: faces mirror the adjacent
  interior cell (sign per mode), edges average their 2 adjacent face cells,
  corners average their 3 adjacent *edge* cells (set in the previous phase;
  the cascaded order mirrors the 2-D corner rule reading just-updated edge
  ghosts) — the 3-D analogue of ``set_bnd`` (``FluidSequential.c:62-75``).
  Neither edges nor corners are ever stencil inputs;
- diffusion: ``alpha = dt*k*n²``, ``beta = 1 + 6*alpha`` (6 neighbors);
  pressure: alpha=1, beta=6;
- advection: backtrace clamped to ``[0.5, n+0.5]`` per axis, trilinear
  gather.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "embed_faces3",
    "embed_interior3",
    "set_bnd3",
    "fix_edges3",
    "diffuse3",
    "advect3",
    "advect3_windowed",
    "divergence3",
    "pressure_solve3",
    "apply_pressure_gradient3",
    "project3",
]

_AXIS_OF_MODE = {1: 2, 2: 1, 3: 0}  # boundary mode -> flipped axis (z,y,x)


def embed_faces3(b: int, interior: jnp.ndarray) -> jnp.ndarray:
    """(n,n,n) interior -> padded volume with only the 6 ghost FACES set.
    Sufficient for the 6-point stencil (it never reads ghost edges or
    corners) — the 3-D version of the 2-D corner-deferral optimization."""
    dt = interior.dtype
    x = jnp.pad(interior, 1)
    for axis in range(3):
        sign = jnp.asarray(
            -1.0 if _AXIS_OF_MODE.get(b) == axis else 1.0, dt
        )
        idx_lo = [slice(None)] * 3
        idx_lo[axis] = 0
        src_lo = [slice(None)] * 3
        src_lo[axis] = 1
        x = x.at[tuple(idx_lo)].set(sign * x[tuple(src_lo)])
        idx_hi = [slice(None)] * 3
        idx_hi[axis] = -1
        src_hi = [slice(None)] * 3
        src_hi[axis] = -2
        x = x.at[tuple(idx_hi)].set(sign * x[tuple(src_hi)])
    return x


def embed_interior3(b: int, interior: jnp.ndarray) -> jnp.ndarray:
    """(n,n,n) interior -> (n+2,n+2,n+2) with derived ghost layer.

    Faces mirror the adjacent interior plane (negated on the wall-normal
    component's axis); edges (two ghost coords) average their 2 adjacent
    face cells; corners (three ghost coords) then average their 3 adjacent
    just-set EDGE cells — cascaded, like the 2-D corners reading updated
    edge ghosts.  Neither edges nor corners are ever a stencil input, so
    only the face values affect the solution.  One rule, one place:
    delegates to ``fix_faces3``/``fix_edges3`` (the same cascade
    ``set_bnd3`` uses) instead of keeping a second copy of the ghost rule.
    """
    return fix_edges3(fix_faces3(b, jnp.pad(interior, 1)))


def set_bnd3(b: int, x: jnp.ndarray) -> jnp.ndarray:
    """Re-derive the full ghost layer of a padded volume from its interior.
    Equivalent to ``embed_interior3(b, x[1:-1, 1:-1, 1:-1])`` but without
    the full-volume pad copy."""
    return fix_edges3(fix_faces3(b, x))


def fix_faces3(b: int, x: jnp.ndarray) -> jnp.ndarray:
    """Set ONLY the 6 ghost faces from the adjacent interior planes (sign
    per mode).  Edge/corner cells end up with face-rule values — call
    ``fix_edges3`` after if they are load-bearing (gather sources)."""
    dt = x.dtype
    for axis in range(3):
        sign = jnp.asarray(
            -1.0 if _AXIS_OF_MODE.get(b) == axis else 1.0, dt
        )
        idx_lo = [slice(None)] * 3
        idx_lo[axis] = 0
        src_lo = [slice(None)] * 3
        src_lo[axis] = 1
        x = x.at[tuple(idx_lo)].set(sign * x[tuple(src_lo)])
        idx_hi = [slice(None)] * 3
        idx_hi[axis] = -1
        src_hi = [slice(None)] * 3
        src_hi[axis] = -2
        x = x.at[tuple(idx_hi)].set(sign * x[tuple(src_hi)])
    return x


def fix_edges3(x: jnp.ndarray) -> jnp.ndarray:
    """Derive ONLY the ghost edges and corners from already-valid ghost
    faces (``fix_faces3``): 12 edge lines + 8 corner cells instead of the
    whole ghost layer.  Mode-independent: edge/corner values are plain
    averages of face values (no sign), see ``embed_interior3``."""
    dt = x.dtype
    half = jnp.asarray(0.5, dt)
    third = jnp.asarray(1.0 / 3.0, dt)
    n2 = x.shape[0]
    for a1 in range(3):
        for a2 in range(a1 + 1, 3):
            for i1 in (0, n2 - 1):
                for i2 in (0, n2 - 1):
                    idx = [slice(1, -1)] * 3
                    idx[a1], idx[a2] = i1, i2
                    nb1 = list(idx)
                    nb1[a1] = 1 if i1 == 0 else n2 - 2
                    nb2 = list(idx)
                    nb2[a2] = 1 if i2 == 0 else n2 - 2
                    x = x.at[tuple(idx)].set(
                        half * (x[tuple(nb1)] + x[tuple(nb2)])
                    )
    for iz in (0, n2 - 1):
        for iy in (0, n2 - 1):
            for ix in (0, n2 - 1):
                nz = 1 if iz == 0 else n2 - 2
                ny = 1 if iy == 0 else n2 - 2
                nx = 1 if ix == 0 else n2 - 2
                x = x.at[iz, iy, ix].set(
                    third * (x[nz, iy, ix] + x[iz, ny, ix] + x[iz, iy, nx])
                )
    return x


def diffuse3(b, x_init, x0, alpha, beta, iters):
    dt = x0.dtype
    a = jnp.asarray(alpha, dt)
    bt = jnp.asarray(beta, dt)
    rhs = x0[1:-1, 1:-1, 1:-1]

    def body(_, x):
        neigh = (
            ((x[1:-1, 1:-1, :-2] + x[1:-1, 1:-1, 2:])
             + (x[1:-1, :-2, 1:-1] + x[1:-1, 2:, 1:-1]))
            + (x[:-2, 1:-1, 1:-1] + x[2:, 1:-1, 1:-1])
        )
        # Faces only per sweep (the stencil never reads ghost edges or
        # corners); the full ghost layer is derived once at the end.
        return embed_faces3(b, (rhs + a * neigh) / bt)

    out = jax.lax.fori_loop(0, iters, body, x_init)
    return embed_interior3(b, out[1:-1, 1:-1, 1:-1])


def advect3(b, d0, u, v, w, dt, n):
    dtype = d0.dtype
    dt0 = jnp.asarray(dt, dtype) * n
    coords = jnp.arange(1, n + 1, dtype=dtype)
    zz = coords[:, None, None]
    yy = coords[None, :, None]
    xx = coords[None, None, :]
    x = xx - dt0 * u[1:-1, 1:-1, 1:-1]
    y = yy - dt0 * v[1:-1, 1:-1, 1:-1]
    z = zz - dt0 * w[1:-1, 1:-1, 1:-1]
    lo = jnp.asarray(0.5, dtype)
    hi = jnp.asarray(n + 0.5, dtype)
    x, y, z = jnp.clip(x, lo, hi), jnp.clip(y, lo, hi), jnp.clip(z, lo, hi)
    i0 = x.astype(jnp.int32)
    j0 = y.astype(jnp.int32)
    k0 = z.astype(jnp.int32)
    fx = x - i0.astype(dtype)
    fy = y - j0.astype(dtype)
    fz = z - k0.astype(dtype)

    side = n + 2
    flat = d0.reshape(-1)
    base = (k0 * side + j0) * side + i0

    def g(dz, dy, dx):
        return jnp.take(flat, base + (dz * side + dy) * side + dx)

    one = jnp.asarray(1.0, dtype)
    interior = (
        (one - fz) * (
            (one - fy) * ((one - fx) * g(0, 0, 0) + fx * g(0, 0, 1))
            + fy * ((one - fx) * g(0, 1, 0) + fx * g(0, 1, 1))
        )
        + fz * (
            (one - fy) * ((one - fx) * g(1, 0, 0) + fx * g(1, 0, 1))
            + fy * ((one - fx) * g(1, 1, 0) + fx * g(1, 1, 1))
        )
    )
    return embed_interior3(b, interior)


def advect3_windowed(b, d0, u, v, w, dt, n, cmax: int = 2):
    """Window-clamped trilinear advection via (2C+1)³ masked shifts — the
    3-D twin of ``ops.advect_windowed``; the sharded 3-D step uses it to
    bound its plane-halo depth.  Exact while
    the backtrace displacement stays below ``cmax`` cells per axis — the
    same condition, with the same proof, as the 2-D window
    (``ops/advect.py:advect_windowed``), applied per axis."""
    dtype = d0.dtype
    dt0 = jnp.asarray(dt, dtype) * n
    coords = jnp.arange(1, n + 1, dtype=dtype)
    zz = coords[:, None, None]
    yy = coords[None, :, None]
    xx = coords[None, None, :]
    x = xx - dt0 * u[1:-1, 1:-1, 1:-1]
    y = yy - dt0 * v[1:-1, 1:-1, 1:-1]
    z = zz - dt0 * w[1:-1, 1:-1, 1:-1]
    lo = jnp.asarray(0.5, dtype)
    hi = jnp.asarray(n + 0.5, dtype)
    x = jnp.clip(jnp.clip(x, lo, hi), xx - cmax, xx + cmax)
    y = jnp.clip(jnp.clip(y, lo, hi), yy - cmax, yy + cmax)
    z = jnp.clip(jnp.clip(z, lo, hi), zz - cmax, zz + cmax)
    i0 = x.astype(jnp.int32)
    j0 = y.astype(jnp.int32)
    k0 = z.astype(jnp.int32)
    fx = x - i0.astype(dtype)
    fy = y - j0.astype(dtype)
    fz = z - k0.astype(dtype)

    nsh = 2 * cmax + 1
    di = i0 - xx.astype(jnp.int32)
    dj = j0 - yy.astype(jnp.int32)
    dk = k0 - zz.astype(jnp.int32)
    key = ((dk + cmax) * nsh + (dj + cmax)) * nsh + (di + cmax)

    pad = cmax
    dp = jnp.pad(d0, pad)

    corners = {}
    zero = jnp.zeros((n, n, n), dtype)
    for cz in (0, 1):
        for cy in (0, 1):
            for cx in (0, 1):
                corners[(cz, cy, cx)] = zero
    t = 0
    for a in range(-cmax, cmax + 1):          # z shift
        for bb in range(-cmax, cmax + 1):     # y shift
            for cc in range(-cmax, cmax + 1):  # x shift
                m = key == t
                base = (pad + 1 + a, pad + 1 + bb, pad + 1 + cc)
                for (cz, cy, cx), acc in corners.items():
                    s0_ = (base[0] + cz, base[1] + cy, base[2] + cx)
                    sl = jax.lax.slice(
                        dp, s0_, (s0_[0] + n, s0_[1] + n, s0_[2] + n)
                    )
                    corners[(cz, cy, cx)] = jnp.where(m, sl, acc)
                t += 1

    one = jnp.asarray(1.0, dtype)
    interior = (
        (one - fz) * (
            (one - fy) * ((one - fx) * corners[(0, 0, 0)] + fx * corners[(0, 0, 1)])
            + fy * ((one - fx) * corners[(0, 1, 0)] + fx * corners[(0, 1, 1)])
        )
        + fz * (
            (one - fy) * ((one - fx) * corners[(1, 0, 0)] + fx * corners[(1, 0, 1)])
            + fy * ((one - fx) * corners[(1, 1, 0)] + fx * corners[(1, 1, 1)])
        )
    )
    return embed_interior3(b, interior)


def divergence3(u, v, w, n):
    dt = u.dtype
    h = jnp.asarray(1.0, dt) / n
    d = (jnp.asarray(-0.5, dt) * h) * (
        (u[1:-1, 1:-1, 2:] - u[1:-1, 1:-1, :-2])
        + (v[1:-1, 2:, 1:-1] - v[1:-1, :-2, 1:-1])
        + (w[2:, 1:-1, 1:-1] - w[:-2, 1:-1, 1:-1])
    )
    return embed_interior3(0, d)


def pressure_solve3(div, iters):
    return diffuse3(0, jnp.zeros_like(div), div, 1.0, 6.0, iters)


def apply_pressure_gradient3(u, v, w, p, n):
    dt = u.dtype
    h = jnp.asarray(1.0, dt) / n
    half = jnp.asarray(0.5, dt)
    un = u[1:-1, 1:-1, 1:-1] - (half * (p[1:-1, 1:-1, 2:] - p[1:-1, 1:-1, :-2])) / h
    vn = v[1:-1, 1:-1, 1:-1] - (half * (p[1:-1, 2:, 1:-1] - p[1:-1, :-2, 1:-1])) / h
    wn = w[1:-1, 1:-1, 1:-1] - (half * (p[2:, 1:-1, 1:-1] - p[:-2, 1:-1, 1:-1])) / h
    return (
        embed_interior3(1, un),
        embed_interior3(2, vn),
        embed_interior3(3, wn),
    )


def project3(u, v, w, n, iters):
    div = divergence3(u, v, w, n)
    p = pressure_solve3(div, iters)
    return apply_pressure_gradient3(u, v, w, p, n)
