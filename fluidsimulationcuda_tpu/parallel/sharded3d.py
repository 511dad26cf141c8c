"""Multi-device z-slab decomposition of the 3-D smoke-volume step.

The 3-D twin of ``parallel.sharded``: the padded ``(n+2)³`` volume is
partitioned into z-slabs over a 1-D device mesh; every stencil sweep
exchanges 1-deep *planes* with the two z-neighbors via ``lax.ppermute``
(neighbor-only traffic), and Jacobi solves exchange K-deep plane halos
once per K fused sweeps — the same fused-sweep margin scheme as the 2-D
path (``parallel/sharded.py:_diffuse_local``), one dimension up.

Why slabs and not pencils/blocks: a z-slab keeps every (y, x) plane whole
and contiguous on each device — all in-plane stencil work is local, and
the only communication surface is the z-plane, at (n+2)² cells per
neighbor.  This is the device-level generalization of the reference's
CUDA halo tiling (``smPar/FluidParallelBlockPerElement-SM.cu:169-192``)
applied to the 3-D solver the reference never built (its future-work
direction; the 2-D spec it generalizes is
``sequential/FluidSequential.c:107-141``).

Numerics are the 3-D jnp ops (``ops/three_d.py``) evaluated per slab:
the same per-cell expressions, so parity with the unsharded ``step3`` is
exact (elementwise identical; verified bit-level in
``tests/test_sharded_3d.py``).
"""
from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import SimConfig
from ..core.state import FluidState, Sources
from ..kernels.dispatch import resolve_backend
from .sharded import SHARDED_PLAIN

__all__ = ["make_sharded_step_fn_3d", "shard_state_3d"]

_AXIS_OF_MODE = {1: 2, 2: 1, 3: 0}  # boundary mode -> flipped axis (z,y,x)


# ---------------------------------------------------------------------------
# Local-slab helpers (run inside shard_map; x is an (mz, n+2, n+2) slab of
# the padded global volume, sharded along z = axis 0).
# ---------------------------------------------------------------------------


def _gz0(x: jnp.ndarray) -> jnp.ndarray:
    """Global z index of this slab's first plane."""
    return jax.lax.axis_index("z") * x.shape[0]


def _vplus(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """v[idx] = x[idx + e_axis]; the trailing entry is garbage (masked)."""
    sl = [slice(None)] * 3
    sl[axis] = slice(1, None)
    last = [slice(None)] * 3
    last[axis] = slice(-1, None)
    return jnp.concatenate([x[tuple(sl)], x[tuple(last)]], axis=axis)


def _vminus(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """v[idx] = x[idx - e_axis]; the leading entry is garbage (masked)."""
    sl = [slice(None)] * 3
    sl[axis] = slice(None, -1)
    first = [slice(None)] * 3
    first[axis] = slice(None, 1)
    return jnp.concatenate([x[tuple(first)], x[tuple(sl)]], axis=axis)


def _apply_bnd3_coords(b: int, x: jnp.ndarray, n: int, gz) -> jnp.ndarray:
    """``set_bnd3`` (``ops/three_d.py:embed_interior3``) applied to whatever
    global ghost cells fall inside an array whose plane 0 has global z
    index ``gz`` (y, x are always global: slabs keep planes whole).

    Three cascaded mask passes reproduce the unsharded semantics exactly:
    faces (one ghost coordinate) mirror the adjacent interior cell with the
    mode sign; edges (two) average their 2 adjacent *face* cells; corners
    (three) average their 3 adjacent *edge* cells.  Ghost-plane sources in
    z are local because every shard owns >= 2 planes (checked by the
    factory), so no exchange happens here.
    """
    dt = x.dtype
    m = x.shape[0]
    zc = (gz + jnp.arange(m))[:, None, None]
    yc = jnp.arange(x.shape[1])[None, :, None]
    xc = jnp.arange(x.shape[2])[None, None, :]
    coords = (zc, yc, xc)

    lo = [c == 0 for c in coords]
    hi = [c == n + 1 for c in coords]
    ghost = [l | h for l, h in zip(lo, hi)]
    flip_axis = _AXIS_OF_MODE.get(b)

    def inward(cur, axis):
        """Value of the neighbor one step toward the interior along axis."""
        return jnp.where(lo[axis], _vplus(cur, axis), _vminus(cur, axis))

    # Pass 1 — faces: exactly one ghost coordinate.
    for axis in range(3):
        others = [ghost[a] for a in range(3) if a != axis]
        face = ghost[axis] & ~others[0] & ~others[1]
        sign = jnp.asarray(-1.0 if flip_axis == axis else 1.0, dt)
        x = jnp.where(face, sign * inward(x, axis), x)

    # Pass 2 — edges: exactly two ghost coordinates, mean of the two
    # adjacent (just-finalized) face cells.
    half = jnp.asarray(0.5, dt)
    upd = x
    for a1 in range(3):
        for a2 in range(a1 + 1, 3):
            a3 = 3 - a1 - a2
            edge = ghost[a1] & ghost[a2] & ~ghost[a3]
            upd = jnp.where(edge, half * (inward(x, a1) + inward(x, a2)), upd)
    x = upd

    # Pass 3 — corners: mean of the three adjacent (just-finalized) edges.
    third = jnp.asarray(1.0 / 3.0, dt)
    corner = ghost[0] & ghost[1] & ghost[2]
    return jnp.where(
        corner, third * (inward(x, 0) + inward(x, 1) + inward(x, 2)), x
    )


def _apply_bnd3_local(b: int, x: jnp.ndarray, n: int) -> jnp.ndarray:
    return _apply_bnd3_coords(b, x, n, _gz0(x))


def _interior3_mask(x: jnp.ndarray, n: int, K: int = 0) -> jnp.ndarray:
    """Global-interior mask for a slab extended by K planes on each side."""
    m = x.shape[0]
    zc = (_gz0_ext(x, K) + jnp.arange(m))[:, None, None]
    yc = jnp.arange(x.shape[1])[None, :, None]
    xc = jnp.arange(x.shape[2])[None, None, :]
    ok = (zc >= 1) & (zc <= n)
    for c in (yc, xc):
        ok = ok & (c >= 1) & (c <= n)
    return ok


def _gz0_ext(x: jnp.ndarray, K: int) -> jnp.ndarray:
    return jax.lax.axis_index("z") * (x.shape[0] - 2 * K) - K


def _extend_z(x: jnp.ndarray, pz: int, K: int) -> jnp.ndarray:
    """(mz, s, s) slab -> (mz+2K, s, s) with K-deep plane halos from the two
    z-neighbor shards (wall shards receive zeros — masked / BC-derived, the
    same convention as the 2-D ``_extend_deep``)."""
    dt = x.dtype
    if pz > 1:
        fwd = [(i, i + 1) for i in range(pz - 1)]
        bwd = [(i + 1, i) for i in range(pz - 1)]
        above = jax.lax.ppermute(x[-K:], "z", fwd)   # from the slab below
        below = jax.lax.ppermute(x[:K], "z", bwd)    # from the slab above
    else:
        above = jnp.zeros((K,) + x.shape[1:], dt)
        below = jnp.zeros((K,) + x.shape[1:], dt)
    return jnp.concatenate([above, x, below], axis=0)


def _diffuse3_local(b, x_init, rhs, alpha, beta, iters, n, pz, fuse=8):
    """6-neighbor Jacobi solve with fused-sweep plane-halo exchange:
    exchange K-deep z-halos once, run K local sweeps with the validity
    region shrinking into the halo (2 messages per K sweeps instead of 2
    per sweep).  Bit-identical to per-sweep exchange: the K-sweep
    dependence cone of every interior cell lies inside the exchanged
    window (in-plane dependencies are always local)."""
    dt = rhs.dtype
    a = jnp.asarray(alpha, dt)
    bt = jnp.asarray(beta, dt)
    mz = rhs.shape[0]
    K = max(1, min(fuse, iters, (mz - 2) // 2 if mz > 4 else 1))

    # rhs is chunk-invariant: exchange its K-deep halo ONCE, not per chunk
    # (with iters=20, K=8 that is 3 chunks -> 2 redundant plane exchanges
    # per solve otherwise).
    rhs_ext = _extend_z(rhs, pz, K)

    def chunk(x, sweeps_in_chunk):
        ext = _extend_z(x, pz, K)
        interior = _interior3_mask(ext, n, K)
        gz = _gz0_ext(ext, K)

        def body(s, ext):
            neigh = (
                ((ext[1:-1, 1:-1, :-2] + ext[1:-1, 1:-1, 2:])
                 + (ext[1:-1, :-2, 1:-1] + ext[1:-1, 2:, 1:-1]))
                + (ext[:-2, 1:-1, 1:-1] + ext[2:, 1:-1, 1:-1])
            )
            new = (rhs_ext[1:-1, 1:-1, 1:-1] + a * neigh) / bt
            new = jnp.pad(new, 1)  # rim garbage, outside validity
            ext2 = jnp.where(interior, new, ext)
            return _apply_bnd3_coords(b, ext2, n, gz)

        ext = jax.lax.fori_loop(0, sweeps_in_chunk, body, ext)
        return ext[K:-K]

    x = x_init
    done = 0
    while done < iters:
        s = min(K, iters - done)
        x = chunk(x, s)
        done += s
    return x


def _cheby_diffuse3_local(b, x_init, rhs, alpha, beta, iters, rho, n, pz,
                          fuse=8):
    """Chebyshev three-term chain over the SAME chunked plane-halo
    machinery as ``_diffuse3_local`` — the z-slab twin of
    ``ops.chebyshev.cheby_diffuse3``.

    Two facts make the chunking sound: (a) the combine
    ``x_{k+1} = w·S(x_k) + (1-w)·x_{k-1}`` reads x_{k-1} POINTWISE, so it
    adds no stencil depth — the K-sweep validity-cone argument is
    unchanged; (b) x_{k-1} must still be halo-exchanged each chunk,
    because margin-region cells inside the cone combine with x_{k-1}
    values the neighbor shard owns (2 field exchanges per K sweeps
    instead of 1 — the same tax the unsharded chain pays as its extra
    DMA'd operand).  The w schedule is sliced per chunk from the global
    ``cheby_omegas`` position, so chunk boundaries never reset it."""
    from ..ops.chebyshev import cheby_omegas

    dt = rhs.dtype
    a = jnp.asarray(alpha, dt)
    bt = jnp.asarray(beta, dt)
    one = jnp.asarray(1.0, dt)
    mz = rhs.shape[0]
    K = max(1, min(fuse, iters, (mz - 2) // 2 if mz > 4 else 1))
    ws_all = [None] + [float(w) for w in cheby_omegas(float(rho), iters)]

    rhs_ext = _extend_z(rhs, pz, K)

    def chunk(x, xm, ws):
        ext = _extend_z(x, pz, K)
        extm = _extend_z(xm, pz, K) if xm is not None else None
        interior = _interior3_mask(ext, n, K)
        gz = _gz0_ext(ext, K)

        def sweep(cur):
            neigh = (
                ((cur[1:-1, 1:-1, :-2] + cur[1:-1, 1:-1, 2:])
                 + (cur[1:-1, :-2, 1:-1] + cur[1:-1, 2:, 1:-1]))
                + (cur[:-2, 1:-1, 1:-1] + cur[2:, 1:-1, 1:-1])
            )
            return jnp.pad(
                (rhs_ext[1:-1, 1:-1, 1:-1] + a * neigh) / bt, 1
            )

        for w in ws:  # static unroll: per-sweep w's differ
            new = sweep(ext)
            if w is not None:
                wc = jnp.asarray(w, dt)
                new = wc * new + (one - wc) * extm
            new = jnp.where(interior, new, ext)
            new = _apply_bnd3_coords(b, new, n, gz)
            extm, ext = ext, new
        return ext[K:-K], extm[K:-K]

    x, xm = x_init, None
    done = 0
    while done < iters:
        s = min(K, iters - done)
        x, xm = chunk(x, xm, tuple(ws_all[done:done + s]))
        done += s
    return x


def _cheby_pressure3_local(div, iters, rho, n, pz):
    return _cheby_diffuse3_local(0, jnp.zeros_like(div), div, 1.0, 6.0,
                                 iters, rho, n, pz)


def _dens_cheby_iters(cfg: SimConfig):
    """Density-diffusion solver selection shared by both step-locals
    (mirrors ``models.stable_fluids_3d`` dens dispatch): the Chebyshev
    iteration count, or None for the parity Jacobi solve."""
    if cfg.diffusion_solver == "chebyshev":
        return cfg.cheby_iters
    if cfg.diffusion_solver == "chebyshev-dens":
        return cfg.cheby_dens_iters
    return None


def _advect3_local_exact(b, d0, u, v, w, dtim, n, pz):
    """Reference-semantics trilinear advection: all-gather the advected
    volume over z (O(volume) collective traffic — correctness mode)."""
    dt = d0.dtype
    full = jax.lax.all_gather(d0, "z", axis=0, tiled=True)
    mz = d0.shape[0]
    gz = _gz0(d0)
    zz = (gz + jnp.arange(mz)).astype(dt)[:, None, None]
    yy = jnp.arange(d0.shape[1], dtype=dt)[None, :, None]
    xx = jnp.arange(d0.shape[2], dtype=dt)[None, None, :]
    dt0 = jnp.asarray(dtim, dt) * n
    x = xx - dt0 * u
    y = yy - dt0 * v
    z = zz - dt0 * w
    lo = jnp.asarray(0.5, dt)
    hi = jnp.asarray(n + 0.5, dt)
    x, y, z = jnp.clip(x, lo, hi), jnp.clip(y, lo, hi), jnp.clip(z, lo, hi)
    i0 = x.astype(jnp.int32)
    j0 = y.astype(jnp.int32)
    k0 = z.astype(jnp.int32)
    fx = x - i0.astype(dt)
    fy = y - j0.astype(dt)
    fz = z - k0.astype(dt)
    side = n + 2
    flat = full.reshape(-1)
    base = (k0 * side + j0) * side + i0

    def g(dz, dy, dx):
        return jnp.take(flat, base + (dz * side + dy) * side + dx)

    one = jnp.asarray(1.0, dt)
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
    out = jnp.where(_interior3_mask(d0, n), interior, d0)
    return _apply_bnd3_local(b, out, n)


def _advect3_local_windowed(b, d0, u, v, w, dtim, n, pz, cmax):
    """Window-clamped trilinear advection with a (cmax+1)-deep plane-halo
    exchange instead of the all-gather — the slab twin of
    ``ops/three_d.py:advect3_windowed`` (same window, same exactness
    condition: displacement < cmax per axis)."""
    dt = d0.dtype
    K = cmax + 1
    ext = _extend_z(d0, pz, K)               # (mz+2K, s, s)
    dp = jnp.pad(ext, ((0, 0), (K, K), (K, K)))
    mz = d0.shape[0]
    s = d0.shape[1]
    gz = _gz0(d0)
    zz = (gz + jnp.arange(mz)).astype(dt)[:, None, None]
    yy = jnp.arange(s, dtype=dt)[None, :, None]
    xx = jnp.arange(s, dtype=dt)[None, None, :]
    dt0 = jnp.asarray(dtim, dt) * n
    x = xx - dt0 * u
    y = yy - dt0 * v
    z = zz - dt0 * w
    lo = jnp.asarray(0.5, dt)
    hi = jnp.asarray(n + 0.5, dt)
    x = jnp.clip(jnp.clip(x, lo, hi), xx - cmax, xx + cmax)
    y = jnp.clip(jnp.clip(y, lo, hi), yy - cmax, yy + cmax)
    z = jnp.clip(jnp.clip(z, lo, hi), zz - cmax, zz + cmax)
    i0 = x.astype(jnp.int32)
    j0 = y.astype(jnp.int32)
    k0 = z.astype(jnp.int32)
    fx = x - i0.astype(dt)
    fy = y - j0.astype(dt)
    fz = z - k0.astype(dt)

    nsh = 2 * cmax + 1
    di = i0 - xx.astype(jnp.int32)
    dj = j0 - yy.astype(jnp.int32)
    dk = k0 - zz.astype(jnp.int32)
    key = ((dk + cmax) * nsh + (dj + cmax)) * nsh + (di + cmax)

    corners = {
        (cz, cy, cx): jnp.zeros((mz, s, s), dt)
        for cz in (0, 1) for cy in (0, 1) for cx in (0, 1)
    }
    t = 0
    for a in range(-cmax, cmax + 1):          # z shift
        for bb in range(-cmax, cmax + 1):     # y shift
            for cc in range(-cmax, cmax + 1):  # x shift
                m = key == t
                base = (K + a, K + bb, K + cc)
                for (cz, cy, cx), acc in corners.items():
                    s0_ = (base[0] + cz, base[1] + cy, base[2] + cx)
                    sl = jax.lax.slice(
                        dp, s0_, (s0_[0] + mz, s0_[1] + s, s0_[2] + s)
                    )
                    corners[(cz, cy, cx)] = jnp.where(m, sl, acc)
                t += 1

    one = jnp.asarray(1.0, dt)
    interior = (
        (one - fz) * (
            (one - fy) * ((one - fx) * corners[(0, 0, 0)]
                          + fx * corners[(0, 0, 1)])
            + fy * ((one - fx) * corners[(0, 1, 0)] + fx * corners[(0, 1, 1)])
        )
        + fz * (
            (one - fy) * ((one - fx) * corners[(1, 0, 0)]
                          + fx * corners[(1, 0, 1)])
            + fy * ((one - fx) * corners[(1, 1, 0)] + fx * corners[(1, 1, 1)])
        )
    )
    out = jnp.where(_interior3_mask(d0, n), interior, d0)
    return _apply_bnd3_local(b, out, n)


def _divergence3_local(u, v, w, n, pz):
    dt = u.dtype
    we = _extend_z(w, pz, 1)  # only the z-difference crosses slab seams
    h = jnp.asarray(1.0, dt) / n
    d = (jnp.asarray(-0.5, dt) * h) * (
        (_vplus(u, 2) - _vminus(u, 2))
        + (_vplus(v, 1) - _vminus(v, 1))
        + (we[2:] - we[:-2])
    )
    out = jnp.where(_interior3_mask(u, n), d, jnp.zeros_like(u))
    return _apply_bnd3_local(0, out, n)


def _gradient3_local(u, v, w, p, n, pz):
    dt = u.dtype
    pe = _extend_z(p, pz, 1)
    h = jnp.asarray(1.0, dt) / n
    half = jnp.asarray(0.5, dt)
    un = u - (half * (_vplus(p, 2) - _vminus(p, 2))) / h
    vn = v - (half * (_vplus(p, 1) - _vminus(p, 1))) / h
    wn = w - (half * (pe[2:] - pe[:-2])) / h
    mask = _interior3_mask(u, n)
    u = jnp.where(mask, un, u)
    v = jnp.where(mask, vn, v)
    w = jnp.where(mask, wn, w)
    return (
        _apply_bnd3_local(1, u, n),
        _apply_bnd3_local(2, v, n),
        _apply_bnd3_local(3, w, n),
    )


def _project3_local(u, v, w, n, iters, pz, cheby_rho=None):
    div = _divergence3_local(u, v, w, n, pz)
    if cheby_rho is not None:
        p = _cheby_pressure3_local(div, iters, cheby_rho, n, pz)
    else:
        p = _diffuse3_local(0, jnp.zeros_like(div), div, 1.0, 6.0, iters,
                            n, pz)
    return _gradient3_local(u, v, w, p, n, pz)


def _disp3_global(u, v, w, dt0):
    m = jnp.maximum(jnp.abs(u).max(), jnp.abs(v).max())
    local = jnp.maximum(m, jnp.abs(w).max()) * dt0
    return jax.lax.pmax(local, "z")


def _step3_local(cfg: SimConfig, pz: int, advect_mode: str, audited: bool,
                 state: FluidState, src: Sources):
    """Per-slab step — the composition of ``models.stable_fluids_3d.step3``
    evaluated on z-slabs (same expressions → exact parity)."""
    n, dtim = cfg.n, cfg.dt
    it = cfg.jacobi_iters
    dt_c = jnp.asarray(dtim, state.u.dtype)

    if advect_mode == "windowed":
        def _advect(b, d0, uu, vv, ww):
            return _advect3_local_windowed(
                b, d0, uu, vv, ww, dtim, n, pz, cfg.max_courant
            )
    else:
        def _advect(b, d0, uu, vv, ww):
            return _advect3_local_exact(b, d0, uu, vv, ww, dtim, n, pz)

    # Solver dispatch mirrors models.stable_fluids_3d (vel_step3/
    # dens_step3): chebyshev pressure/diffusion are the 3-D compensated
    # perf mode's solves, here in z-slab local form.
    cheby_p = cfg.cheby_rho if cfg.pressure_solver == "chebyshev" else None
    it_p = cfg.press_cheby_iters if cheby_p is not None else it

    def vel_diffuse(b, guess, rhs, alpha, beta):
        if cfg.diffusion_solver == "chebyshev":
            return _cheby_diffuse3_local(b, guess, rhs, alpha, beta,
                                         cfg.cheby_iters, cfg.cheby_rho,
                                         n, pz)
        return _diffuse3_local(b, guess, rhs, alpha, beta, it, n, pz)

    u = state.u + dt_c * src.u
    v = state.v + dt_c * src.v
    w = state.w + dt_c * src.w
    alpha = cfg.diffusion_alpha_visc
    beta = 1.0 + 6.0 * alpha
    u = vel_diffuse(1, src.u, u, alpha, beta)
    v = vel_diffuse(2, src.v, v, alpha, beta)
    w = vel_diffuse(3, src.w, w, alpha, beta)
    u, v, w = _project3_local(u, v, w, n, it_p, pz, cheby_rho=cheby_p)
    d_vel = _disp3_global(u, v, w, dtim * n) if audited else None
    u0, v0, w0 = u, v, w
    u = _advect(1, u0, u0, v0, w0)
    v = _advect(2, v0, u0, v0, w0)
    w = _advect(3, w0, u0, v0, w0)
    u, v, w = _project3_local(u, v, w, n, it_p, pz, cheby_rho=cheby_p)
    d_dens = _disp3_global(u, v, w, dtim * n) if audited else None

    dens = state.dens + dt_c * src.dens
    alpha = cfg.diffusion_alpha_diff
    beta = 1.0 + 6.0 * alpha
    kd = _dens_cheby_iters(cfg)
    if kd is not None:
        dens = _cheby_diffuse3_local(0, src.dens, dens, alpha, beta,
                                     kd, cfg.cheby_rho, n, pz)
    else:
        dens = _diffuse3_local(0, src.dens, dens, alpha, beta, it, n, pz)
    dens = _advect(0, dens, u, v, w)
    out = FluidState(dens=dens, u=u, v=v, w=w)
    if audited:
        return out, jnp.maximum(d_vel, d_dens)
    return out


def make_sharded_step_fn_3d(
    cfg: SimConfig, mesh: Mesh, *, advect_mode: str = "auto",
    audited: bool = False,
) -> Callable[[FluidState, Sources], FluidState]:
    """A jitted multi-device 3-D step over z-slabs.

    Any mesh shape is accepted and flattened to a 1-D ``("z",)`` mesh of
    all its devices (a z-slab decomposition is inherently 1-D; see the
    module docstring for why slabs).  Inputs/outputs are global padded
    volumes sharded ``P("z")`` on axis 0; requires
    ``(n+2)`` divisible by the device count with >= 2 planes per shard
    (ghost-plane mirrors read the adjacent interior plane locally) and
    >= ``max_courant + 1`` planes for windowed advection.

    ``advect_mode``: "windowed" exchanges a ``max_courant``-deep plane halo
    (neighbor-only traffic, the scale mode); "exact" all-gathers the volume
    (reference semantics for any displacement); "auto" picks windowed when
    the slabs can host the halo.

    ``audited=True`` returns ``(state, max_displacement)`` — the 3-D twin
    of the 2-D sharded audit (``pmax`` over the mesh), asserting the
    exact-gather regime condition displacement < ``max_courant``.

    Like the 2-D sharded step, the callable carries ``.backend`` /
    ``.backend_reason``; ``hopper`` raises.
    """
    if cfg.ndim != 3:
        raise ValueError("make_sharded_step_fn_3d requires cfg.ndim == 3")
    backend, reason = resolve_backend(cfg, SHARDED_PLAIN)
    if cfg.pressure_solver not in ("jacobi", "chebyshev"):
        raise ValueError(
            "sharded 3-D supports pressure_solver='jacobi' or 'chebyshev' "
            "(mg/cg are 2-D solvers)"
        )
    if advect_mode not in ("auto", "exact", "windowed"):
        raise ValueError(f"unknown advect_mode {advect_mode!r}")

    devices = mesh.devices.reshape(-1)
    pz = devices.size
    zmesh = Mesh(devices, ("z",))
    side = cfg.n + 2
    if side % pz:
        raise ValueError(
            f"volume side {side} not divisible by device count {pz}"
        )
    mz = side // pz
    if mz < 2:
        raise ValueError(
            f"z-slab decomposition needs >= 2 planes per shard; got {mz}"
        )
    if advect_mode == "auto":
        advect_mode = "windowed" if mz >= cfg.max_courant + 1 else "exact"
    if advect_mode == "windowed" and mz < cfg.max_courant + 1:
        raise ValueError(
            f"windowed advection needs >= {cfg.max_courant + 1} planes per "
            f"shard (max_courant={cfg.max_courant}); got {mz}. Use "
            f"advect_mode='exact' or a coarser mesh."
        )

    spec = P("z")
    state_specs = FluidState(dens=spec, u=spec, v=spec, w=spec)
    src_specs = Sources(dens=spec, u=spec, v=spec, w=spec)
    out_specs = (state_specs, P()) if audited else state_specs

    local = functools.partial(_step3_local, cfg, pz, advect_mode, audited)
    jitted = jax.jit(jax.shard_map(
        local, mesh=zmesh, in_specs=(state_specs, src_specs),
        out_specs=out_specs,
    ))

    def step_fn(state, src):
        return jitted(state, src)

    step_fn.advect_mode = advect_mode
    step_fn.mesh = zmesh
    step_fn.backend, step_fn.backend_reason = backend, reason
    return step_fn


def shard_state_3d(tree, mesh: Mesh):
    """Device-put a 3-D state/sources pytree with the z-slab sharding."""
    devices = mesh.devices.reshape(-1)
    sh = NamedSharding(Mesh(devices, ("z",)), P("z"))
    return jax.tree.map(
        lambda a: jax.device_put(a, sh) if a is not None else None, tree
    )
