"""Multi-device spatial decomposition of the stable-fluids step.

Design (SURVEY.md §2.3 "Distributed backend"): the padded (n+2, n+2) grid is
partitioned block-wise over a 2-D device mesh; every stencil sweep exchanges
a 1-cell halo with the four mesh neighbors via ``lax.ppermute`` (neighbor-only
traffic), and the physical boundary rule is applied
*locally* by the shards that own a wall.  This is the device-level
generalization of the reference's CUDA-block halo tiles
(``smPar/FluidParallelBlockPerElement-SM.cu:169-192``) — except functional:
no barriers, no divergent ``__syncthreads`` (cf. the precedence-bugged edge
guards, ``naivePar/...BlockPerElement-Naive.cu:134-141``).

Semantics are bit-compatible with the single-device path: the local update
expressions are the same jnp expressions evaluated on local blocks, including
the reference quirk that a Jacobi initial guess contributes its *raw* ghost
ring to the first sweep (sources have live border values,
``FluidSequential.c:244-271``).

Advection has two modes: "exact" all-gathers the advected field (the
backtrace displacement is not halo-bounded, ``FluidSequential.c:111``);
"windowed" exchanges a ``max_courant``-deep halo and clamps like
``ops.advect_windowed``.  Jacobi solves exchange K-deep halos once per K
fused sweeps.
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

__all__ = ["make_sharded_step_fn", "shard_state"]

# Why the sharded steps (2-D and 3-D) decline the Jacobi kernel.
SHARDED_PLAIN = "the sharded steps run plain local ops inside shard_map"


# ---------------------------------------------------------------------------
# Local-block helpers (run inside shard_map; x is an (m, k) tile of the
# padded global grid).
# ---------------------------------------------------------------------------


def _global_coords(x: jnp.ndarray):
    """Global (row, col) index arrays for a local block."""
    m, k = x.shape
    r0 = jax.lax.axis_index("x") * m
    c0 = jax.lax.axis_index("y") * k
    gr = r0 + jnp.arange(m)[:, None]  # (m, 1)
    gc = c0 + jnp.arange(k)[None, :]  # (1, k)
    return gr, gc


def _neighbor_halos(x: jnp.ndarray, px: int, py: int):
    """1-deep halo rows/cols from the four mesh neighbors.

    Wall-side shards receive zeros — harmless, because the stencil is only
    evaluated on global-interior cells and wall shards own the ghost ring
    themselves.
    """
    m, k = x.shape
    dt = x.dtype
    if px > 1:
        fwd = [(i, i + 1) for i in range(px - 1)]
        bwd = [(i + 1, i) for i in range(px - 1)]
        top = jax.lax.ppermute(x[-1:, :], "x", fwd)      # from row-above shard
        bottom = jax.lax.ppermute(x[:1, :], "x", bwd)    # from row-below shard
    else:
        top = jnp.zeros((1, k), dt)
        bottom = jnp.zeros((1, k), dt)
    if py > 1:
        fwd = [(i, i + 1) for i in range(py - 1)]
        bwd = [(i + 1, i) for i in range(py - 1)]
        left = jax.lax.ppermute(x[:, -1:], "y", fwd)
        right = jax.lax.ppermute(x[:, :1], "y", bwd)
    else:
        left = jnp.zeros((m, 1), dt)
        right = jnp.zeros((m, 1), dt)
    return top, bottom, left, right


def _extend(x: jnp.ndarray, px: int, py: int) -> jnp.ndarray:
    """(m, k) local block -> (m+2, k+2) with neighbor halos (corner cells of
    the extension are never read by the 5-point stencil)."""
    m, k = x.shape
    dt = x.dtype
    top, bottom, left, right = _neighbor_halos(x, px, py)
    rows = jnp.concatenate([top, x, bottom], axis=0)  # (m+2, k)
    zc = jnp.zeros((1, 1), dt)
    lcol = jnp.concatenate([zc, left, zc], axis=0)    # (m+2, 1)
    rcol = jnp.concatenate([zc, right, zc], axis=0)
    return jnp.concatenate([lcol, rows, rcol], axis=1)


def _shifts(x: jnp.ndarray):
    """In-block neighbor views (edge entries are don't-care garbage, always
    masked): l[r,c]=x[r,c+1], r[r,c]=x[r,c-1], u[r,c]=x[r+1,c], d[r,c]=x[r-1,c]."""
    xl = jnp.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    xr = jnp.concatenate([x[:, :1], x[:, :-1]], axis=1)
    xu = jnp.concatenate([x[1:, :], x[-1:, :]], axis=0)
    xd = jnp.concatenate([x[:1, :], x[:-1, :]], axis=0)
    return xl, xr, xu, xd


def _apply_bnd_coords(
    b: int, x: jnp.ndarray, n: int, gr: jnp.ndarray, gc: jnp.ndarray
) -> jnp.ndarray:
    """``set_bnd`` (``FluidSequential.c:62-75``) applied to whatever global
    ghost cells fall inside an array with global coordinates (gr, gc)."""
    dt = x.dtype
    sx = jnp.asarray(-1.0 if b == 1 else 1.0, dt)
    sy = jnp.asarray(-1.0 if b == 2 else 1.0, dt)
    row0 = gr == 0
    rowN1 = gr == n + 1
    col0 = gc == 0
    colN1 = gc == n + 1
    row_int = (gr >= 1) & (gr <= n)
    col_int = (gc >= 1) & (gc <= n)

    xl, xr, xu, xd = _shifts(x)
    x = jnp.where(col0 & row_int, sx * xl, x)
    x = jnp.where(colN1 & row_int, sx * xr, x)
    x = jnp.where(row0 & col_int, sy * xu, x)
    x = jnp.where(rowN1 & col_int, sy * xd, x)

    # Corners read the just-updated edge ghosts (reference order: edges in
    # the i-loop, then corners, FluidSequential.c:65-74).
    xl, xr, xu, xd = _shifts(x)
    half = jnp.asarray(0.5, dt)
    hpart = jnp.where(col0, xl, xr)
    vpart = jnp.where(row0, xu, xd)
    corner = (row0 | rowN1) & (col0 | colN1)
    return jnp.where(corner, half * (hpart + vpart), x)


def _apply_bnd_local(b: int, x: jnp.ndarray, n: int) -> jnp.ndarray:
    """``set_bnd`` on a plain (unhaloed) local block."""
    gr, gc = _global_coords(x)
    return _apply_bnd_coords(b, x, n, gr, gc)


def _interior_mask(x: jnp.ndarray, n: int) -> jnp.ndarray:
    gr, gc = _global_coords(x)
    return (gr >= 1) & (gr <= n) & (gc >= 1) & (gc <= n)


def _jacobi_sweep_local(
    b: int, x, rhs, alpha, beta, n: int, px: int, py: int
):
    ext = _extend(x, px, py)
    neigh = ((ext[1:-1, :-2] + ext[1:-1, 2:]) + ext[:-2, 1:-1]) + ext[2:, 1:-1]
    new = (rhs + alpha * neigh) / beta
    x = jnp.where(_interior_mask(x, n), new, x)
    return _apply_bnd_local(b, x, n)


def _extend_deep(x: jnp.ndarray, px: int, py: int, K: int) -> jnp.ndarray:
    """(m, k) -> (m+2K, k+2K) with K-deep halos via the standard two-phase
    exchange: rows first, then columns of the row-extended array — the second
    phase carries the diagonal (corner) blocks that K-deep stencil cones
    need.  Wall sides receive zeros (masked / BC-derived)."""
    m, k = x.shape
    dt = x.dtype
    if px > 1:
        fwd = [(i, i + 1) for i in range(px - 1)]
        bwd = [(i + 1, i) for i in range(px - 1)]
        top = jax.lax.ppermute(x[-K:, :], "x", fwd)
        bottom = jax.lax.ppermute(x[:K, :], "x", bwd)
    else:
        top = jnp.zeros((K, k), dt)
        bottom = jnp.zeros((K, k), dt)
    rows = jnp.concatenate([top, x, bottom], axis=0)  # (m+2K, k)
    if py > 1:
        fwd = [(i, i + 1) for i in range(py - 1)]
        bwd = [(i + 1, i) for i in range(py - 1)]
        left = jax.lax.ppermute(rows[:, -K:], "y", fwd)
        right = jax.lax.ppermute(rows[:, :K], "y", bwd)
    else:
        left = jnp.zeros((m + 2 * K, K), dt)
        right = jnp.zeros((m + 2 * K, K), dt)
    return jnp.concatenate([left, rows, right], axis=1)


def _ext_coords(shape, K: int):
    """Global coordinates of a K-extended local block."""
    me, ke = shape
    r0 = jax.lax.axis_index("x") * (me - 2 * K) - K
    c0 = jax.lax.axis_index("y") * (ke - 2 * K) - K
    gr = r0 + jnp.arange(me)[:, None]
    gc = c0 + jnp.arange(ke)[None, :]
    return gr, gc


def _diffuse_local(b, x_init, rhs, alpha, beta, iters, n, px, py, fuse=8):
    """Jacobi solve with fused-sweep halo exchange: exchange K-deep halos
    once, run K local sweeps with the validity region shrinking into the
    halo — the device-level version of the Jacobi kernel's halo tiles.
    Exchanges drop from 4 messages/sweep to 4 messages/K-sweeps
    (latency bound at scale).  Bit-identical to per-sweep exchange:
    every interior cell's K-sweep dependence cone lies inside the exchanged
    window (diagonals included via the two-phase exchange)."""
    dt = rhs.dtype
    a = jnp.asarray(alpha, dt)
    bt = jnp.asarray(beta, dt)
    m, k = rhs.shape
    K = max(1, min(fuse, iters, (m - 2) // 2 if m > 4 else 1,
                   (k - 2) // 2 if k > 4 else 1))

    # rhs is chunk-invariant: exchange its K-deep halo once, not per chunk.
    rhs_ext = _extend_deep(rhs, px, py, K)

    def chunk(x, sweeps_in_chunk):
        ext = _extend_deep(x, px, py, K)
        gr, gc = _ext_coords(ext.shape, K)
        interior = (gr >= 1) & (gr <= n) & (gc >= 1) & (gc <= n)

        def body(s, ext):
            neigh = (
                (ext[1:-1, :-2] + ext[1:-1, 2:]) + ext[:-2, 1:-1]
            ) + ext[2:, 1:-1]
            new = (rhs_ext[1:-1, 1:-1] + a * neigh) / bt
            new = jnp.pad(new, 1)  # rim garbage, outside validity
            ext2 = jnp.where(interior, new, ext)
            return _apply_bnd_coords(b, ext2, n, gr, gc)

        ext = jax.lax.fori_loop(0, sweeps_in_chunk, body, ext)
        return ext[K:-K, K:-K]

    x = x_init
    done = 0
    while done < iters:
        s = min(K, iters - done)
        x = chunk(x, s)
        done += s
    return x


def _gather_global(x: jnp.ndarray) -> jnp.ndarray:
    """Assemble the full padded grid on every shard (for advection)."""
    full = jax.lax.all_gather(x, "x", axis=0, tiled=True)
    return jax.lax.all_gather(full, "y", axis=1, tiled=True)


def _advect_local(b, d0, u, v, dtim, n, px, py):
    dt = d0.dtype
    d0_full = _gather_global(d0)
    gr, gc = _global_coords(d0)
    dt0 = jnp.asarray(dtim, dt) * n
    xx = gc.astype(dt) - dt0 * u
    yy = gr.astype(dt) - dt0 * v
    lo = jnp.asarray(0.5, dt)
    hi = jnp.asarray(n + 0.5, dt)
    xx = jnp.clip(xx, lo, hi)
    yy = jnp.clip(yy, lo, hi)
    j0 = xx.astype(jnp.int32)
    i0 = yy.astype(jnp.int32)
    s1 = xx - j0.astype(dt)
    s0 = jnp.asarray(1.0, dt) - s1
    t1 = yy - i0.astype(dt)
    t0 = jnp.asarray(1.0, dt) - t1
    side = n + 2
    flat = d0_full.reshape(-1)
    base = i0 * side + j0
    g00 = jnp.take(flat, base)
    g10 = jnp.take(flat, base + side)
    g01 = jnp.take(flat, base + 1)
    g11 = jnp.take(flat, base + side + 1)
    interior = s0 * (t0 * g00 + t1 * g10) + s1 * (t0 * g01 + t1 * g11)
    x = jnp.where(_interior_mask(d0, n), interior, d0)
    return _apply_bnd_local(b, x, n)


def _advect_local_windowed(b, d0, u, v, dtim, n, px, py, cmax):
    """Window-clamped advection with halo exchange instead of all-gather:
    the multi-device twin of ``ops.advect_windowed``.  Communication drops from a full-grid all-gather to a
    (cmax+1)-deep halo exchange."""
    dt = d0.dtype
    K = cmax + 1
    ext = _extend_deep(d0, px, py, K)
    m, k = d0.shape
    gr, gc = _global_coords(d0)
    dt0 = jnp.asarray(dtim, dt) * n
    x = gc.astype(dt) - dt0 * u
    y = gr.astype(dt) - dt0 * v
    lo = jnp.asarray(0.5, dt)
    hi = jnp.asarray(n + 0.5, dt)
    x = jnp.clip(jnp.clip(x, lo, hi), gc - cmax, gc + cmax)
    y = jnp.clip(jnp.clip(y, lo, hi), gr - cmax, gr + cmax)
    j0 = x.astype(jnp.int32)
    i0 = y.astype(jnp.int32)
    s1 = x - j0.astype(dt)
    s0 = jnp.asarray(1.0, dt) - s1
    t1 = y - i0.astype(dt)
    t0 = jnp.asarray(1.0, dt) - t1

    nshift = 2 * cmax + 1
    key = (i0 - gr + cmax) * nshift + (j0 - gc + cmax)
    zero = jnp.zeros((m, k), dt)
    g00 = g01 = g10 = g11 = zero
    t = 0
    for a in range(-cmax, cmax + 1):
        for bb in range(-cmax, cmax + 1):
            r0, c0 = K + a, K + bb
            mask = key == t
            g00 = jnp.where(mask, jax.lax.slice(ext, (r0, c0), (r0 + m, c0 + k)), g00)
            g01 = jnp.where(mask, jax.lax.slice(ext, (r0, c0 + 1), (r0 + m, c0 + 1 + k)), g01)
            g10 = jnp.where(mask, jax.lax.slice(ext, (r0 + 1, c0), (r0 + 1 + m, c0 + k)), g10)
            g11 = jnp.where(mask, jax.lax.slice(ext, (r0 + 1, c0 + 1), (r0 + 1 + m, c0 + 1 + k)), g11)
            t += 1
    interior = s0 * (t0 * g00 + t1 * g10) + s1 * (t0 * g01 + t1 * g11)
    out = jnp.where(_interior_mask(d0, n), interior, d0)
    return _apply_bnd_local(b, out, n)


def _divergence_local(u, v, n, px, py):
    dt = u.dtype
    ue = _extend(u, px, py)
    ve = _extend(v, px, py)
    h = jnp.asarray(1.0, dt) / n
    d = (jnp.asarray(-0.5, dt) * h) * (
        (ue[1:-1, 2:] - ue[1:-1, :-2]) + (ve[2:, 1:-1] - ve[:-2, 1:-1])
    )
    x = jnp.where(_interior_mask(u, n), d, jnp.zeros_like(u))
    return _apply_bnd_local(0, x, n)


def _gradient_local(u, v, p, n, px, py):
    dt = u.dtype
    pe = _extend(p, px, py)
    h = jnp.asarray(1.0, dt) / n
    half = jnp.asarray(0.5, dt)
    un = u - (half * (pe[1:-1, 2:] - pe[1:-1, :-2])) / h
    vn = v - (half * (pe[2:, 1:-1] - pe[:-2, 1:-1])) / h
    mask = _interior_mask(u, n)
    u = jnp.where(mask, un, u)
    v = jnp.where(mask, vn, v)
    return _apply_bnd_local(1, u, n), _apply_bnd_local(2, v, n)


def _project_local(u, v, n, iters, px, py):
    div = _divergence_local(u, v, n, px, py)
    p = _diffuse_local(0, jnp.zeros_like(div), div, 1.0, 4.0, iters, n, px, py)
    return _gradient_local(u, v, p, n, px, py)


def _cheby_diffuse_local(b, x_init, rhs, alpha, beta, iters, rho,
                         n, px, py, fuse=8):
    """Chebyshev-accelerated sharded Jacobi solve — the multi-device twin of
    ``ops.chebyshev.cheby_diffuse`` with ``_diffuse_local``'s fused-sweep
    K-deep halo exchange.  The three-term recurrence
    ``x_{k+1} = w·S(x_k) + (1-w)·x_{k-1}`` reads x_{k-1} POINTWISE, so it
    adds one extra K-deep exchange per chunk (x_{k-1}'s halo) and nothing
    else: validity margins are identical to plain Jacobi (the older
    iterate is valid wherever the newer one is), and the combined interior
    re-derives its ghost ring exactly like the jnp spec (ghosts follow the
    mode-b rule of the CURRENT interior at every iterate)."""
    from ..ops.chebyshev import cheby_omegas

    dt = rhs.dtype
    a = jnp.asarray(alpha, dt)
    bt = jnp.asarray(beta, dt)
    one = jnp.asarray(1.0, dt)
    m, k = rhs.shape
    K = max(1, min(fuse, iters, (m - 2) // 2 if m > 4 else 1,
                   (k - 2) // 2 if k > 4 else 1))
    # w schedule: sweep 1 is plain (w=None), sweeps 2..iters use cheby_omegas.
    ws = [None] + [float(w) for w in cheby_omegas(rho, iters)]

    # rhs is chunk-invariant: exchange its K-deep halo once, not per chunk.
    rhs_ext = _extend_deep(rhs, px, py, K)

    def chunk(xm, x, ws_chunk):
        ext = _extend_deep(x, px, py, K)
        ext_m = _extend_deep(xm, px, py, K)
        gr, gc = _ext_coords(ext.shape, K)
        interior = (gr >= 1) & (gr <= n) & (gc >= 1) & (gc <= n)
        for w in ws_chunk:  # static unroll: schedule differs per sweep
            neigh = (
                (ext[1:-1, :-2] + ext[1:-1, 2:]) + ext[:-2, 1:-1]
            ) + ext[2:, 1:-1]
            new = (rhs_ext[1:-1, 1:-1] + a * neigh) / bt
            if w is not None:
                wc = jnp.asarray(w, dt)
                new = wc * new + (one - wc) * ext_m[1:-1, 1:-1]
            new = jnp.pad(new, 1)  # rim garbage, outside validity
            ext2 = jnp.where(interior, new, ext)
            ext2 = _apply_bnd_coords(b, ext2, n, gr, gc)
            ext_m, ext = ext, ext2
        return ext_m[K:-K, K:-K], ext[K:-K, K:-K]

    xm, x = x_init, x_init
    done = 0
    first = True
    while done < iters:
        s = min(K, iters - done)
        ws_chunk = ws[done:done + s]
        if first:
            # x_0 doubles as x_{-1}; sweep 1 ignores it (w=None).
            xm, x = chunk(x_init, x_init, ws_chunk)
            first = False
        else:
            xm, x = chunk(xm, x, ws_chunk)
        done += s
    return x


def _cheby_pressure_local(div, iters, rho, n, px, py):
    """Sharded Chebyshev Poisson solve (zero guess) — the multi-device twin
    of ``ops.chebyshev.cheby_pressure_solve``."""
    return _cheby_diffuse_local(0, jnp.zeros_like(div), div, 1.0, 4.0,
                                iters, rho, n, px, py)


# ---------------------------------------------------------------------------
# Sharded pressure solvers beyond Jacobi (multigrid / CG inside shard_map)
# ---------------------------------------------------------------------------


def _psum_all(x):
    return jax.lax.psum(x, ("x", "y"))


def _masked_dot(a, b, mask):
    """Global interior dot product: local partial sum + psum."""
    return _psum_all(jnp.sum(jnp.where(mask, a * b, 0.0)))


def _cg_local(div, iters: int, n: int, px: int, py: int):
    """Sharded conjugate gradient — the multi-device twin of
    ``ops.cg.cg_pressure_solve``: every iteration is one 1-halo A-apply
    (``ppermute``) plus two global dot products (``psum``), the textbook
    distributed-CG communication pattern.  Local blocks keep the padded
    layout; interior cells are selected by mask and the copy-BC ghost rule
    is re-derived locally before each stencil."""
    dt = div.dtype
    mask = _interior_mask(div, n)
    ncells = jnp.asarray(float(n) * float(n), dt)

    def apply_A(p):
        # Copy-BC ghosts folded into the operator (cg.py:_apply_A_bc):
        # refresh the ghost ring, then the 5-point stencil on the interior.
        p = _apply_bnd_local(0, p, n)
        ext = _extend(p, px, py)
        neigh = (
            (ext[1:-1, :-2] + ext[1:-1, 2:]) + ext[:-2, 1:-1]
        ) + ext[2:, 1:-1]
        return jnp.where(mask, 4.0 * p - neigh, jnp.zeros_like(p))

    # Deflate the RHS mean (A's nullspace is constants; see ops/cg.py).
    b = jnp.where(mask, div, 0.0)
    mean = _psum_all(jnp.sum(b)) / ncells
    b = jnp.where(mask, b - mean, 0.0)

    x = jnp.zeros_like(b)
    r = b
    p = r
    rs = _masked_dot(r, r, mask)
    eps = jnp.asarray(1e-30, dt)

    def body(_, carry):
        x, r, p, rs = carry
        Ap = apply_A(p)
        alpha = rs / (_masked_dot(p, Ap, mask) + eps)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = _masked_dot(r, r, mask)
        beta = rs_new / (rs + eps)
        p = jnp.where(mask, r + beta * p, 0.0)
        return x, r, p, rs_new

    x, _, _, _ = jax.lax.fori_loop(0, iters, body, (x, r, p, rs))
    return _apply_bnd_local(0, x, n)


def _mg_smooth_local(p, div, sweeps: int, n: int, px: int, py: int):
    """Damped-Jacobi smoothing (``ops.multigrid._smooth``) on local blocks,
    one 1-halo exchange per sweep."""
    from ..ops.multigrid import _OMEGA  # single source for the damping weight

    dt = p.dtype
    w = jnp.asarray(_OMEGA, dt)
    one_m_w = jnp.asarray(1.0 - _OMEGA, dt)
    quarter = jnp.asarray(0.25, dt)
    mask = _interior_mask(p, n)

    def body(_, p):
        ext = _extend(p, px, py)
        neigh = (
            (ext[1:-1, :-2] + ext[1:-1, 2:]) + ext[:-2, 1:-1]
        ) + ext[2:, 1:-1]
        new = one_m_w * p + w * ((div + neigh) * quarter)
        return _apply_bnd_local(0, jnp.where(mask, new, p), n)

    return jax.lax.fori_loop(0, sweeps, body, p)


def _mg_local(div, cycles: int, n: int, px: int, py: int,
              pre: int = 2, post: int = 2):
    """Sharded multigrid V-cycles — fine level distributed, coarse levels
    replicated.

    The fine level (the O(n²) work) runs on local blocks: damped-Jacobi
    smoothing and the residual exchange 1-deep halos.  Restriction is
    scatter-free: full-weighting coarse values are *sums* of the four fine
    children (``ops.multigrid._restrict``'s ``4 * mean``), so each shard
    reduces its own 2x2 groups (pair-aligned by one leading pad row/col —
    shard origins are even) into a zero global coarse grid and a single
    ``psum`` assembles it, replicated, on every device.  All coarser levels
    (≤ 1/4 the cells) then reuse the single-grid ``ops.multigrid.v_cycle``
    verbatim on the replicated grid; the prolonged correction is sliced
    back to local blocks.  Traffic per cycle: (pre+post) 1-halo
    exchanges + one coarse-grid psum — the standard distributed-MG shape.

    Requires even local block sizes (shard origins stay pair-aligned),
    checked by the caller.
    """
    from ..ops import multigrid as mg
    from ..ops.boundary import embed_interior

    levels = mg.mg_levels(n)
    m, k = div.shape
    mask = _interior_mask(div, n)
    div_m = jnp.where(mask, div, 0.0)
    nc = n // 2

    def v_cycle_local(p):
        p = _mg_smooth_local(p, div_m, pre, n, px, py)
        if levels == 0:
            return _mg_smooth_local(p, div_m, 40, n, px, py)
        # Residual, locally (copy-BC ghosts via the local bnd rule).
        ext = _extend(_apply_bnd_local(0, p, n), px, py)
        neigh = (
            (ext[1:-1, :-2] + ext[1:-1, 2:]) + ext[:-2, 1:-1]
        ) + ext[2:, 1:-1]
        r = jnp.where(mask, div_m - (4.0 * p - neigh), 0.0)
        # Restriction: pair-aligned 2x2 sums, psum-assembled (replicated).
        rp = jnp.pad(r, ((1, 1), (1, 1)))
        coarse = rp.reshape((m + 2) // 2, 2, (k + 2) // 2, 2).sum((1, 3))
        full = jnp.zeros((nc + 2, nc + 2), div.dtype)
        r0c = jax.lax.axis_index("x") * (m // 2)
        c0c = jax.lax.axis_index("y") * (k // 2)
        full = jax.lax.dynamic_update_slice(full, coarse, (r0c, c0c))
        r_c = _psum_all(full)
        r_c = embed_interior(0, r_c[1:-1, 1:-1])
        # Coarse solve + prolongation: replicated single-grid code.
        e_c = mg.v_cycle(jnp.zeros_like(r_c), r_c, levels - 1, pre, post)
        e_fine = mg._prolong(e_c)
        r0 = jax.lax.axis_index("x") * m
        c0 = jax.lax.axis_index("y") * k
        e_loc = jax.lax.dynamic_slice(e_fine, (r0, c0), (m, k))
        p = _apply_bnd_local(0, jnp.where(mask, p + e_loc, p), n)
        return _mg_smooth_local(p, div_m, post, n, px, py)

    p = jnp.zeros_like(div)
    for _ in range(cycles):
        p = v_cycle_local(p)
    return p


def _make_project_local(cfg: SimConfig, px: int, py: int):
    """Sharded analogue of ``models.stable_fluids_2d._make_project``:
    divergence/gradient stay local stencils; the solve dispatches on
    ``cfg.pressure_solver``."""
    n, it = cfg.n, cfg.jacobi_iters
    if cfg.pressure_solver == "multigrid":
        side = n + 2
        if (side // px) % 2 or (side // py) % 2:
            raise ValueError(
                "sharded multigrid needs even local block sizes "
                f"((n+2)/px and (n+2)/py even); got "
                f"({side // px}, {side // py})"
            )

        def solve(div):
            return _mg_local(div, cfg.mg_cycles, n, px, py)
    elif cfg.pressure_solver == "cg":
        def solve(div):
            return _cg_local(div, cfg.cg_iters, n, px, py)
    elif cfg.pressure_solver == "chebyshev":
        def solve(div):
            return _cheby_pressure_local(div, cfg.press_cheby_iters,
                                         cfg.cheby_rho, n, px, py)
    else:
        def solve(div):
            return _diffuse_local(0, jnp.zeros_like(div), div, 1.0, 4.0,
                                  it, n, px, py)

    def project(u, v):
        div = _divergence_local(u, v, n, px, py)
        p = solve(div)
        return _gradient_local(u, v, p, n, px, py)

    return project


# ---------------------------------------------------------------------------
# Step composition (local blocks) — mirrors models/stable_fluids_2d.py
# ---------------------------------------------------------------------------


def _disp_global(u, v, dt0):
    """Max backtrace displacement (cells) across ALL shards — the
    ``psum``-class diagnostic SURVEY §5 calls for, here a ``pmax``."""
    local = jnp.maximum(jnp.abs(u).max(), jnp.abs(v).max()) * dt0
    return jax.lax.pmax(local, ("x", "y"))


def _step_local(cfg: SimConfig, px: int, py: int, advect_mode: str,
                audited: bool, state: FluidState, src: Sources):
    n, dtim = cfg.n, cfg.dt
    it = cfg.jacobi_iters
    dt_c = jnp.asarray(dtim, state.u.dtype)

    if advect_mode == "windowed":
        def _advect(b, d0, uu, vv):
            return _advect_local_windowed(
                b, d0, uu, vv, dtim, n, px, py, cfg.max_courant
            )
    else:
        def _advect(b, d0, uu, vv):
            return _advect_local(b, d0, uu, vv, dtim, n, px, py)

    def _diffusion(b, src_f, rhs, alpha, beta, dens=False):
        # Mirrors models.stable_fluids_2d._diffusion_args: "chebyshev"
        # accelerates all three solves, "chebyshev-dens" only the density
        # one (velocity path stays bit-parity Jacobi).
        mode = cfg.diffusion_solver
        if mode == "chebyshev" or (dens and mode == "chebyshev-dens"):
            k = cfg.cheby_dens_iters if mode == "chebyshev-dens" \
                else cfg.cheby_iters
            return _cheby_diffuse_local(b, src_f, rhs, alpha, beta, k,
                                        cfg.cheby_rho, n, px, py)
        return _diffuse_local(b, src_f, rhs, alpha, beta, it, n, px, py)

    project = _make_project_local(cfg, px, py)
    u = state.u + dt_c * src.u
    v = state.v + dt_c * src.v
    alpha = cfg.diffusion_alpha_visc
    beta = 1.0 + 4.0 * alpha
    u = _diffusion(1, src.u, u, alpha, beta)
    v = _diffusion(2, src.v, v, alpha, beta)
    u, v = project(u, v)
    d_vel = _disp_global(u, v, dtim * n) if audited else None
    u0, v0 = u, v
    u = _advect(1, u0, u0, v0)
    v = _advect(2, v0, u0, v0)
    u, v = project(u, v)
    d_dens = _disp_global(u, v, dtim * n) if audited else None

    dens = state.dens + dt_c * src.dens
    alpha = cfg.diffusion_alpha_diff
    beta = 1.0 + 4.0 * alpha
    dens = _diffusion(0, src.dens, dens, alpha, beta, dens=True)
    dens = _advect(0, dens, u, v)
    out = FluidState(dens=dens, u=u, v=v)
    if audited:
        return out, jnp.maximum(d_vel, d_dens)
    return out


def make_sharded_step_fn(
    cfg: SimConfig, mesh: Mesh, *, advect_mode: str = "auto",
    audited: bool = False,
) -> Callable[[FluidState, Sources], FluidState]:
    """A jitted multi-device step.  Inputs/outputs are global padded grids
    sharded ``P("x", "y")`` over ``mesh``; requires ``(n+2)`` divisible by
    both mesh dimensions (pick n = multiple-of-mesh minus 2, like the
    reference's ``N = 2^13 - 2``, ``FluidSequential.c:6``).  Each shard runs
    the plain jnp local ops.

    ``advect_mode``: "windowed" exchanges a ``max_courant``-deep halo per
    advection (``ops.advect_windowed`` semantics — neighbor-only traffic,
    the scalable default); "exact" all-gathers the advected field
    (reference semantics for ANY displacement, at O(grid) collective
    traffic per advection — a correctness mode, not a scale mode).  "auto"
    (default) picks windowed whenever every shard can host the
    ``max_courant+1``-deep halo, exact otherwise (tiny shards).

    ``audited=True`` returns ``(state, max_displacement)`` per step — the
    multi-device twin of ``models.stable_fluids_2d.step_audited`` (local
    max reduced with ``lax.pmax`` across the mesh), so sharded bench/datagen
    can assert the exact-gather regime (``ops/advect.py`` condition:
    displacement < ``max_courant``) exactly like the single-device path.

    The returned callable carries ``.advect_mode`` (the mode selected),
    ``.mesh``, and ``.backend`` / ``.backend_reason`` as the single-device
    step does: the shards never take the Jacobi kernel, so ``auto``
    declines it and ``hopper`` raises.
    """
    if advect_mode not in ("auto", "exact", "windowed"):
        raise ValueError(f"unknown advect_mode {advect_mode!r}")
    backend, reason = resolve_backend(cfg, SHARDED_PLAIN)
    px, py = mesh.shape["x"], mesh.shape["y"]
    side = cfg.n + 2
    if side % px or side % py:
        raise ValueError(
            f"grid side {side} not divisible by mesh shape ({px}, {py})"
        )
    if advect_mode == "auto":
        K_auto = cfg.max_courant + 1
        advect_mode = (
            "windowed" if side // px >= K_auto and side // py >= K_auto
            else "exact"
        )
    if advect_mode == "windowed":
        # _advect_local_windowed exchanges (max_courant+1)-deep halos; a
        # shard must own at least that many rows/cols or the x[-K:] slices
        # silently shorten and fail at trace time with an opaque shape error.
        K = cfg.max_courant + 1
        if side // px < K or side // py < K:
            raise ValueError(
                f"windowed advection needs >= {K} rows/cols per shard "
                f"(max_courant={cfg.max_courant}); got "
                f"({side // px}, {side // py}) on mesh ({px}, {py}). "
                f"Use advect_mode='exact' or a coarser mesh."
            )

    if cfg.pressure_solver == "multigrid":
        # Restriction pair-alignment needs even local blocks.
        mloc, kloc = side // px, side // py
        if (mloc % 2) or (kloc % 2):
            raise ValueError(
                "sharded multigrid needs even local block sizes "
                f"((n+2)/px and (n+2)/py even); got ({mloc}, {kloc}) "
                f"on mesh ({px}, {py})"
            )

    spec = P("x", "y")
    state_specs = FluidState(dens=spec, u=spec, v=spec, w=None)
    src_specs = Sources(dens=spec, u=spec, v=spec, w=None)
    out_specs = (state_specs, P()) if audited else state_specs

    local = functools.partial(_step_local, cfg, px, py, advect_mode, audited)
    jitted = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(state_specs, src_specs),
        out_specs=out_specs,
    ))

    def step_fn(state, src):
        return jitted(state, src)

    step_fn.advect_mode = advect_mode
    step_fn.mesh = mesh
    step_fn.backend, step_fn.backend_reason = backend, reason
    return step_fn


def shard_state(tree, mesh: Mesh):
    """Device-put a state/sources pytree with the grid sharding."""
    sh = NamedSharding(mesh, P("x", "y"))
    return jax.tree.map(
        lambda a: jax.device_put(a, sh) if a is not None else None, tree
    )
