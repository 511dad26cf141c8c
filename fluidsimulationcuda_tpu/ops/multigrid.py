"""Geometric multigrid pressure solver — the reference's future work.

The reference concludes that its Jacobi pressure solve is the bottleneck and
names conjugate gradient / multigrid as future work (``document/main.tex:356``).
This module implements that roadmap item: a V-cycle for the discrete Poisson
problem the projection solves,

    A p = div,   A p := 4 p - (pL + pR + pU + pD)    (unit index spacing),

with the solver's copy (Neumann-like) boundary rule on every level.  It is an
*optional alternative* to the parity-exact Jacobi solver
(``SimConfig.pressure_solver = "multigrid"``): convergence is mesh-independent
(a few V-cycles) instead of O(n²) sweeps, at the cost of departing from the
reference's numerics.

Components: damped-Jacobi smoothing, full-weighting restriction (×4 rhs
scaling for the coarse operator), bilinear prolongation, recursive coarsening
while the interior size stays even, ~40 Jacobi sweeps on the coarsest level.
Pure jnp — runs on every backend and under ``shard_map``-free single-device
jit; n must be even down to the coarsest level used.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .boundary import embed_interior

__all__ = ["v_cycle", "mg_pressure_solve", "mg_levels", "residual"]


def _apply_A(p: jnp.ndarray) -> jnp.ndarray:
    """Interior application of A = 4I - N."""
    return 4.0 * p[1:-1, 1:-1] - (
        (p[1:-1, :-2] + p[1:-1, 2:]) + p[:-2, 1:-1] + p[2:, 1:-1]
    )


def residual(p: jnp.ndarray, div: jnp.ndarray) -> jnp.ndarray:
    """r = div - A p on the interior, ghost ring via copy BC."""
    return embed_interior(0, div[1:-1, 1:-1] - _apply_A(p))


_OMEGA = 0.8  # damped Jacobi: plain Jacobi leaves the checkerboard mode
#               undamped (amplification -1) and is not a smoother.


def _smooth(p: jnp.ndarray, div: jnp.ndarray, sweeps: int) -> jnp.ndarray:
    """Damped-Jacobi smoothing: p <- (1-w) p + w (div + N p) / 4."""
    rhs = div[1:-1, 1:-1]
    w = jnp.asarray(_OMEGA, p.dtype)
    one_m_w = jnp.asarray(1.0 - _OMEGA, p.dtype)

    def body(_, p):
        neigh = (p[1:-1, :-2] + p[1:-1, 2:]) + p[:-2, 1:-1] + p[2:, 1:-1]
        new = one_m_w * p[1:-1, 1:-1] + w * ((rhs + neigh) * 0.25)
        return embed_interior(0, new)

    return jax.lax.fori_loop(0, sweeps, body, p)


def _restrict(r: jnp.ndarray) -> jnp.ndarray:
    """Full-weighting 2x restriction of a padded field (interior n -> n/2),
    scaled by 4 so the same unit-spacing stencil discretizes the coarse
    operator ((h_H/h_h)^2 = 4)."""
    rin = r[1:-1, 1:-1]
    n = rin.shape[0]
    coarse = rin.reshape(n // 2, 2, n // 2, 2).mean(axis=(1, 3))
    return embed_interior(0, 4.0 * coarse)


def _interleave(a: jnp.ndarray, b: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Alternate a and b along ``axis`` (a first) — a pure stack+reshape,
    no scatter."""
    stacked = jnp.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return stacked.reshape(shape)


def _prolong(e: jnp.ndarray) -> jnp.ndarray:
    """Bilinear prolongation of a padded coarse correction to the fine grid
    (cell-centered 2x refinement: weights 9/3/3/1 over the padded coarse
    field, which the copy BC makes well-defined at the walls).

    Scatter-free: the four fine parities are computed as whole coarse-grid
    arrays and interleaved with stack+reshape."""
    ec = e  # padded (nc+2, nc+2)
    c = ec[1:-1, 1:-1]
    up = ec[0:-2, 1:-1]
    down = ec[2:, 1:-1]
    left = ec[1:-1, 0:-2]
    right = ec[1:-1, 2:]
    ul = ec[0:-2, 0:-2]
    ur = ec[0:-2, 2:]
    dl = ec[2:, 0:-2]
    dr = ec[2:, 2:]
    # Fine cell parity (pi, pj) inside coarse cell: vertical neighbor is
    # up for pi=0 / down for pi=1; horizontal left/right likewise.
    f00 = 9.0 * c + 3.0 * up + 3.0 * left + ul
    f01 = 9.0 * c + 3.0 * up + 3.0 * right + ur
    f10 = 9.0 * c + 3.0 * down + 3.0 * left + dl
    f11 = 9.0 * c + 3.0 * down + 3.0 * right + dr
    top = _interleave(f00, f01, axis=1)
    bot = _interleave(f10, f11, axis=1)
    fine = _interleave(top, bot, axis=0) * (1.0 / 16.0)
    return embed_interior(0, fine)


def mg_levels(n: int, min_n: int = 8) -> int:
    """How many times the interior can be halved (while even and > min_n)."""
    lv = 0
    while n % 2 == 0 and n // 2 >= min_n:
        n //= 2
        lv += 1
    return lv


def v_cycle(p, div, level: int, pre: int = 2, post: int = 2,
            coarse_sweeps: int = 40):
    p = _smooth(p, div, pre)
    if level == 0:
        return _smooth(p, div, coarse_sweeps)
    r = residual(p, div)
    r_c = _restrict(r)
    e_c = v_cycle(jnp.zeros_like(r_c), r_c, level - 1, pre, post,
                  coarse_sweeps)
    p = embed_interior(0, p[1:-1, 1:-1] + _prolong(e_c)[1:-1, 1:-1])
    return _smooth(p, div, post)


def mg_pressure_solve(div: jnp.ndarray, cycles: int = 2, *, pre: int = 2,
                      post: int = 2) -> jnp.ndarray:
    """Multigrid Poisson solve from a zero initial guess (drop-in for
    ``ops.pressure_solve``)."""
    n = div.shape[0] - 2
    levels = mg_levels(n)
    p = jnp.zeros_like(div)
    for _ in range(cycles):
        p = v_cycle(p, div, levels, pre, post)
    return p


# ---------------------------------------------------------------------------
# Fast path: separable matmul transfers + graded hierarchy
# ---------------------------------------------------------------------------
#
# The fast path applies SEPARABLE transfer matrices on both axes with
# matmuls: dense banded (n_f × n_c) interpolation matrices instead of
# stride-2 / interleave shuffles.  The matrices also absorb grid grading:
# each coarse side is the fine side halved then rounded DOWN to a multiple
# of 8, e.g. 2048 → 1024 → 512 → 256 → 128 sides at n=2046, with
# mildly-graded coarsening ratios (~2.002) standard mg theory tolerates.


def _coarse_side(side: int) -> int:
    """Next level's padded side: halve, round down to a multiple of 8,
    floor at 16."""
    half = side // 2
    return max(16, half - half % 8)


@functools.lru_cache(maxsize=None)
def _transfer_1d(nf: int, nc: int):
    """1-D cell-centered transfer pair for interior sizes ``nf -> nc``:
    ``P`` (nf, nc) linear prolongation (each fine center interpolates its
    two bracketing coarse centers, constant extrapolation at the walls —
    the copy-BC-compatible choice), ``R`` (nc, nf) row-normalized ``P^T``
    full-weighting restriction.  NumPy constants folded by XLA."""
    import numpy as np

    t = (np.arange(nf) + 0.5) * (nc / nf) - 0.5  # fine centers, coarse units
    j0 = np.clip(np.floor(t).astype(np.int64), 0, nc - 1)
    j1 = np.minimum(j0 + 1, nc - 1)
    w1 = np.clip(t - j0, 0.0, 1.0)
    P = np.zeros((nf, nc), np.float32)
    np.add.at(P, (np.arange(nf), j0), 1.0 - w1)
    np.add.at(P, (np.arange(nf), j1), w1)
    R = np.ascontiguousarray(P.T)
    R /= R.sum(axis=1, keepdims=True)
    return P, R


# Full float32 products.  A GPU runs a float32 matmul at DEFAULT precision
# in TF32 (about three decimal digits); rounding the prolongated correction
# that coarsely injects broadband error the post-smooth only partly damps.
# The transfers are a small share of a V-cycle, so they keep float32 and
# the solve's quality does not depend on the device.
_TRANSFER_PRECISION = jax.lax.Precision.HIGHEST


def _restrict_mat(r: jnp.ndarray, nc: int) -> jnp.ndarray:
    """Restriction r (padded, interior nf) -> coarse rhs (padded, interior
    nc) via the separable matrices, rhs scaled by the coarsening ratio²
    (the (h_H/h_h)² factor that keeps the unit-spacing stencil)."""
    rin = r[1:-1, 1:-1]
    nf = rin.shape[0]
    _, R = _transfer_1d(nf, nc)
    Rm = jnp.asarray(R)
    tmp = jnp.matmul(Rm, rin, precision=_TRANSFER_PRECISION)
    rc = jnp.matmul(tmp, Rm.T, precision=_TRANSFER_PRECISION)
    return embed_interior(0, ((nf / nc) ** 2) * rc)


def _prolong_mat(e: jnp.ndarray, nf: int) -> jnp.ndarray:
    """Bilinear prolongation of a padded coarse correction to interior
    size ``nf`` via the separable matrices."""
    ein = e[1:-1, 1:-1]
    P, _ = _transfer_1d(nf, ein.shape[0])
    Pm = jnp.asarray(P)
    tmp = jnp.matmul(Pm, ein, precision=_TRANSFER_PRECISION)
    ef = jnp.matmul(tmp, Pm.T, precision=_TRANSFER_PRECISION)
    return embed_interior(0, ef)


def mg_pressure_solve_fast(div: jnp.ndarray, cycles: int = 2, *,
                           pre: int = 2, post: int = 2,
                           min_n: int = 16) -> jnp.ndarray:
    """V-cycles with the separable matmul transfers and a graded hierarchy
    (every coarse side a multiple of 8, see ``_coarse_side``).  Same
    damped-Jacobi smoothing components as ``v_cycle``; non-parity numerics
    (mg is an opt-in solver, quality judged by residual)."""

    def smooth(p, d, sweeps, zero_init=False):
        if zero_init:
            p = jnp.zeros_like(d)
        return _smooth(p, d, sweeps)

    def cycle(p, d, zero_init=False):
        n = d.shape[0] - 2
        if n < min_n:
            return smooth(p, d, 40, zero_init=zero_init)
        nc = _coarse_side(n + 2) - 2
        p = smooth(p, d, pre, zero_init=zero_init)
        r = residual(p, d)
        r_c = _restrict_mat(r, nc)
        e_c = cycle(jnp.zeros_like(r_c), r_c, zero_init=True)
        e_f = _prolong_mat(e_c, n)
        p = embed_interior(0, p[1:-1, 1:-1] + e_f[1:-1, 1:-1])
        return smooth(p, d, post)

    p = jnp.zeros_like(div)
    for k in range(cycles):
        p = cycle(p, div, zero_init=(k == 0))
    return p
