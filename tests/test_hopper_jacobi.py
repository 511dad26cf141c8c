"""The fused Jacobi kernel (``kernels/hopper_jacobi.py``,
``csrc/jacobi_hopper.cu``).

CUDA has no interpret mode, so the CPU tier checks everything around the
launch against the plain solves (``ops.diffuse`` / ``ops.chebyshev``): the
launch plan, the Chebyshev weights, the carry of ``x_{k-1}`` across
launches, and — through a NumPy model of one launch's block decomposition
— the halo depth, the tiles that do not divide the grid and the ghost rule
applied at the grid edge.  The ``gpu`` tests run the compiled kernel
against the same plain solves on the card.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fluidsimulationcuda_tpu.kernels import hopper_jacobi as hj
from fluidsimulationcuda_tpu.ops.chebyshev import (
    cheby_diffuse, cheby_omegas, cheby_pressure_solve,
)
from fluidsimulationcuda_tpu.ops.diffuse import diffuse
from fluidsimulationcuda_tpu.ops.project import pressure_solve


def _grid(seed, side, scale=1.0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(-scale, scale, (side, side))
                       .astype(np.float32))


def _plain(b, x, rhs, alpha, beta, iters, rho):
    if rho is None:
        return diffuse(b, x, rhs, alpha, beta, iters)
    return cheby_diffuse(b, x, rhs, alpha, beta, iters, rho)


# ---------------------------------------------------------------------------
# Launch plan and weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("iters,max_sweeps,plan", [
    (1, 8, (1,)),
    (8, 8, (8,)),
    (9, 8, (5, 4)),
    (20, 8, (7, 7, 6)),
    (40, 8, (8, 8, 8, 8, 8)),
    (14, 16, (14,)),
    (7, 3, (3, 2, 2)),
])
def test_launch_plan(iters, max_sweeps, plan):
    got = hj.launch_plan(iters, max_sweeps)
    assert got == plan
    assert sum(got) == iters and max(got) - min(got) <= 1


@pytest.mark.parametrize("iters,max_sweeps", [(0, 8), (10, 0), (10, 17)])
def test_launch_plan_rejects(iters, max_sweeps):
    with pytest.raises(ValueError):
        hj.launch_plan(iters, max_sweeps)


def test_sweep_weights():
    assert hj.sweep_weights(5, None) == (1.0,) * 5
    ws = hj.sweep_weights(10, 0.95)
    assert len(ws) == 10 and ws[0] == 1.0
    assert ws[1:] == cheby_omegas(0.95, 10)


# ---------------------------------------------------------------------------
# The launch plan run through the plain specification of one launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [0, 1, 2])
@pytest.mark.parametrize("iters", [1, 7, 8, 9, 17])
def test_jacobi_chain_matches_diffuse(b, iters):
    """Launches of at most 8 sweeps chained through the plain launch equal
    one ``iters``-sweep solve, on both sides of the launch size."""
    x, rhs = _grid(1, 34), _grid(2, 34)
    got = hj.jacobi(b, x, rhs, 0.3, 2.2, iters, max_sweeps=8,
                    launch_fn=hj.reference_launch)
    want = diffuse(b, x, rhs, 0.3, 2.2, iters)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("b", [0, 1, 2])
@pytest.mark.parametrize("iters,max_sweeps", [(2, 8), (8, 8), (9, 4),
                                              (17, 6)])
def test_cheby_chain_matches_cheby_diffuse(b, iters, max_sweeps):
    """The three-term recurrence spans launches: ``x_{k-1}`` and the
    weight schedule carry across every launch boundary."""
    x, rhs = _grid(3, 34), _grid(4, 34)
    got = hj.jacobi(b, x, rhs, 0.3, 2.2, iters, cheby_rho=0.95,
                    max_sweeps=max_sweeps, launch_fn=hj.reference_launch)
    want = cheby_diffuse(b, x, rhs, 0.3, 2.2, iters, 0.95)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("rho", [None, 0.995])
def test_pressure_chain_from_zero_guess(rho):
    div = _grid(5, 34, scale=0.01)
    got = hj.jacobi(0, jnp.zeros_like(div), div, 1.0, 4.0, 11,
                    cheby_rho=rho, max_sweeps=4,
                    launch_fn=hj.reference_launch)
    want = (pressure_solve(div, 11) if rho is None
            else cheby_pressure_solve(div, 11, rho))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# NumPy model of one launch's block decomposition (csrc/jacobi_hopper.cu)
# ---------------------------------------------------------------------------


def _model_launch(b, x_in, xm_in, rhs, alpha, beta, weights, cheby, rows,
                  cols, halo=None):
    """What the kernel computes, block by block: each block loads a
    ``rows x cols`` region (its tile plus a halo of ``len(weights) + 1``),
    sweeps it in place of shared memory, re-derives the ghost cells that
    fall inside it after every sweep, and writes back its tile only."""
    x_in = np.asarray(x_in)
    rhs = np.asarray(rhs)
    xm_in = None if xm_in is None else np.asarray(xm_in)
    side = x_in.shape[0]
    last = side - 1
    halo = len(weights) + 1 if halo is None else halo
    tr, tc = rows - 2 * halo, cols - 2 * halo
    sx = np.float32(-1.0 if b == 1 else 1.0)
    sy = np.float32(-1.0 if b == 2 else 1.0)
    a, bt = np.float32(alpha), np.float32(beta)
    x_out = np.full_like(x_in, np.nan)
    xm_out = np.full_like(x_in, np.nan)
    ii, jj = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    for r0 in range(-halo, side - halo, tr):
        for c0 in range(-halo, side - halo, tc):
            gi, gj = r0 + ii, c0 + jj
            inside = (gi >= 0) & (gi <= last) & (gj >= 0) & (gj <= last)
            gic, gjc = np.clip(gi, 0, last), np.clip(gj, 0, last)
            cur = np.where(inside, x_in[gic, gjc], 0).astype(np.float32)
            nxt = (np.where(inside, xm_in[gic, gjc], 0).astype(np.float32)
                   if cheby else np.zeros_like(cur))
            upd = ((gi >= 1) & (gi < last) & (gj >= 1) & (gj < last)
                   & (ii >= 1) & (ii < rows - 1) & (jj >= 1) & (jj < cols - 1))
            rr = np.where(upd, rhs[gic, gjc], 0).astype(np.float32)
            row_e = inside & ((gi == 0) | (gi == last))
            col_e = inside & ((gj == 0) | (gj == last))
            mi = ii + (gi == 0) - (gi == last)
            mj = jj + (gj == 0) - (gj == last)
            ghost = ((row_e | col_e) & (mi >= 0) & (mi < rows) & (mj >= 0)
                     & (mj < cols))
            for w in weights:
                neigh = np.zeros_like(cur)
                neigh[1:-1, 1:-1] = (((cur[1:-1, :-2] + cur[1:-1, 2:])
                                      + cur[:-2, 1:-1]) + cur[2:, 1:-1])
                v = (rr + a * neigh) / bt
                if cheby:
                    w = np.float32(w)
                    v = w * v + (np.float32(1) - w) * nxt
                new = np.where(upd, v, cur).astype(np.float32)
                mirror = new[np.clip(mi, 0, rows - 1), np.clip(mj, 0, cols - 1)]
                g = np.where(row_e & col_e,
                             np.float32(0.5) * (sy * mirror + sx * mirror),
                             np.where(col_e, sx * mirror, sy * mirror))
                new = np.where(ghost, g, new).astype(np.float32)
                cur, nxt = new, cur
            tile = ((ii >= halo) & (ii < rows - halo) & (jj >= halo)
                    & (jj < cols - halo) & inside)
            x_out[gi[tile], gj[tile]] = cur[tile]
            xm_out[gi[tile], gj[tile]] = nxt[tile]
    assert not np.isnan(x_out).any(), "tiles must cover the grid"
    return jnp.asarray(x_out), (jnp.asarray(xm_out) if cheby else None)


@pytest.mark.parametrize("side,rows,cols,iters,max_sweeps,rho,b", [
    (37, 16, 32, 7, 3, None, 0),    # tiles do not divide the grid
    (37, 16, 32, 7, 3, 0.9, 1),
    (50, 16, 32, 12, 5, 0.95, 2),
    (21, 12, 16, 9, 2, None, 2),    # more launches than the tile is tall
    (64, 16, 32, 10, 4, 0.99, 0),
    (33, 16, 32, 5, 5, None, 1),    # one launch, deepest halo the tile takes
    (18, 16, 32, 6, 3, 0.8, 2),     # one block row covers the grid
])
def test_block_model_matches_plain_solve(side, rows, cols, iters,
                                         max_sweeps, rho, b):
    """A halo one cell deeper than the sweep count keeps every tile — and
    the ring around it that the ghost rule mirrors — exact."""
    x, rhs = _grid(6, side), _grid(7, side)
    launch = functools.partial(_model_launch, rows=rows, cols=cols)
    got = hj.jacobi(b, x, rhs, 0.3, 2.2, iters, cheby_rho=rho,
                    max_sweeps=max_sweeps, launch_fn=launch)
    want = _plain(b, x, rhs, 0.3, 2.2, iters, rho)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("b", [0, 1, 2])
def test_block_model_needs_the_extra_halo_ring(b):
    """With a halo of only ``sweeps`` cells, a ghost cell at a tile seam
    mirrors a cell that went stale in the last sweep: the model departs
    from the plain solve.  Pins why the kernel's halo is one deeper.  At
    side 31 a 10-row tile starts on the last grid row."""
    side, rows, cols, k = 31, 16, 32, 3
    x, rhs = _grid(8, side), _grid(9, side)
    ws = (1.0,) * k
    want = np.asarray(diffuse(b, x, rhs, 0.3, 2.2, k))
    exact, _ = _model_launch(b, x, None, rhs, 0.3, 2.2, ws, False, rows,
                             cols)
    np.testing.assert_allclose(np.asarray(exact), want, rtol=0, atol=1e-6)
    short, _ = _model_launch(b, x, None, rhs, 0.3, 2.2, ws, False, rows,
                             cols, halo=k)
    assert np.abs(np.asarray(short) - want).max() > 1e-3


# ---------------------------------------------------------------------------
# The compiled kernel on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("side", [37, 130, 1000])
@pytest.mark.parametrize("rho", [None, 0.95])
@pytest.mark.parametrize("b", [0, 1, 2])
def test_kernel_matches_plain_solve(gpu, side, rho, b):
    """float32 stencils summed in the reference's order; only FMA
    contraction can differ, and the Jacobi map is a contraction, so the
    difference stays at a few ulp of the field (|x| <= 1 here)."""
    x, rhs = _grid(10, side), _grid(11, side)
    got = jax.jit(lambda x, r: hj.jacobi(b, x, r, 0.3, 2.2, 20,
                                         cheby_rho=rho))(x, rhs)
    want = _plain(b, x, rhs, 0.3, 2.2, 20, rho)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=2e-6)


@pytest.mark.gpu
def test_kernel_batched_under_vmap(gpu):
    xs = jnp.stack([_grid(k, 130) for k in range(3)])
    got = jax.jit(jax.vmap(
        lambda x: hj.jacobi(1, x, x, 0.3, 2.2, 10, max_sweeps=4)))(xs)
    want = jax.vmap(lambda x: diffuse(1, x, x, 0.3, 2.2, 10))(xs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=2e-6)
