"""Multigrid fast path: scatter-free prolongation, graded hierarchy,
full-precision separable transfers."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fluidsimulationcuda_tpu.ops.multigrid import (
    _prolong,
    mg_pressure_solve,
    mg_pressure_solve_fast,
    residual,
)


def _prolong_reference(ec: np.ndarray) -> np.ndarray:
    """Literal 9/3/3/1 cell-centered prolongation, scalar loops."""
    nc = ec.shape[0] - 2
    nf = 2 * nc
    out = np.zeros((nf + 2, nf + 2), np.float32)
    for i in range(nf):
        for j in range(nf):
            a, b = i // 2 + 1, j // 2 + 1
            vi = a - 1 if i % 2 == 0 else a + 1
            vj = b - 1 if j % 2 == 0 else b + 1
            out[i + 1, j + 1] = (
                9 * ec[a, b] + 3 * ec[vi, b] + 3 * ec[a, vj] + ec[vi, vj]
            ) / 16.0
    # copy-BC ghost ring
    out[0, 1:-1] = out[1, 1:-1]
    out[-1, 1:-1] = out[-2, 1:-1]
    out[1:-1, 0] = out[1:-1, 1]
    out[1:-1, -1] = out[1:-1, -2]
    out[0, 0] = 0.5 * (out[0, 1] + out[1, 0])
    out[0, -1] = 0.5 * (out[0, -2] + out[1, -1])
    out[-1, 0] = 0.5 * (out[-1, 1] + out[-2, 0])
    out[-1, -1] = 0.5 * (out[-1, -2] + out[-2, -1])
    return out


def test_prolong_matches_scalar_reference():
    rng = np.random.default_rng(0)
    ec = rng.standard_normal((10, 10)).astype(np.float32)
    # well-defined ghosts (copy BC), as the caller guarantees
    from fluidsimulationcuda_tpu.ops.boundary import embed_interior

    ec = np.asarray(embed_interior(0, jnp.asarray(ec[1:-1, 1:-1])))
    got = np.asarray(_prolong(jnp.asarray(ec)))
    want = _prolong_reference(ec)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [126, 130])  # 130: odd 65 at level 2 -> pad
def test_fast_cycle_beats_jacobi20_residual(n):
    """The perf-mode bar (VERDICT round 2): post-solve residual of the fast
    mg cycle must be <= the 20-sweep Jacobi solve's on the same rhs.  Use a
    rough rhs (not near the f32 noise floor)."""
    from fluidsimulationcuda_tpu.ops.boundary import embed_interior
    from fluidsimulationcuda_tpu.ops.diffuse import diffuse

    rng = np.random.default_rng(3)
    div = embed_interior(
        0, jnp.asarray(rng.standard_normal((n, n)).astype(np.float32))
    )
    p20 = diffuse(0, jnp.zeros_like(div), div, 1.0, 4.0, 20)
    r20 = float(jnp.abs(residual(p20, div)[1:-1, 1:-1]).max())
    pmg = mg_pressure_solve_fast(div, cycles=2)
    rmg = float(jnp.abs(residual(pmg, div)[1:-1, 1:-1]).max())
    assert rmg <= r20, (rmg, r20)


def test_fast_residual_tracks_plain():
    """Fast and plain cycles share components but differ in coarsest-level
    schedule (plain adds pre-smooths at level 0) — exact equality is not
    expected; contraction quality must be comparable."""
    from fluidsimulationcuda_tpu.ops.boundary import embed_interior

    n = 128  # 128 -> 64 -> 32 -> 16, all even
    rng = np.random.default_rng(5)
    div = embed_interior(
        0, jnp.asarray(rng.standard_normal((n, n)).astype(np.float32))
    )
    a = mg_pressure_solve(div, cycles=1)
    b = mg_pressure_solve_fast(div, cycles=1)
    ra = float(jnp.abs(residual(a, div)[1:-1, 1:-1]).max())
    rb = float(jnp.abs(residual(b, div)[1:-1, 1:-1]).max())
    assert rb <= 2.0 * ra, (rb, ra)


@pytest.mark.parametrize("nf,nc", [(126, 62), (510, 254), (30, 14)])
def test_transfers_are_full_precision(nf, nc):
    """The separable transfers run at HIGHEST precision: a GPU would run
    a DEFAULT float32 matmul in TF32 (~1e-3 relative), which this bound
    rules out.  Against float64 products of the same matrices."""
    from fluidsimulationcuda_tpu.ops import multigrid
    from fluidsimulationcuda_tpu.ops.boundary import embed_interior
    from fluidsimulationcuda_tpu.ops.multigrid import (
        _prolong_mat, _restrict_mat, _transfer_1d,
    )

    assert multigrid._TRANSFER_PRECISION == jax.lax.Precision.HIGHEST

    rng = np.random.default_rng(nf)
    fine = rng.standard_normal((nf, nf)).astype(np.float32)
    coarse = rng.standard_normal((nc, nc)).astype(np.float32)
    P, R = _transfer_1d(nf, nc)
    P64, R64 = P.astype(np.float64), R.astype(np.float64)
    got_r = np.asarray(_restrict_mat(embed_interior(0, jnp.asarray(fine)),
                                     nc))[1:-1, 1:-1]
    want_r = (nf / nc) ** 2 * (R64 @ fine @ R64.T)
    np.testing.assert_allclose(got_r, want_r, rtol=0,
                               atol=1e-5 * np.abs(want_r).max())
    got_p = np.asarray(_prolong_mat(embed_interior(0, jnp.asarray(coarse)),
                                    nf))[1:-1, 1:-1]
    want_p = P64 @ coarse @ P64.T
    np.testing.assert_allclose(got_p, want_p, rtol=0,
                               atol=1e-5 * np.abs(want_p).max())
