"""Sharded 3-D (z-slab) step vs the unsharded 3-D model.

Runs on the 8-virtual-device CPU mesh (conftest).  The sharded local ops
evaluate the same per-cell jnp expressions as ``ops/three_d.py``, so parity
is exact (bit-level) — any drift means a halo/boundary seam bug.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fluidsimulationcuda_tpu.core.config import SimConfig
from fluidsimulationcuda_tpu.core.state import reference_init
from fluidsimulationcuda_tpu.models.stable_fluids_3d import step3, step_audited3
from fluidsimulationcuda_tpu.parallel.mesh import make_mesh
from fluidsimulationcuda_tpu.parallel.sharded3d import (
    make_sharded_step_fn_3d,
    shard_state_3d,
)


def _mesh(n_dev):
    return make_mesh(jax.devices()[:n_dev])


def _cfg(**kw):
    kw.setdefault("n", 30)
    kw.setdefault("ndim", 3)
    kw.setdefault("jacobi_iters", 4)
    kw.setdefault("max_courant", 2)
    return SimConfig(**kw)


def _run_pair(cfg, mesh, steps=2, advect_mode="exact", audited=False):
    """(unsharded final state, sharded final state[, displacements])."""
    state, src = reference_init(jax.random.key(7), cfg)

    ref = state
    for _ in range(steps):
        ref = step3(cfg, ref, src)

    sh_step = make_sharded_step_fn_3d(
        cfg, mesh, advect_mode=advect_mode, audited=audited
    )
    sh = shard_state_3d(state, mesh)
    ssrc = shard_state_3d(src, mesh)
    disps = []
    for _ in range(steps):
        if audited:
            sh, d = sh_step(sh, ssrc)
            disps.append(float(d))
        else:
            sh = sh_step(sh, ssrc)
    return ref, sh, disps


@pytest.mark.slow
def test_exact_mode_parity_small():
    # Quick-tier seam check: 16^3 on 8 shards = 2 planes per shard, the
    # minimum legal slab — every z seam and both wall shards exercised.
    cfg = _cfg(n=14)
    ref, sh, _ = _run_pair(cfg, _mesh(8), steps=1, advect_mode="exact")
    for f in ("dens", "u", "v", "w"):
        np.testing.assert_allclose(
            np.asarray(getattr(sh, f)), np.asarray(getattr(ref, f)),
            rtol=0, atol=1e-6, err_msg=f
        )


@pytest.mark.slow
@pytest.mark.parametrize("n_dev", [8, 4])
def test_exact_mode_parity(n_dev):
    cfg = _cfg()
    mesh = _mesh(n_dev)
    ref, sh, _ = _run_pair(cfg, mesh, steps=2, advect_mode="exact")
    for f in ("dens", "u", "v", "w"):
        np.testing.assert_allclose(
            np.asarray(getattr(sh, f)), np.asarray(getattr(ref, f)),
            rtol=0, atol=1e-6, err_msg=f
        )


@pytest.mark.slow
def test_windowed_mode_parity():
    # reference_init velocities are <= 0.99; displacement 0.99*dt*n ~ 0.48
    # cells < cmax=2, so the window clamp is a no-op and windowed == exact.
    cfg = _cfg()
    mesh = _mesh(8)
    ref, sh, _ = _run_pair(cfg, mesh, steps=2, advect_mode="windowed")
    for f in ("dens", "u", "v", "w"):
        np.testing.assert_allclose(
            np.asarray(getattr(sh, f)), np.asarray(getattr(ref, f)),
            rtol=0, atol=1e-6, err_msg=f
        )


@pytest.mark.slow
def test_audited_displacement_matches_unsharded():
    # cmax=1 keeps the quick tier fast (27-term gather); reference_init
    # displacement ~0.48 cells stays inside the +-1 window.
    cfg = _cfg(n=14, max_courant=1)
    mesh = _mesh(4)
    state, src = reference_init(jax.random.key(7), cfg)
    _, d_ref = step_audited3(cfg, state, src)
    _, sh, disps = _run_pair(cfg, mesh, steps=1, advect_mode="windowed",
                             audited=True)
    assert disps[0] == pytest.approx(float(d_ref), rel=1e-5)
    assert disps[0] < cfg.max_courant  # provably exact regime


def test_auto_picks_windowed_when_slabs_fit():
    cfg = _cfg()
    step_fn = make_sharded_step_fn_3d(cfg, _mesh(8))
    assert step_fn.advect_mode == "windowed"
    # 32/8 = 4 planes per shard < cmax+1 = 6 -> falls back to exact.
    step_fn = make_sharded_step_fn_3d(cfg.replace(max_courant=5), _mesh(8))
    assert step_fn.advect_mode == "exact"


def test_validation_errors():
    with pytest.raises(ValueError, match="ndim == 3"):
        make_sharded_step_fn_3d(SimConfig(n=30), _mesh(8))
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_step_fn_3d(_cfg(n=31), _mesh(8))
    with pytest.raises(ValueError, match="jacobi"):
        make_sharded_step_fn_3d(
            _cfg(pressure_solver="cg"), _mesh(8)
        )
    with pytest.raises(ValueError, match="planes per shard"):
        make_sharded_step_fn_3d(
            _cfg(max_courant=5), _mesh(8), advect_mode="windowed"
        )


@pytest.mark.slow
@pytest.mark.parametrize("dsolver", ["chebyshev", "chebyshev-dens"])
def test_sharded_3d_compensated_matches_unsharded(dsolver):
    """3-D compensated mode (velocity+dens Chebyshev, compensated
    pressure) through the jnp z-slab path vs the unsharded model — the
    chunked chain (both iterates halo-exchanged per segment,
    ``_cheby_diffuse3_local``) must land the same trajectory.  The
    chebyshev-dens case pins cheby_dens_iters != cheby_iters so an
    iteration-count mix-up in the sharded dens dispatch breaks parity."""
    cfg = _cfg(pressure_solver="chebyshev", diffusion_solver=dsolver,
               cheby_rho=0.85, cheby_iters=5, cheby_press_iters=6,
               cheby_dens_iters=4)
    ref, sh, _ = _run_pair(cfg, _mesh(8), steps=2, advect_mode="windowed")
    for f in ("dens", "u", "v", "w"):
        np.testing.assert_allclose(
            np.asarray(getattr(sh, f)), np.asarray(getattr(ref, f)),
            rtol=0, atol=1e-6, err_msg=f
        )


@pytest.mark.slow
def test_sharded_3d_cheby_chunked_chain_matches_one_shot():
    """The chunk seams of the sharded chain must be invisible: 2 planes
    per shard forces 1-sweep segments (K=1, maximum chaining), and the
    result must still match the unsharded (single-recurrence) solver."""
    cfg = _cfg(n=14, max_courant=1, pressure_solver="chebyshev",
               cheby_iters=6, cheby_rho=0.9)
    ref, sh, _ = _run_pair(cfg, _mesh(8), steps=1, advect_mode="windowed")
    for f in ("dens", "u", "v", "w"):
        np.testing.assert_allclose(
            np.asarray(getattr(sh, f)), np.asarray(getattr(ref, f)),
            rtol=0, atol=1e-6, err_msg=f
        )


@pytest.mark.slow
def test_output_stays_sharded():
    cfg = _cfg(n=14)
    mesh = _mesh(8)
    state, src = reference_init(jax.random.key(3), cfg)
    step_fn = make_sharded_step_fn_3d(cfg, mesh, advect_mode="exact")
    out = step_fn(shard_state_3d(state, mesh), shard_state_3d(src, mesh))
    assert len(out.dens.sharding.device_set) == 8
