"""Sharded steps against the single-device step, one lane per layout.

The multi-device paths users call (``make_sharded_step_fn``,
``make_sharded_step_fn_3d``) on the 8-device virtual CPU mesh (conftest):
a row mesh, a square 2-D mesh, a column-split mesh, and the 3-D z-slab
step with the compensated Chebyshev solvers.  Each shard runs the plain
local ops, so the lanes agree with the single-device step up to the FMA
contraction of separate compilations (~1e-6 on these O(1) fields).
``chip_smoke.py --four`` runs the same comparison at full size on four
cards.
"""
import jax
import numpy as np
import pytest

from fluidsimulationcuda_tpu import SimConfig, make_step_fn, reference_init
from fluidsimulationcuda_tpu.models.stable_fluids_3d import step3
from fluidsimulationcuda_tpu.parallel.mesh import make_mesh
from fluidsimulationcuda_tpu.parallel.sharded import (
    make_sharded_step_fn, shard_state,
)
from fluidsimulationcuda_tpu.parallel.sharded3d import (
    make_sharded_step_fn_3d, shard_state_3d,
)


def _check(got, want, names):
    for name in names:
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            rtol=0, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("shape,advect_mode", [
    (None, "auto"),        # make_mesh's default row layout, (8, 1)
    ((2, 4), "auto"),      # square-ish 2-D mesh
    ((1, 8), "windowed"),  # column slabs
    ((4, 1), "exact"),     # all-gather advection
])
def test_sharded_2d_lane_matches_single_device(shape, advect_mode):
    cfg = SimConfig(n=30, jacobi_iters=6, backend="reference",
                    max_courant=2)
    n_dev = 8 if shape is None else shape[0] * shape[1]
    mesh = make_mesh(jax.devices()[:n_dev], shape)
    state, sources = reference_init(jax.random.key(1), cfg)
    want = make_step_fn(cfg)(state, sources)
    step = make_sharded_step_fn(cfg, mesh, advect_mode=advect_mode,
                                audited=True)
    got, disp = step(shard_state(state, mesh), shard_state(sources, mesh))
    assert len(got.dens.sharding.device_set) == n_dev
    assert 0.0 < float(disp) < cfg.max_courant
    _check(got, want, ("dens", "u", "v"))


def test_sharded_3d_lane_cheby_matches_single_device():
    cfg = SimConfig(n=14, ndim=3, jacobi_iters=2, max_courant=1,
                    backend="reference", pressure_solver="chebyshev",
                    diffusion_solver="chebyshev", cheby_iters=2,
                    cheby_press_iters=3, cheby_rho=0.85)
    mesh = make_mesh(jax.devices()[:8], layout="square")
    state, sources = reference_init(jax.random.key(3), cfg)
    want = step3(cfg, state, sources)
    step = make_sharded_step_fn_3d(cfg, mesh, advect_mode="exact",
                                   audited=True)
    got, disp = step(shard_state_3d(state, mesh),
                     shard_state_3d(sources, mesh))
    assert len(got.dens.sharding.device_set) == 8
    assert np.isfinite(float(disp))
    _check(got, want, ("dens", "u", "v", "w"))
