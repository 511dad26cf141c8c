"""Sharded pressure solvers (multigrid / CG) and the sharded audit.

``pressure_solver="multigrid"/"cg"`` work inside ``shard_map`` (fine level
distributed with 1-halo exchanges, coarse multigrid levels psum-replicated;
CG is local stencils + psum dot products), and the sharded step has an
audited twin.  Runs on 8 virtual CPU devices (conftest).
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fluidsimulationcuda_tpu import (
    SimConfig,
    make_step_fn,
    reference_init,
    step_audited,
    zero_sources,
)
from fluidsimulationcuda_tpu.parallel.mesh import make_mesh
from fluidsimulationcuda_tpu.parallel.sharded import (
    make_sharded_step_fn,
    shard_state,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs >=4 devices (virtual CPU mesh)"
)


def _run(step_fn, state, sources, zeros, steps):
    s = state
    for k in range(steps):
        s = step_fn(s, sources if k == 0 else zeros)
    return s


@pytest.mark.slow
@pytest.mark.parametrize("solver", ["cg", "multigrid", "chebyshev"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)])
def test_sharded_solver_matches_single_device(solver, mesh_shape):
    """Sharded mg/cg on a multi-device mesh vs the SAME sharded algorithm
    on a 1x1 mesh — sharding must not change the result.  (The unsharded
    step's multigrid is a different algorithm — graded matmul-transfer
    hierarchy vs the distributed classic-halving V-cycle —
    so elementwise equality across the two is not an invariant; solver
    quality is pinned separately by the divergence checks below and in
    test_multigrid.py.)  Not bit-exact even same-algorithm: psum dot
    products (CG) and 2x2 restriction sums (MG) reassociate reductions."""
    cfg = SimConfig(n=30, jacobi_iters=8, backend="reference",
                    pressure_solver=solver, mg_cycles=2, cg_iters=12)
    state, sources = reference_init(jax.random.key(3), cfg)
    zeros = zero_sources(cfg)
    if solver in ("cg", "chebyshev"):
        # Same algorithm sharded and unsharded — the stronger cross-check
        # (``_cheby_pressure_local`` runs the same sweep/omega sequence as
        # ``ops.chebyshev.cheby_pressure_solve``, chunked by halo depth).
        want = _run(make_step_fn(cfg), state, sources, zeros, 2)
    else:
        mesh1 = make_mesh(jax.devices()[:1], (1, 1))
        step1 = make_sharded_step_fn(cfg, mesh1)
        want = _run(step1, shard_state(state, mesh1),
                    shard_state(sources, mesh1), shard_state(zeros, mesh1),
                    2)

    mesh = make_mesh(jax.devices()[: mesh_shape[0] * mesh_shape[1]],
                     mesh_shape)
    step = make_sharded_step_fn(cfg, mesh)
    got = _run(step, shard_state(state, mesh), shard_state(sources, mesh),
               shard_state(zeros, mesh), 2)
    for name in ("dens", "u", "v"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            rtol=2e-5, atol=2e-5, err_msg=f"{solver}/{name}",
        )


@pytest.mark.parametrize("dsolver", ["chebyshev", "chebyshev-dens"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)])
def test_sharded_diffusion_solver_matches_unsharded(dsolver, mesh_shape):
    """The sharded step honors ``diffusion_solver`` (same sweep/omega
    sequence as the unsharded ``ops.chebyshev.cheby_diffuse``, chunked by
    halo depth) — it must not silently run parity Jacobi."""
    cfg = SimConfig(n=30, jacobi_iters=8, backend="reference",
                    diffusion_solver=dsolver, cheby_iters=5,
                    cheby_dens_iters=5)
    state, sources = reference_init(jax.random.key(13), cfg)
    zeros = zero_sources(cfg)
    want = _run(make_step_fn(cfg), state, sources, zeros, 2)

    mesh = make_mesh(jax.devices()[: mesh_shape[0] * mesh_shape[1]],
                     mesh_shape)
    step = make_sharded_step_fn(cfg, mesh)
    got = _run(step, shard_state(state, mesh), shard_state(sources, mesh),
               shard_state(zeros, mesh), 2)
    for name in ("dens", "u", "v"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            rtol=2e-5, atol=2e-5, err_msg=f"{dsolver}/{name}",
        )


def test_sharded_cheby_press_iters_plumbing():
    """``cheby_press_iters`` reaches the sharded pressure solve
    (``_cheby_pressure_local`` / the slab kernels): with jacobi diffusion,
    (cheby_iters=5, cheby_press_iters=8) is bit-identical to
    (cheby_iters=8) on the mesh."""
    kw = dict(n=30, jacobi_iters=8, backend="reference",
              pressure_solver="chebyshev")
    cfg_a = SimConfig(cheby_iters=5, cheby_press_iters=8, **kw)
    cfg_b = SimConfig(cheby_iters=8, **kw)
    state, sources = reference_init(jax.random.key(14), cfg_a)
    zeros = zero_sources(cfg_a)
    mesh = make_mesh(jax.devices()[:4], (2, 2))
    sa = _run(make_sharded_step_fn(cfg_a, mesh), shard_state(state, mesh),
              shard_state(sources, mesh), shard_state(zeros, mesh), 2)
    sb = _run(make_sharded_step_fn(cfg_b, mesh), shard_state(state, mesh),
              shard_state(sources, mesh), shard_state(zeros, mesh), 2)
    for name in ("dens", "u", "v"):
        np.testing.assert_array_equal(
            np.asarray(getattr(sa, name)), np.asarray(getattr(sb, name)),
            err_msg=name)


def test_sharded_mg_rejects_odd_blocks():
    # side 36 over 8 row-shards -> 4.5 rows: indivisible caught first; use
    # a mesh where blocks divide but are odd: side 36 over (4, 4) -> 9x9.
    cfg = SimConfig(n=34, backend="reference", pressure_solver="multigrid")
    mesh = make_mesh(jax.devices()[:8], (4, 2))  # 9 x 18 local blocks
    with pytest.raises(ValueError, match="even local block"):
        make_sharded_step_fn(cfg, mesh)


def test_sharded_audited_matches_single_device_audit():
    cfg = SimConfig(n=30, jacobi_iters=8, backend="reference")
    state, sources = reference_init(jax.random.key(5), cfg)
    _, want_disp = jax.jit(functools.partial(step_audited, cfg))(
        state, sources
    )

    mesh = make_mesh(jax.devices()[:4], (2, 2))
    step = make_sharded_step_fn(cfg, mesh, audited=True)
    out, got_disp = step(shard_state(state, mesh),
                         shard_state(sources, mesh))
    assert np.isfinite(np.asarray(out.dens)).all()
    np.testing.assert_allclose(float(got_disp), float(want_disp),
                               rtol=1e-5, atol=1e-6)
