"""Chebyshev perf-mode solver: jnp spec vs the Jacobi kernel's launch plan.

The acceleration claim itself (cheby-10 residual <= jacobi-20's on all five
solves at 2048²) is re-validated on every bench run (bench.py perf-mode
line); CI pins the numerics: the kernel's launch plan (every launch as its
plain specification, ``kernel-plan``; the compiled kernel on the card,
``hopper``) == the jnp spec, the full cheby step matches across backends,
and basic solver sanity.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fluidsimulationcuda_tpu import SimConfig, make_step_fn, reference_init
from fluidsimulationcuda_tpu.kernels import dispatch
from fluidsimulationcuda_tpu.kernels import hopper_jacobi as hj
from fluidsimulationcuda_tpu.models import stable_fluids_2d
from fluidsimulationcuda_tpu.ops.chebyshev import (
    cheby_diffuse, cheby_omegas, cheby_pressure_solve,
)

SIDE = 64
BACKENDS = ["kernel-plan", pytest.param("hopper", marks=pytest.mark.gpu)]


def _grid(seed, side=SIDE, scale=1.0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(-scale, scale, (side, side)).astype(np.float32))


def _ops(backend, request, **kw):
    cfg = SimConfig(n=SIDE - 2, backend="reference", **kw)
    if backend == "hopper":
        request.getfixturevalue("gpu")
        return dispatch.kernel_ops(cfg)
    return dispatch.kernel_ops(cfg, launch_fn=hj.reference_launch)


def _use_kernel_plan(monkeypatch):
    """Steps built by ``make_step_fn`` from here on run the kernel's launch
    plan (each launch as its plain specification) for every config."""
    monkeypatch.setattr(
        stable_fluids_2d, "get_ops",
        lambda cfg: dispatch.kernel_ops(cfg, launch_fn=hj.reference_launch))


def test_omega_schedule():
    ws = cheby_omegas(0.99, 10)
    assert len(ws) == 9
    # w_2 = 2/(2-rho^2), then monotone decreasing toward the fixed point
    # 2/(1+sqrt(1-rho^2)) from above
    assert abs(ws[0] - 2.0 / (2.0 - 0.99**2)) < 1e-12
    assert all(b < a for a, b in zip(ws, ws[1:]))
    assert ws[-1] > 2.0 / (1.0 + np.sqrt(1.0 - 0.99**2))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("b", [0, 1, 2])
@pytest.mark.parametrize("iters", [2, 3, 10])
def test_kernel_matches_spec(b, iters, backend, request):
    x, x0 = _grid(1), _grid(2)
    ref = cheby_diffuse(b, x, x0, 0.3, 2.2, iters, 0.99)
    got = _ops(backend, request).diffuse(b, x, x0, 0.3, 2.2, iters,
                                         cheby_rho=0.99)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=0, atol=3e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_pressure_kernel_matches_spec(backend, request):
    div = _grid(3, scale=0.01)
    ref = cheby_pressure_solve(div, 10, 0.995)
    got = _ops(backend, request).pressure_solve(div, 10, cheby_rho=0.995)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=0, atol=3e-6)


@pytest.mark.parametrize("iters,max_fused", [(10, 3), (9, 4), (12, 5)])
def test_cheby_chain_matches_single_call(iters, max_fused):
    """The cross-launch Chebyshev carry: forcing the per-launch sweep
    budget below ``iters`` must chain launches that carry x_{k-1} and
    the weight schedule and land on the SAME iterate as one launch and
    as the jnp spec."""
    x, x0 = _grid(8), _grid(9)
    ref = cheby_diffuse(1, x, x0, 0.3, 2.2, iters, 0.95)
    one = hj.jacobi(1, x, x0, 0.3, 2.2, iters, cheby_rho=0.95,
                    max_sweeps=hj.MAX_SWEEPS, launch_fn=hj.reference_launch)
    got = hj.jacobi(1, x, x0, 0.3, 2.2, iters, cheby_rho=0.95,
                    max_sweeps=max_fused, launch_fn=hj.reference_launch)
    np.testing.assert_allclose(np.asarray(got), np.asarray(one),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=0, atol=3e-6)


def test_cheby_chain_pressure_zero_init():
    """Chained pressure solve from the zero guess against the jnp spec."""
    div = _grid(10, scale=0.01)
    ref = cheby_pressure_solve(div, 11, 0.995)
    got = hj.jacobi(0, jnp.zeros_like(div), div, 1.0, 4.0, 11,
                    cheby_rho=0.995, max_sweeps=4,
                    launch_fn=hj.reference_launch)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=0, atol=3e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_projection_cheby_matches_composition(backend, request):
    u, v = _grid(4, scale=0.1), _grid(5, scale=0.1)
    from fluidsimulationcuda_tpu.ops.project import (
        apply_pressure_gradient, divergence,
    )
    d = divergence(u, v, SIDE - 2)
    p = cheby_pressure_solve(d, 10, 0.99)
    ur, vr = apply_pressure_gradient(u, v, p, SIDE - 2)
    ug, vg = _ops(backend, request).project(u, v, SIDE - 2, 10,
                                            cheby_rho=0.99)
    np.testing.assert_allclose(np.asarray(ug), np.asarray(ur),
                               rtol=0, atol=3e-6)
    np.testing.assert_allclose(np.asarray(vg), np.asarray(vr),
                               rtol=0, atol=3e-6)


def test_cheby_step_backend_parity(monkeypatch):
    """Full perf-mode step: the kernel's launch plan vs the reference jnp
    path.  Ten sweeps per solve take two launches, so ``x_{k-1}`` is
    carried across a launch boundary."""
    kw = dict(n=SIDE - 2, pressure_solver="chebyshev",
              diffusion_solver="chebyshev", cheby_iters=10)
    cfg = SimConfig(backend="reference", **kw)
    state, src = reference_init(jax.random.key(0), cfg)
    sr = make_step_fn(cfg)(state, src)
    _use_kernel_plan(monkeypatch)
    sp = make_step_fn(cfg)(state, src)
    for a, b_, name in ((sp.dens, sr.dens, "dens"), (sp.u, sr.u, "u"),
                        (sp.v, sr.v, "v")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_cheby_never_amplifies():
    """|P_k| <= 1 on the Jacobi spectrum: iterating longer never blows up,
    for any rho — the 'free knob' property the docstring claims."""
    div = _grid(6, scale=0.01)
    for rho in (0.5, 0.99, 0.999):
        prev = None
        for iters in (2, 6, 12):
            p = cheby_pressure_solve(div, iters, rho)
            m = float(jnp.max(jnp.abs(p)))
            assert np.isfinite(m)
            if prev is not None:
                assert m < prev * 1.5 + 1.0
            prev = m


def test_cheby_residual_improves_on_jacobi_at_scale_shape():
    """At a modest grid the accelerated solve should already be no worse
    than plain Jacobi at EQUAL sweeps (the 2048² hardware claim — half the
    sweeps — is re-validated on every bench run)."""
    from fluidsimulationcuda_tpu.ops.project import pressure_solve
    div = _grid(7, scale=0.01)

    def resid(p):
        nb = ((p[1:-1, :-2] + p[1:-1, 2:]) + p[:-2, 1:-1]) + p[2:, 1:-1]
        r = 4.0 * p[1:-1, 1:-1] - div[1:-1, 1:-1] - nb
        return float(jnp.max(jnp.abs(r)))

    rj = resid(pressure_solve(div, 12))
    rc = resid(cheby_pressure_solve(div, 12, 0.95))
    assert rc <= rj * 1.05, (rc, rj)


def test_chebyshev_dens_velocity_bit_parity():
    """``diffusion_solver="chebyshev-dens"`` accelerates ONLY the density
    solve: with a jacobi pressure solver the velocity trajectory is
    BIT-identical to full parity (density is passive in Stam's solver) —
    the construction that exempts the swap from the divergence bar
    (bench.py ``--perf-solver chebyshev+dens`` / audit_dens_residual)."""
    kw = dict(n=SIDE - 2, jacobi_iters=8, backend="reference")
    cfg_j = SimConfig(**kw)
    cfg_d = SimConfig(diffusion_solver="chebyshev-dens", cheby_dens_iters=5,
                      **kw)
    state, src = reference_init(jax.random.key(8), cfg_j)
    fj, fd = make_step_fn(cfg_j), make_step_fn(cfg_d)
    s_j, s_d = state, state
    for _ in range(3):
        s_j, s_d = fj(s_j, src), fd(s_d, src)
    np.testing.assert_array_equal(np.asarray(s_j.u), np.asarray(s_d.u))
    np.testing.assert_array_equal(np.asarray(s_j.v), np.asarray(s_d.v))
    d = np.abs(np.asarray(s_j.dens) - np.asarray(s_d.dens)).max()
    assert d > 0, "density solve should actually differ (5 cheby sweeps)"
    assert np.isfinite(np.asarray(s_d.dens)).all()


def test_chebyshev_dens_backend_parity(monkeypatch):
    """chebyshev-dens step: the kernel's launch plan vs the reference jnp
    path — the dens solve routes cheby_dens_iters through the kernel, in
    two launches for 11 sweeps."""
    kw = dict(n=SIDE - 2, jacobi_iters=8, diffusion_solver="chebyshev-dens",
              cheby_dens_iters=11)
    cfg = SimConfig(backend="reference", **kw)
    state, src = reference_init(jax.random.key(9), cfg)
    sr = make_step_fn(cfg)(state, src)
    _use_kernel_plan(monkeypatch)
    sp = make_step_fn(cfg)(state, src)
    for a, b_, name in ((sp.dens, sr.dens, "dens"), (sp.u, sr.u, "u"),
                        (sp.v, sr.v, "v")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_step_audited_matches_step_under_cheby_modes():
    """The audit replay must follow the SAME trajectory as step() for every
    diffusion_solver mode (it feeds the exact-regime claim)."""
    from fluidsimulationcuda_tpu import step, step_audited
    import functools

    for dsolver, kws in (("chebyshev", {"cheby_iters": 5}),
                         ("chebyshev-dens", {"cheby_dens_iters": 5})):
        cfg = SimConfig(n=SIDE - 2, jacobi_iters=8, backend="reference",
                        diffusion_solver=dsolver, **kws)
        state, src = reference_init(jax.random.key(10), cfg)
        want = jax.jit(functools.partial(step, cfg))(state, src)
        got, disp = jax.jit(functools.partial(step_audited, cfg))(state, src)
        for name in ("dens", "u", "v"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got, name)),
                np.asarray(getattr(want, name)), err_msg=f"{dsolver}/{name}")
        assert np.isfinite(float(disp))


@pytest.mark.parametrize("backend", ["reference", "kernel-plan"])
def test_cheby_press_iters_plumbing(backend, monkeypatch):
    """``cheby_press_iters`` decouples the PRESSURE sweep count (the
    compensated perf mode's knob, bench.py ``--perf-solver compensated``):
    with a jacobi diffusion solver only the pressure solve reads it, so
    (cheby_iters=6, cheby_press_iters=10) must be BIT-identical to
    (cheby_iters=10) — through the plain ops and the kernel's plan."""
    if backend == "kernel-plan":
        _use_kernel_plan(monkeypatch)
    kw = dict(n=SIDE - 2, pressure_solver="chebyshev", jacobi_iters=8,
              backend="reference")
    cfg_a = SimConfig(cheby_iters=6, cheby_press_iters=10, **kw)
    cfg_b = SimConfig(cheby_iters=10, **kw)
    state, src = reference_init(jax.random.key(11), cfg_a)
    sa = make_step_fn(cfg_a)(state, src)
    sb = make_step_fn(cfg_b)(state, src)
    sc = make_step_fn(SimConfig(cheby_iters=6, **kw))(state, src)
    for name in ("dens", "u", "v"):
        np.testing.assert_array_equal(
            np.asarray(getattr(sa, name)), np.asarray(getattr(sb, name)),
            err_msg=f"{backend}/{name}")
    d = np.abs(np.asarray(sa.u) - np.asarray(sc.u)).max()
    assert d > 0, f"{backend}: press_iters=10 should differ from 6"


def test_cheby_press_iters_plumbing_3d():
    """Same decoupling through the 3-D chain (``_Ops3.project``)."""
    from fluidsimulationcuda_tpu.models.stable_fluids_3d import (
        make_step_fn_3d,
    )
    kw = dict(n=14, ndim=3, pressure_solver="chebyshev", jacobi_iters=6,
              backend="reference", max_courant=2)
    cfg_a = SimConfig(cheby_iters=4, cheby_press_iters=8, **kw)
    cfg_b = SimConfig(cheby_iters=8, **kw)
    state, src = reference_init(jax.random.key(12), cfg_a)
    sa = make_step_fn_3d(cfg_a)(state, src)
    sb = make_step_fn_3d(cfg_b)(state, src)
    for name in ("dens", "u", "v", "w"):
        np.testing.assert_array_equal(
            np.asarray(getattr(sa, name)), np.asarray(getattr(sb, name)),
            err_msg=name)


def test_config_validation():
    with pytest.raises(ValueError):
        SimConfig(n=30, pressure_solver="chebyshev", cheby_rho=1.5)
    with pytest.raises(ValueError):
        SimConfig(n=30, diffusion_solver="sor")
    # 3-D velocity diffusion swap: legal ONLY compensated (chebyshev
    # pressure absorbing the swap's divergence); an uncompensated 3-D swap
    # has no validated operating point.
    with pytest.raises(ValueError):
        SimConfig(n=30, ndim=3, diffusion_solver="chebyshev")
    SimConfig(n=30, ndim=3, diffusion_solver="chebyshev",
              pressure_solver="chebyshev")
    # chebyshev-dens IS legal in 3-D (density feeds no divergence).
    SimConfig(n=30, ndim=3, diffusion_solver="chebyshev-dens")
    with pytest.raises(ValueError):
        SimConfig(n=30, diffusion_solver="chebyshev-dens", cheby_dens_iters=1)
    with pytest.raises(ValueError):
        SimConfig(n=30, cheby_press_iters=1)
    # 0 follows cheby_iters; nonzero overrides the pressure solve only
    assert SimConfig(n=30, cheby_iters=6).press_cheby_iters == 6
    assert SimConfig(n=30, cheby_iters=6,
                     cheby_press_iters=14).press_cheby_iters == 14


def test_compensated_3d_audit_twin_and_engagement():
    """3-D compensated mode (velocity+dens diffusion on Chebyshev, pressure
    compensated): ``step_audited3`` must follow the SAME trajectory as
    ``step3`` (separately-coded paths), and the swap must actually engage
    (differ from the jacobi-diffusion twin)."""
    import functools

    from fluidsimulationcuda_tpu.models.stable_fluids_3d import (
        make_step_fn_3d, step_audited3,
    )

    kw = dict(n=14, ndim=3, jacobi_iters=6, pressure_solver="chebyshev",
              cheby_iters=4, cheby_press_iters=6, backend="reference",
              max_courant=2)
    cfg = SimConfig(diffusion_solver="chebyshev", **kw)
    state, src = reference_init(jax.random.key(13), cfg)
    want = make_step_fn_3d(cfg)(state, src)
    got, disp = jax.jit(functools.partial(step_audited3, cfg))(state, src)
    for name in ("dens", "u", "v", "w"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            err_msg=name)
    assert np.isfinite(float(disp))
    s_j = make_step_fn_3d(SimConfig(**kw))(state, src)
    assert np.abs(np.asarray(want.u) - np.asarray(s_j.u)).max() > 0, \
        "velocity diffusion swap should engage (cheby-4 != jacobi-6)"
