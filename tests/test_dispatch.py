"""Backend dispatch: which path runs where, and that the choice is visible.

The platform is monkeypatched (``dispatch._platform``), so every route is
checked here on the CPU; nothing is compiled for a device.
"""
import jax
import jax.numpy as jnp
import pytest

from fluidsimulationcuda_tpu import SimConfig, StableFluids2D, make_step_fn
from fluidsimulationcuda_tpu.kernels import dispatch
from fluidsimulationcuda_tpu.ops.advect import advect

HOPPER = ("gpu", "9.0")


def _on(monkeypatch, platform):
    monkeypatch.setattr(dispatch, "_platform", lambda: platform)


@pytest.mark.parametrize("platform,kw,backend,reason", [
    (("cpu", ""), {}, "reference", "needs a CUDA GPU; platform is 'cpu'"),
    (HOPPER, {}, "hopper", "auto: Hopper GPU"),
    (("gpu", "8.0"), {}, "reference", "compute capability is 8.0"),
    (HOPPER, {"ndim": 3}, "reference", "2-D; ndim=3"),
    (HOPPER, {"dtype": jnp.bfloat16}, "reference", "float32; dtype=bfloat16"),
])
def test_auto_route_per_platform(monkeypatch, platform, kw, backend, reason):
    _on(monkeypatch, platform)
    got, why = dispatch.resolve_backend(SimConfig(n=30, **kw))
    assert got == backend
    assert reason in why
    if backend == "reference":
        assert why.startswith("auto declined the Jacobi kernel")


@pytest.mark.parametrize("platform,kw", [
    (("cpu", ""), {}),
    (("gpu", "8.0"), {}),
    (HOPPER, {"dtype": jnp.bfloat16}),
    (HOPPER, {"ndim": 3}),
])
def test_explicit_hopper_raises_where_it_cannot_run(monkeypatch, platform,
                                                    kw):
    _on(monkeypatch, platform)
    cfg = SimConfig(n=30, backend="hopper", **kw)
    with pytest.raises(ValueError, match="backend='hopper' cannot run"):
        dispatch.resolve_backend(cfg)
    with pytest.raises(ValueError, match="backend='hopper' cannot run"):
        dispatch.get_ops(cfg)


def test_explicit_reference_runs_anywhere(monkeypatch):
    _on(monkeypatch, HOPPER)
    cfg = SimConfig(n=30, backend="reference")
    assert dispatch.resolve_backend(cfg) == ("reference", "requested")


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="unknown backend"):
        SimConfig(n=30, backend="pallas")


def test_get_ops_on_hopper_routes_solves_through_the_kernel(monkeypatch):
    """On a Hopper GPU the opset's solves go through the kernel's launch
    plan: a stand-in launch records the sweeps it was asked for."""
    from fluidsimulationcuda_tpu.kernels import hopper_jacobi as hj

    _on(monkeypatch, HOPPER)
    calls = []

    def fake_launch(b, x, xm, rhs, alpha, beta, weights, *, cheby):
        calls.append((b, len(weights), cheby))
        return hj.reference_launch(b, x, xm, rhs, alpha, beta, weights,
                                   cheby=cheby)

    monkeypatch.setattr(hj, "launch", fake_launch)
    ops = dispatch.get_ops(SimConfig(n=30, jacobi_iters=20))
    x = jnp.ones((32, 32), jnp.float32)
    ops.diffuse(1, x, x, 0.3, 2.2, 20)
    ops.pressure_solve(x, 9, cheby_rho=0.9)
    assert calls == [(1, 7, False), (1, 7, False), (1, 6, False),
                     (0, 5, True), (0, 4, True)]


def test_step_fn_carries_backend_and_reason():
    cfg = SimConfig(n=14, jacobi_iters=4)
    fn = make_step_fn(cfg)
    assert fn.backend == "reference"
    assert "auto declined the Jacobi kernel" in fn.backend_reason
    sim = StableFluids2D(cfg.replace(backend="reference"))
    assert (sim.backend, sim.backend_reason) == ("reference", "requested")


def test_advect_mode_auto_is_exact_gather():
    """Single-device opsets advect with the exact gather whatever the
    config's window: ``max_courant`` is read only by the sharded steps."""
    from fluidsimulationcuda_tpu.kernels import hopper_jacobi as hj

    cfg = SimConfig(n=14, backend="reference", max_courant=1)
    assert dispatch.get_ops(cfg).advect is advect
    assert dispatch.kernel_ops(cfg, launch_fn=hj.reference_launch).advect \
        is advect


def _build(kind, cfg):
    """A step function from one of the builders that never take the
    kernel: the 3-D steps and the sharded steps."""
    from fluidsimulationcuda_tpu.models.stable_fluids_3d import (
        StableFluids3D, make_step_fn_3d,
    )
    from fluidsimulationcuda_tpu.parallel.mesh import make_mesh
    from fluidsimulationcuda_tpu.parallel.sharded import make_sharded_step_fn
    from fluidsimulationcuda_tpu.parallel.sharded3d import (
        make_sharded_step_fn_3d,
    )

    if kind == "3d":
        return make_step_fn_3d(cfg.replace(ndim=3, n=14))
    if kind == "3d_model":
        return StableFluids3D(cfg.replace(ndim=3, n=14))
    if kind == "sharded_2d":
        return make_sharded_step_fn(cfg, make_mesh(jax.devices()[:4]))
    return make_sharded_step_fn_3d(cfg.replace(ndim=3, n=14),
                                   make_mesh(jax.devices()[:8]))


PLAIN_BUILDERS = [("3d", "2-D; ndim=3"), ("3d_model", "2-D; ndim=3"),
                  ("sharded_2d", "plain local ops inside shard_map"),
                  ("sharded_3d", "plain local ops inside shard_map")]


@pytest.mark.parametrize("kind,reason", PLAIN_BUILDERS)
def test_plain_builders_decline_the_kernel_visibly(monkeypatch, kind,
                                                   reason):
    """On a Hopper GPU ``auto`` declines the kernel for the 3-D and
    sharded steps, and their step functions say why."""
    _on(monkeypatch, HOPPER)
    fn = _build(kind, SimConfig(n=30, jacobi_iters=4))
    assert fn.backend == "reference"
    assert fn.backend_reason.startswith("auto declined the Jacobi kernel")
    assert reason in fn.backend_reason
    ref = _build(kind, SimConfig(n=30, jacobi_iters=4, backend="reference"))
    assert (ref.backend, ref.backend_reason) == ("reference", "requested")


@pytest.mark.parametrize("kind,reason", PLAIN_BUILDERS)
def test_plain_builders_raise_on_explicit_hopper(monkeypatch, kind, reason):
    _on(monkeypatch, HOPPER)
    with pytest.raises(ValueError, match="backend='hopper' cannot run"):
        _build(kind, SimConfig(n=30, jacobi_iters=4, backend="hopper"))


def test_batched_step_carries_backend(monkeypatch):
    from fluidsimulationcuda_tpu.models.batched import make_batched_step_fn

    cfg = SimConfig(n=14, jacobi_iters=4)
    fn = make_batched_step_fn(cfg)
    assert fn.backend == "reference"
    assert "needs a CUDA GPU" in fn.backend_reason
    with pytest.raises(ValueError, match="backend='hopper' cannot run"):
        make_batched_step_fn(cfg.replace(backend="hopper"))
    _on(monkeypatch, HOPPER)
    assert make_batched_step_fn(cfg).backend == "hopper"


def test_cli_run_reports_backend(capsys):
    from fluidsimulationcuda_tpu import __main__ as cli

    cli.main(["run", "--n", "14", "--steps", "2", "--iters", "4"])
    err = capsys.readouterr().err
    assert "backend: reference (auto declined the Jacobi kernel" in err
    assert "2 steps in" in err


def test_platform_reads_the_default_device():
    platform, _ = dispatch._platform()
    assert platform == jax.devices()[0].platform
