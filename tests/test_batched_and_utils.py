"""Batched datagen, checkpointing, and the timing harness."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fluidsimulationcuda_tpu import SimConfig, make_step_fn, reference_init
from fluidsimulationcuda_tpu.models.batched import (
    batched_init,
    generate_trajectories,
    make_batched_step_fn,
)
from fluidsimulationcuda_tpu.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)


@pytest.mark.slow
def test_batched_matches_individual():
    """vmapped step == per-sim step, element for element."""
    cfg = SimConfig(n=14, jacobi_iters=4, backend="reference")
    key = jax.random.key(0)
    states, sources = batched_init(key, cfg, 3)
    vstep = make_batched_step_fn(cfg)
    out = vstep(states, sources)

    step = make_step_fn(cfg)
    for i in range(3):
        st_i = jax.tree.map(lambda a: a[i], states)
        src_i = jax.tree.map(lambda a: a[i], sources)
        want = step(st_i, src_i)
        np.testing.assert_allclose(
            np.asarray(out.dens[i]), np.asarray(want.dens), rtol=1e-6, atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(out.u[i]), np.asarray(want.u), rtol=1e-6, atol=1e-6
        )


def test_batched_sims_are_independent():
    """Different PRNG folds give different sims; no cross-talk."""
    cfg = SimConfig(n=14, jacobi_iters=4, backend="reference")
    states, sources = batched_init(jax.random.key(1), cfg, 2)
    assert not np.allclose(
        np.asarray(sources.dens[0]), np.asarray(sources.dens[1])
    )


def test_generate_trajectories_snapshots():
    cfg = SimConfig(n=14, jacobi_iters=4, backend="reference")
    final, snaps, dmax = generate_trajectories(
        jax.random.key(2), cfg, batch=2, num_steps=6, snapshot_every=3
    )
    assert 0.0 < float(dmax) < cfg.max_courant  # audited exact regime
    assert snaps.shape == (2, 2, 16, 16)  # 2 snapshots x 2 sims
    np.testing.assert_allclose(
        np.asarray(snaps[-1]), np.asarray(final.dens), rtol=1e-6, atol=1e-6
    )
    assert np.isfinite(np.asarray(snaps)).all()


def test_checkpoint_roundtrip(tmp_path):
    cfg = SimConfig(n=14, jacobi_iters=4, backend="reference")
    state, sources = reference_init(jax.random.key(3), cfg)
    state = make_step_fn(cfg)(state, sources)
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, state, cfg, step=7)
    state2, cfg2, step2 = load_checkpoint(p)
    assert step2 == 7
    assert cfg2 == cfg
    for name in ("dens", "u", "v"):
        np.testing.assert_array_equal(
            np.asarray(getattr(state, name)), np.asarray(getattr(state2, name))
        )
    assert state2.w is None


def test_checkpoint_resume_continues_identically(tmp_path):
    """save -> load -> step == step without the round trip (bit-exact)."""
    cfg = SimConfig(n=14, jacobi_iters=4, backend="reference")
    state, sources = reference_init(jax.random.key(4), cfg)
    step = make_step_fn(cfg)
    s1 = step(state, sources)
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, s1, cfg)
    s1b, cfg2, _ = load_checkpoint(p)
    from fluidsimulationcuda_tpu import zero_sources

    z = zero_sources(cfg)
    a = step(s1, z)
    b = make_step_fn(cfg2)(s1b, z)
    np.testing.assert_array_equal(np.asarray(a.dens), np.asarray(b.dens))


def test_wallclock_smoke():
    from fluidsimulationcuda_tpu.utils.timing import wallclock

    x = jnp.ones((64, 64))
    sec = wallclock(lambda a, b: a + b, x, x, reps=1, chain=10)
    assert sec > 0


@pytest.mark.parametrize("dsolver", ["jacobi", "chebyshev"])
def test_batched_kernel_plan_matches_vmapped_reference(dsolver, monkeypatch):
    """The batched step through the Jacobi kernel's launch plan (each
    launch as its plain specification, batched by vmap as the kernel is)
    matches the vmapped jnp step — dsolver='chebyshev' is the full
    compensated datagen perf mode.  Solves of 10 and 9 sweeps take two
    launches each."""
    from fluidsimulationcuda_tpu.kernels import dispatch
    from fluidsimulationcuda_tpu.kernels import hopper_jacobi as hj
    from fluidsimulationcuda_tpu.models import stable_fluids_2d

    cfg = SimConfig(n=30, jacobi_iters=10, backend="reference",
                    pressure_solver="chebyshev",
                    diffusion_solver=dsolver, cheby_iters=9,
                    cheby_rho=0.95)
    states, sources = batched_init(jax.random.key(6), cfg, 3)
    want = make_batched_step_fn(cfg)(states, sources)
    monkeypatch.setattr(
        stable_fluids_2d, "get_ops",
        lambda c: dispatch.kernel_ops(c, launch_fn=hj.reference_launch))
    got = make_batched_step_fn(cfg)(states, sources)
    for name in ("dens", "u", "v"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)),
            np.asarray(getattr(want, name)),
            rtol=1e-5, atol=2e-5, err_msg=name,
        )


def test_generate_trajectories_snapshot_cadence_non_multiple():
    """num_steps not a multiple of snapshot_every: floor(num/every) snaps."""
    cfg = SimConfig(n=14, jacobi_iters=4, backend="reference")
    final, snaps, _ = generate_trajectories(
        jax.random.key(6), cfg, batch=2, num_steps=7, snapshot_every=3
    )
    assert snaps.shape == (2, 2, 16, 16)  # steps 3 and 6
    assert np.isfinite(np.asarray(snaps)).all()


def test_checkpoint_forward_compat_config_fields(tmp_path):
    """A checkpoint with unknown/missing config keys still loads (schema
    tolerance): unknown keys dropped, missing keys defaulted."""
    import json

    cfg = SimConfig(n=14, jacobi_iters=4, backend="reference")
    state, _ = reference_init(jax.random.key(7), cfg)
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, state, cfg, step=3)

    # Rewrite the meta to simulate a checkpoint from a different build:
    # one unknown key added, one current key removed.
    with np.load(p) as z:
        payload = {k: z[k] for k in z.files}
    meta = json.loads(bytes(payload["_meta"]).decode())
    meta["config"]["some_future_field"] = 42
    del meta["config"]["cheby_dens_iters"]
    payload["_meta"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez_compressed(p, **payload)

    state2, cfg2, step2 = load_checkpoint(p)
    assert step2 == 3
    assert cfg2.n == 14 and cfg2.cheby_dens_iters == 10
    np.testing.assert_array_equal(np.asarray(state.dens), np.asarray(state2.dens))


def test_checkpoint_newer_schema_rejected(tmp_path):
    import json

    cfg = SimConfig(n=14, jacobi_iters=4, backend="reference")
    state, _ = reference_init(jax.random.key(8), cfg)
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, state, cfg)
    with np.load(p) as z:
        payload = {k: z[k] for k in z.files}
    meta = json.loads(bytes(payload["_meta"]).decode())
    meta["version"] = 999
    payload["_meta"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez_compressed(p, **payload)
    with pytest.raises(ValueError, match="schema version"):
        load_checkpoint(p)


def test_cli_perf_preset_pins_validated_operating_points():
    """--perf must apply exactly the measured compensated operating
    points (2-D: rho=0.9/k_d=10/k_p=14; 3-D: rho=0.85/k_d=10/k_p=12 —
    core/config.py), so preset drift from the validated values is a
    test failure, not a silent numerics change."""
    from types import SimpleNamespace

    from fluidsimulationcuda_tpu import __main__ as cli

    def ns(ndim):
        # None = the argparse "not passed" sentinel (value
        # equality with defaults missed explicitly-passed defaults)
        return SimpleNamespace(
            n=126, iters=20, backend="reference", dt=0.016,
            visc=0.0025, diff=0.1, ndim=ndim, pressure_solver=None,
            diffusion_solver=None, cheby_iters=None,
            cheby_press_iters=None, cheby_rho=None, perf=True)

    c2 = cli._cfg(ns(2))
    assert c2.pressure_solver == c2.diffusion_solver == "chebyshev"
    assert c2.cheby_iters == 10
    assert (c2.cheby_rho, c2.press_cheby_iters) == (0.9, 14)
    c3 = cli._cfg(ns(3))
    assert (c3.cheby_rho, c3.press_cheby_iters) == (0.85, 12)
    # the 8192² point is size-coupled (core/config.PERF_POINTS_2D)
    big = ns(2)
    big.n = 8190
    c8k = cli._cfg(big)
    assert (c8k.cheby_rho, c8k.cheby_iters, c8k.press_cheby_iters) == \
        (0.96, 12, 14)
    # without --perf, unpassed knobs resolve to the plain defaults
    plain = ns(2)
    plain.perf = False
    c0 = cli._cfg(plain)
    assert c0.pressure_solver == "jacobi"
    assert (c0.cheby_iters, c0.cheby_press_iters, c0.cheby_rho) == \
        (8, 0, 0.99)
    # ...and explicitly passed ones pass through untouched
    expl = ns(2)
    expl.perf = False
    expl.pressure_solver, expl.cheby_rho = "multigrid", 0.5
    ce = cli._cfg(expl)
    assert ce.pressure_solver == "multigrid" and ce.cheby_rho == 0.5


def test_cli_perf_warns_on_clobbered_flags(capsys):
    """--perf once silently discarded explicit solver flags; now it
    must say so."""
    from types import SimpleNamespace

    from fluidsimulationcuda_tpu import __main__ as cli

    def ns(rho):
        # fresh namespace each time: _cfg mutates args in place
        return SimpleNamespace(
            n=126, iters=20, backend="reference", dt=0.016,
            visc=0.0025, diff=0.1, ndim=2, pressure_solver=None,
            diffusion_solver=None, cheby_iters=None,
            cheby_press_iters=None, cheby_rho=rho, perf=True)

    cli._cfg(ns(0.5))
    err = capsys.readouterr().err
    assert "overrides" in err and "--cheby-rho" in err
    # explicitly passing the DEFAULT value must warn too —
    # the sentinel (None = not passed) detects it where value equality
    # with the default could not
    cli._cfg(ns(0.99))
    err = capsys.readouterr().err
    assert "overrides" in err and "--cheby-rho" in err
    # nothing passed: silent
    cli._cfg(ns(None))
    assert "overrides" not in capsys.readouterr().err


def test_validate_perf_point_bars():
    """The packaged bench bars (utils/validate.py) return the full dict and
    a conjunction verdict; a parity-vs-parity 'perf' config trivially
    passes the divergence bar and runs no residual bars."""
    import dataclasses

    from fluidsimulationcuda_tpu import SimConfig
    from fluidsimulationcuda_tpu.utils.validate import validate_perf_point

    cfg = SimConfig(n=30, jacobi_iters=8, backend="reference")
    same = validate_perf_point(cfg, dataclasses.replace(cfg), steps=2)
    assert same["divergence_ok"] and same["ok"]
    assert "diffusion_residual_ratio" not in same
    perf = dataclasses.replace(
        cfg, pressure_solver="chebyshev", diffusion_solver="chebyshev",
        cheby_iters=8, cheby_press_iters=10, cheby_rho=0.9)
    bars = validate_perf_point(cfg, perf, steps=2)
    for k in ("max_abs_divergence", "jacobi_max_abs_divergence",
              "divergence_ok", "diffusion_residual_ratio", "diffusion_ok",
              "dens_residual_ratio", "dens_ok", "ok"):
        assert k in bars, k
    assert bars["ok"] == (bars["divergence_ok"] and bars["diffusion_ok"]
                          and bars["dens_ok"])
