"""Pin the windowed-gather exactness condition at its boundary.

The canonical claim (``ops/advect.py:advect_windowed`` docstring): the
windowed gather equals the exact XLA gather whenever the backtrace
displacement ``d = max |dt*n*velocity|`` satisfies ``d <= cmax``; every
audit in the repo enforces the strict ``d < cmax``.  These tests sweep a
controlled uniform displacement across ``cmax-1 .. cmax .. cmax+eps``
against the EXACT gather (not the windowed jnp spec — both sides of that
pair clamp identically) in 2-D and 3-D, for the jnp windowed spec and for
the sharded step's windowed advection, whose halo depth the window bounds
(``parallel/sharded.py``).
"""
import numpy as np
import pytest

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from fluidsimulationcuda_tpu.ops.advect import advect, advect_windowed
from fluidsimulationcuda_tpu.parallel import sharded
from fluidsimulationcuda_tpu.parallel.mesh import make_mesh
from fluidsimulationcuda_tpu.ops.three_d import advect3, advect3_windowed

CMAX = 2


def _field2(n, seed=0):
    rng = np.random.default_rng(seed)
    side = n + 2
    return jnp.asarray(rng.standard_normal((side, side)), jnp.float32)


def _const_vel2(n, disp, angle=0.3):
    """Uniform velocity whose backtrace displacement is exactly ``disp``
    cells along the dominant axis (dt*n = 1 below)."""
    side = n + 2
    u = jnp.full((side, side), np.float32(disp), jnp.float32)
    v = jnp.full((side, side), np.float32(disp * angle), jnp.float32)
    return u, v


# dt*n == 1 makes displacement == velocity, exactly representable.
def _dt(n):
    return 1.0 / n


@pytest.mark.parametrize("disp", [CMAX - 1.0, CMAX - 0.25, CMAX - 0.001,
                                  float(CMAX)])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_2d_windowed_exact_below_and_at_cmax(disp, sign):
    n = 62
    d0 = _field2(n)
    u, v = _const_vel2(n, sign * disp)
    exact = advect(0, d0, u, v, _dt(n), n)
    win = advect_windowed(0, d0, u, v, _dt(n), n, CMAX)
    np.testing.assert_array_equal(np.asarray(exact), np.asarray(win))


@pytest.mark.parametrize("disp", [CMAX + 0.25, CMAX + 1.0])
def test_2d_windowed_clamps_above_cmax(disp):
    """Above the boundary the clamp must actually fire: the test has teeth
    only if the two paths genuinely diverge there."""
    n = 62
    d0 = _field2(n)
    u, v = _const_vel2(n, disp)
    exact = advect(0, d0, u, v, _dt(n), n)
    win = advect_windowed(0, d0, u, v, _dt(n), n, CMAX)
    assert float(jnp.abs(exact - win).max()) > 0.0


@pytest.mark.parametrize("disp", [CMAX - 1.0, CMAX - 0.25, CMAX - 0.001,
                                  float(CMAX)])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_2d_sharded_windowed_exact_below_and_at_cmax(disp, sign):
    """The sharded windowed advection on a 2x2 mesh (a (cmax+1)-deep halo
    exchange instead of an all-gather) equals the exact gather up to the
    window boundary.  Separate compilations may contract FMAs differently,
    a 1-ulp shift of the backtrace: ~1e-6 on unit fields."""
    n = 62
    d0 = _field2(n)
    u, v = _const_vel2(n, sign * disp)
    exact = advect(0, d0, u, v, _dt(n), n)
    mesh = make_mesh(jax.devices()[:4], (2, 2))
    f = jax.jit(jax.shard_map(
        functools.partial(sharded._advect_local_windowed, 0, dtim=_dt(n),
                          n=n, px=2, py=2, cmax=CMAX),
        mesh=mesh, in_specs=(P("x", "y"),) * 3, out_specs=P("x", "y"),
    ))
    np.testing.assert_allclose(np.asarray(f(d0, u, v)), np.asarray(exact),
                               rtol=0, atol=1e-5)


def _field3(n, seed=1):
    rng = np.random.default_rng(seed)
    side = n + 2
    return jnp.asarray(rng.standard_normal((side, side, side)), jnp.float32)


@pytest.mark.parametrize("disp", [CMAX - 0.25, CMAX - 0.001, float(CMAX)])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_3d_windowed_exact_below_and_at_cmax(disp, sign):
    n = 22
    d0 = _field3(n)
    side = n + 2
    u = jnp.full((side,) * 3, np.float32(sign * disp), jnp.float32)
    v = jnp.full((side,) * 3, np.float32(sign * disp * 0.4), jnp.float32)
    w = jnp.full((side,) * 3, np.float32(-sign * disp * 0.7), jnp.float32)
    exact = advect3(0, d0, u, v, w, _dt(n), n)
    win = advect3_windowed(0, d0, u, v, w, _dt(n), n, cmax=CMAX)
    np.testing.assert_array_equal(np.asarray(exact), np.asarray(win))


def test_3d_windowed_clamps_above_cmax():
    n = 22
    d0 = _field3(n)
    side = n + 2
    u = jnp.full((side,) * 3, np.float32(CMAX + 0.5), jnp.float32)
    v = jnp.zeros((side,) * 3, jnp.float32)
    w = jnp.zeros((side,) * 3, jnp.float32)
    exact = advect3(0, d0, u, v, w, _dt(n), n)
    win = advect3_windowed(0, d0, u, v, w, _dt(n), n, cmax=CMAX)
    assert float(jnp.abs(exact - win).max()) > 0.0
