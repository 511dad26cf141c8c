"""Test configuration.

Tests run on CPU with 8 virtual devices so the multi-device sharding path is
exercised without a GPU (`shard_map` over a virtual mesh compiles and runs
identically; only speed differs).  Must be set before jax import.

Tests that need the card carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them when no CUDA device is present; the decision is
made when the test runs, never at import.  On a machine with a GPU run them
with ``FLUIDSIM_TEST_GPU=1 python -m pytest tests/ -m gpu -p no:xdist``
(one process: a JAX process reserves most of the card's memory).
"""
import os

import pytest

_ON_CARD = os.environ.get("FLUIDSIM_TEST_GPU") == "1"
if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

# The suite is XLA-compile-bound (many small programs, 8-way shard_map), so
# cache compilations on disk (JAX_COMPILATION_CACHE_DIR when set, else the
# checkout's .cache/jax): a warm rerun of the quick tier is much faster.
from fluidsimulationcuda_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import numpy as np  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def random_padded(rng, n, lo=-1.0, hi=1.0):
    """A random float32 (n+2, n+2) grid."""
    return rng.uniform(lo, hi, size=(n + 2, n + 2)).astype(np.float32)


@pytest.fixture
def grid_factory(rng):
    def make(n, lo=-1.0, hi=1.0):
        return random_padded(rng, n, lo, hi)

    return make


@pytest.fixture
def gpu():
    """The first CUDA device; skips the test where there is none."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a CUDA GPU (run with FLUIDSIM_TEST_GPU=1 on the "
                    "card)")
    return devices[0]
