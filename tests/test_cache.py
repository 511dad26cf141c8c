"""Persistent compilation cache: the environment variable wins, else a
fixed directory inside the checkout."""
import os

import jax
import pytest

from fluidsimulationcuda_tpu.utils import cache


@pytest.fixture
def restore_cache_dir():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_env_var_is_honoured(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    assert cache.enable_compilation_cache() == str(tmp_path)
    # no other directory set in code
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_default_is_fixed_path_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compilation_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".cache", "jax")
    assert path == cache.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".cache/" in f.read().split()
