"""Persistent XLA compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache there by
itself and no directory is set here.  Otherwise the cache lives at a fixed
path inside the checkout (``.cache/jax``, git-ignored): the path is part of
what makes a later run find the entries again.  Call early, before the
first jit execution.
"""
from __future__ import annotations

import os

import jax

__all__ = ["enable_compilation_cache", "DEFAULT_CACHE_DIR"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_ROOT, ".cache", "jax")


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns the directory it uses."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
