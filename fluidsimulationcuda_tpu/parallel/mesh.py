"""Device-mesh helpers for multi-device spatial decomposition.

The reference never leaves one GPU (SURVEY.md §2.3); its closest analogue of
multi-device scaling is CUDA-block shared-memory halo tiling
(``smPar/FluidParallelBlockPerElement-SM.cu:169-192``).  Here that pattern is
lifted to device level: the padded grid is partitioned over a 2-D
``jax.sharding.Mesh`` with axes ("x", "y") and each Jacobi sweep exchanges a
1-cell halo with its mesh neighbors.
"""
from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "grid_sharding", "SPATIAL_AXES"]

SPATIAL_AXES = ("x", "y")


def _factor_2d(n: int) -> tuple[int, int]:
    """Near-square factorization of a device count."""
    px = int(math.isqrt(n))
    while n % px:
        px -= 1
    return px, n // px


def make_mesh(
    devices=None,
    shape: tuple[int, int] | None = None,
    *,
    layout: str = "rows",
) -> Mesh:
    """A 2-D ("x", "y") mesh over ``devices`` (default: all).

    ``layout`` picks the default factorization when ``shape`` is None:

    - ``"rows"`` (default): an (n, 1) row mesh — full-width slabs.  Row
      slabs halve the exchange count (no column halos, no corner phase)
      and keep every row contiguous on its device.
    - ``"square"``: near-square factorization — minimizes per-device halo
      bytes (O(side/sqrt(d)) vs O(side)).

    The mesh follows the algorithm alone: the cards of one host are joined
    all to all (NVLink), so no layout is closer to the interconnect than
    another.
    """
    if devices is None:
        devices = jax.devices()
    if shape is None:
        if layout == "rows":
            shape = (len(devices), 1)
        elif layout == "square":
            shape = _factor_2d(len(devices))
        else:
            raise ValueError(f"unknown layout {layout!r}")
    px, py = shape
    if px * py != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    return Mesh(np.asarray(devices).reshape(px, py), SPATIAL_AXES)


def grid_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a padded (n+2, n+2) grid: rows over "x", cols over "y"."""
    return NamedSharding(mesh, P("x", "y"))
