"""Simulation configuration.

The reference scatters configuration across three tiers: compile-time macros
(``N/DT/VIS/DIFF``, ``project/sequential/FluidSequential.c:6-10``), CLI block
dims (``project/naivePar/FluidParallelBlockPerElement-Naive.cu:345-359``), and
a device-side ``__constant__`` mirror uploaded via ``cudaMemcpyToSymbol``
(``...:11-14,386-389``).  Here all of that collapses into one frozen
dataclass passed as a static argument to ``jax.jit`` — the compiled program
*is* the constant-folded configuration.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax.numpy as jnp

__all__ = ["SimConfig"]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Frozen, hashable simulation configuration (static under ``jax.jit``).

    Attributes:
      n: number of *interior* cells per side (reference ``N``,
        ``FluidSequential.c:6``).  The allocated grid is ``(n+2, n+2)`` —
        one ghost cell per side.
      dt: timestep (reference ``DT=0.016``, ``FluidSequential.c:7``).
      visc: velocity diffusion (viscosity) coefficient (``VIS=0.0025``).
      diff: density diffusion coefficient (``DIFF=0.1``).
      jacobi_iters: Jacobi sweeps per diffusion / pressure solve.  The
        reference hard-codes 40 (``FluidSequential.c:91``); BASELINE.json's
        headline metric uses 20, so it is a first-class parameter here and
        every reported number states it.
      dtype: element type of the state grids.  The reference is float32
        throughout (``document/main.tex:345-350``); bfloat16 is supported as
        a STORAGE format on the plain XLA path (halves the memory footprint
        and snapshot IO).  Non-parity: fields round to bf16 between ops.
      backend: which compute path executes the Jacobi solves —
        ``"reference"``: plain jnp/XLA ops (the oracle for the kernel),
        ``"hopper"``: the fused CUDA Jacobi kernel
        (``kernels/hopper_jacobi.py``; float32 2-D grids on an NVIDIA
        Hopper GPU, raises elsewhere), ``"auto"``: hopper where it
        qualifies, reference otherwise (``kernels.dispatch.resolve_backend``
        says which and why).
      pressure_solver: "jacobi" (reference-parity, ``jacobi_iters`` sweeps),
        "multigrid" (``mg_cycles`` V-cycles — the reference's own stated
        future work, ``document/main.tex:356``; mesh-independent convergence,
        non-parity numerics; requires even interior sizes for coarsening),
        or "cg" (conjugate gradient, the other named future-work solver:
        ``cg_iters`` iterations, O(n) convergence, non-parity numerics),
        or "chebyshev" (``cheby_iters`` Chebyshev-accelerated Jacobi
        sweeps, ``ops/chebyshev.py`` — same stencil and boundary handling
        as parity Jacobi but half the sweeps at better residual, measured;
        non-parity numerics).
      diffusion_solver: "jacobi" (reference-parity), "chebyshev"
        (``cheby_iters`` accelerated sweeps for the three diffusion
        solves; validated by per-solve residual <= the Jacobi-20 solve's,
        see bench.py's perf-mode line), or "chebyshev-dens" (accelerated
        sweeps for the DENSITY solve only — the velocity trajectory stays
        bit-identical to parity, so the divergence bar is untouched by
        construction and only the density-solve residual bar applies).
        The full swap must be COMPENSATED by a chebyshev pressure solve
        (``cheby_press_iters``); the operating points below pass every
        bar at the sizes they were probed at, and a point that passes in
        2-D can fail in 3-D, so use the table, not intuition.
      mg_cycles: V-cycles per pressure solve in multigrid mode.
      cg_iters: CG iterations per pressure solve in cg mode.
      cheby_iters: sweeps per solve in chebyshev modes.  Default 8: the
        fewest sweeps that passed the perf-mode divergence bar with margin
        on both the decay and the continuous-forcing trajectories.
      cheby_press_iters: pressure-solve sweep count in "chebyshev"
        pressure mode; 0 (default) follows ``cheby_iters``.  Decoupling
        exists so the pressure solve can COMPENSATE a diffusion-solver
        swap: the velocity-diffusion swap injects mid-frequency content
        that fails the divergence bar at equal sweeps, and extra pressure
        sweeps remove exactly that content.
      cheby_rho: Chebyshev interval parameter — a free tuning knob, NOT a
        stability bound (|P_k| <= 1 on [-1, 1] for any value in (0, 1);
        ``ops/chebyshev.py``).
      cheby_dens_iters: sweeps for the density solve in "chebyshev-dens"
        mode.  Default 10: passed the density residual bar with margin on
        the continuous-forcing trajectory.  The full "chebyshev" mode
        keeps ``cheby_iters`` for all solves.
      max_courant: window half-width (cells) of the sharded steps'
        windowed advection (``parallel/sharded*.py``), which bounds their
        halo depth; exact while the backtrace displacement
        ``|dt*n*velocity|`` stays below it (proof + boundary test:
        ``ops/advect.py:advect_windowed``), clamped to the window
        otherwise.  Single-device steps always use the exact gather.
      ndim: spatial dimensionality (2 for the reference solver, 3 for the
        smoke-volume extension).
    """

    n: int = 126
    dt: float = 0.016
    visc: float = 0.0025
    diff: float = 0.1
    jacobi_iters: int = 20
    dtype: jnp.dtype = jnp.float32
    backend: str = "auto"
    max_courant: int = 4
    pressure_solver: str = "jacobi"
    diffusion_solver: str = "jacobi"
    mg_cycles: int = 2
    cg_iters: int = 20
    cheby_iters: int = 8
    cheby_press_iters: int = 0
    cheby_rho: float = 0.99
    cheby_dens_iters: int = 10
    ndim: int = 2

    def __post_init__(self):
        if self.n < 2:
            raise ValueError(f"n must be >= 2, got {self.n}")
        if self.jacobi_iters < 1:
            raise ValueError("jacobi_iters must be >= 1")
        if self.backend not in ("reference", "hopper", "auto"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.pressure_solver not in ("jacobi", "multigrid", "cg",
                                        "chebyshev"):
            raise ValueError(f"unknown pressure_solver {self.pressure_solver!r}")
        if self.diffusion_solver not in ("jacobi", "chebyshev",
                                         "chebyshev-dens"):
            raise ValueError(
                f"unknown diffusion_solver {self.diffusion_solver!r}")
        if not (0.0 < self.cheby_rho < 1.0):
            raise ValueError("cheby_rho must be in (0, 1)")
        if self.cheby_iters < 2:
            raise ValueError("cheby_iters must be >= 2")
        if self.cheby_press_iters and self.cheby_press_iters < 2:
            raise ValueError("cheby_press_iters must be 0 (follow "
                             "cheby_iters) or >= 2")
        if self.cheby_dens_iters < 2:
            raise ValueError("cheby_dens_iters must be >= 2")
        if self.ndim not in (2, 3):
            raise ValueError("ndim must be 2 or 3")
        if self.ndim == 3 and self.pressure_solver not in ("jacobi",
                                                           "chebyshev"):
            # Silently ignoring the knob would misreport the numerics
            # actually run.
            raise ValueError(
                "pressure_solver='multigrid'/'cg' are 2-D solvers; "
                "ndim=3 supports 'jacobi' and 'chebyshev'"
            )
        if (self.ndim == 3 and self.diffusion_solver == "chebyshev"
                and self.pressure_solver != "chebyshev"):
            # The VELOCITY diffusion swap validates only with pressure
            # compensation: the swap's extra mid-frequency divergence must
            # be absorbed by a raised Chebyshev pressure sweep count
            # (``cheby_press_iters``).  An uncompensated 3-D swap has no
            # validated operating point, so it stays gated off rather than
            # silently mis-reporting the numerics actually run.
            raise ValueError(
                "ndim=3 diffusion_solver='chebyshev' requires "
                "pressure_solver='chebyshev' (the compensated mode); "
                "uncompensated 3-D swaps have no validated operating point"
            )

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        """Full padded grid shape, ghost border included."""
        return (self.n + 2,) * self.ndim

    @property
    def press_cheby_iters(self) -> int:
        """Effective pressure-solve sweep count in chebyshev mode."""
        return self.cheby_press_iters or self.cheby_iters

    @property
    def num_cells(self) -> int:
        c = 1
        for s in self.grid_shape:
            c *= s
        return c

    @property
    def diffusion_alpha_visc(self) -> float:
        """alpha for velocity diffusion (``FluidSequential.c:199``)."""
        return self.dt * self.visc * self.n * self.n

    @property
    def diffusion_alpha_diff(self) -> float:
        """alpha for density diffusion (``FluidSequential.c:179``)."""
        return self.dt * self.diff * self.n * self.n

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


# Validated compensated perf-mode operating points, keyed by full grid
# side (n + 2).  (rho, k_d diffusion sweeps, k_p pressure sweeps) — points
# that passed the divergence, velocity-residual and density-residual bars
# against the parity Jacobi solves at these sizes (2-D 2048²/20 iterations,
# 2-D 8192²/40 iterations, where the 2048² point fails the forced
# velocity-residual bar, and 3-D 256³/20 iterations).  The bars are
# numerics, not timings, but the sums run in another order on every
# device, so bench.py and ``run --perf --validate`` re-run them live.
#
# Unprobed sides fall back to the nearest probed point; both bench.py and
# ``run --perf`` consult THIS table (single source of truth).
PERF_POINTS_2D = {2048: (0.9, 10, 14), 8192: (0.96, 12, 14)}
PERF_POINT_3D = (0.85, 10, 12)


def perf_operating_point(side: int, ndim: int = 2):
    """(cheby_rho, cheby_iters, cheby_press_iters) for the compensated
    perf preset at full grid ``side`` = n + 2.  Size-coupled and measured
    — see the table above for provenance."""
    if ndim == 3:
        return PERF_POINT_3D
    if side in PERF_POINTS_2D:
        return PERF_POINTS_2D[side]
    # Unprobed side: snap to the nearest probed anchor (log-distance, so
    # 4096² uses the 2048² point).  The live bars exist precisely to
    # catch a failed transfer at such sizes — callers should run them.
    nearest = min(PERF_POINTS_2D,
                  key=lambda s: abs(math.log(s) - math.log(max(side, 1))))
    return PERF_POINTS_2D[nearest]
