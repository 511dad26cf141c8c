"""Per-phase timing harness.

Rebuilds the reference's observability (SURVEY.md §5): global phase arrays
``timeSource/timeDiffusion/timeDivergence/timeAdvection/timeProjection``
filled inside ``vel_step`` and averaged at exit
(``FluidSequential.c:16,192-235,314-324``; diffusion divided by the sweep
count at ``:324``) — plus throughput in cell-updates/s, the cross-variant
comparison currency of ``project/report.txt``.

A jit-compiled step cannot be timed from inside (it is one fused program),
so phases are profiled by running each operator standalone on the same
shapes, a chain of calls per jitted program, timed on the host clock up to
``jax.block_until_ready``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.state import reference_init
from ..kernels.dispatch import get_ops

__all__ = ["PhaseReport", "profile_phases", "wallclock"]


def wallclock(fn: Callable, *args, reps: int = 3, chain: int = 10) -> float:
    """Seconds per call of ``fn``: ``chain`` calls (each feeding the next
    its first argument) in one jitted program, best of ``reps`` timed runs
    after a warm-up run that compiles it."""
    x, *rest = args

    @jax.jit
    def chained(x, rest):
        for _ in range(chain):
            x = fn(x, *rest)
        return x

    jax.block_until_ready(chained(x, rest))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(chained(x, rest))
        best = min(best, time.perf_counter() - t0)
    return best / chain


@dataclasses.dataclass
class PhaseReport:
    """Per-phase seconds for one timestep (reference phase names)."""

    source: float
    diffusion: float       # one velocity-field diffusion solve
    divergence: float
    projection: float      # pressure solve + gradient subtraction
    advection: float       # u/v pair self-advection
    per_sweep: float       # diffusion / jacobi_iters (reference :324)
    step_estimate: float   # composed full-step estimate
    cells: int

    @property
    def mcells_per_s(self) -> float:
        return self.cells / self.step_estimate / 1e6

    def pretty(self) -> str:
        rows = [
            ("add_source", self.source),
            ("diffuse (1 solve)", self.diffusion),
            ("  per sweep", self.per_sweep),
            ("divergence", self.divergence),
            ("projection", self.projection),
            ("advection (pair)", self.advection),
            ("full step (est)", self.step_estimate),
        ]
        out = "\n".join(f"{k:22s} {v * 1e3:9.3f} ms" for k, v in rows)
        out += f"\n{'throughput (op-sum)':22s} {self.mcells_per_s:9.1f} Mcell/s"
        return out + ("\nnote: the op-sum is an estimate; `python bench.py` "
                      "times the composed step.")


def profile_phases(cfg: SimConfig, key=None) -> PhaseReport:
    ops = get_ops(cfg)
    key = jax.random.key(0) if key is None else key
    _, src = reference_init(key, cfg)
    u, v, d = src.u, src.v, src.dens
    alpha = cfg.diffusion_alpha_visc
    beta = 1.0 + 4.0 * alpha
    it = cfg.jacobi_iters
    dtc = jnp.asarray(cfg.dt, cfg.dtype)

    t_source = wallclock(lambda x, s: x + dtc * s, u, v)
    t_diff = wallclock(
        lambda x, s: ops.diffuse(1, x, s, alpha, beta, it), u, v, chain=6
    )
    t_div = wallclock(lambda x, s: ops.divergence(x, s, cfg.n), u, v)
    t_proj = wallclock(
        lambda x, s: ops.apply_pressure_gradient(
            x, s, ops.pressure_solve(ops.divergence(x, s, cfg.n), it), cfg.n
        )[0],
        u,
        v,
        chain=6,
    )
    t_adv = wallclock(
        lambda x, s: ops.advect_pair(1, 2, x, s, x, s, cfg.dt, cfg.n)[0],
        u,
        v,
        chain=6,
    )
    # step = 3 add_source + 3 diffusions (u, v, dens) + 2 projections
    #        (incl. divergence) + pair advection + dens advection (~pair/2)
    est = (
        3 * t_source + 3 * t_diff + 2 * t_proj + t_adv * 1.5
    )
    return PhaseReport(
        source=t_source,
        diffusion=t_diff,
        divergence=t_div,
        projection=t_proj,
        advection=t_adv,
        per_sweep=t_diff / it,
        step_estimate=est,
        cells=cfg.num_cells,
    )
