"""Chebyshev semi-iterative acceleration of the Jacobi solves (jnp spec).

The performance-mode solver (``pressure_solver="chebyshev"`` /
``diffusion_solver="chebyshev"``): accelerates the SAME Jacobi sweep the
parity path runs — same stencil, same boundary handling, same rhs — with
the classic three-term Chebyshev recurrence over the stationary iteration
``x_{k+1} = S(x_k)`` (Golub & Van Loan §11.2.8; Varga, *Matrix Iterative
Analysis*):

    x_1     = S(x_0)
    x_{k+1} = w_{k+1} * S(x_k) + (1 - w_{k+1}) * x_{k-1}
    w_{k+1} = 1 / (1 - rho^2 * w_k / 4),   w_1 = 2

Properties that make it an HONEST drop-in for the reference's fixed-budget
Jacobi loop (``FluidSequential.c:85-104,218-220``):

- The error polynomial satisfies P_k(1) = 1 and |P_k(mu)| <= 1 for every
  |mu| <= 1 and ANY rho in (0, 1): no mode is ever amplified, and the
  mode-0 Neumann nullspace (additive constants in the pressure solve) is
  left untouched exactly as plain Jacobi leaves it.  ``rho`` is therefore
  a free tuning knob, not a stability bound to estimate.
- On the forced 2048² trajectory cheby-10 at rho=0.99 gave 0.68-0.83x
  the Jacobi-20 residual on all five of the step's solves (both pressure
  solves, both velocity diffusions, density diffusion) — half the
  sweeps, better quality.  bench.py validates this on every run
  (post-projection max|divergence| and diffusion residuals vs the parity
  Jacobi-20 on the same states).

Not a parity mode: the reference runs plain Jacobi, so the parity headline
keeps ``"jacobi"``.  This module is the differential-test oracle for the
Chebyshev launches of the Jacobi kernel (``kernels/hopper_jacobi.py``).
"""
from __future__ import annotations

import jax.numpy as jnp

from .boundary import embed_interior
from .diffuse import jacobi_sweep

__all__ = [
    "cheby_omegas",
    "cheby_diffuse",
    "cheby_pressure_solve",
    "cheby_diffuse3",
    "cheby_pressure_solve3",
]


def cheby_omegas(rho: float, iters: int) -> tuple[float, ...]:
    """The w_2..w_iters schedule (w for sweep k applies to x_k -> x_{k+1});
    returned as plain floats so kernels can fold them as compile-time
    constants or scan them as scalars."""
    ws = []
    w = 2.0
    for _ in range(1, iters):
        w = 1.0 / (1.0 - 0.25 * rho * rho * w)
        ws.append(w)
    return tuple(ws)


def cheby_diffuse(
    b: int,
    x_init: jnp.ndarray,
    x0: jnp.ndarray,
    alpha: float,
    beta: float,
    iters: int,
    rho: float,
) -> jnp.ndarray:
    """``iters`` Chebyshev-accelerated Jacobi sweeps (the perf-mode twin of
    ``ops.diffuse.diffuse``; guess ``x_init``, rhs ``x0``)."""
    dt = x0.dtype
    rhs_int = x0[1:-1, 1:-1]
    one = jnp.asarray(1.0, dt)
    xm = x_init
    x = jacobi_sweep(b, xm, rhs_int, alpha, beta)
    for w in cheby_omegas(rho, iters):
        wc = jnp.asarray(w, dt)
        xn = wc * jacobi_sweep(b, x, rhs_int, alpha, beta) + (one - wc) * xm
        # Re-derive the ghost ring from the combined interior: the affine
        # combo would otherwise leak x_{k-1}'s ghosts (for k=2, the RAW
        # guess border) into a ring the next sweep reads.  Ghosts follow
        # the mode-b rule of the CURRENT interior at every iterate — the
        # same semantics the Jacobi kernel's in-sweep BC produces.
        xm, x = x, embed_interior(b, xn[1:-1, 1:-1])
    return x


def cheby_pressure_solve(div: jnp.ndarray, iters: int, rho: float) -> jnp.ndarray:
    """Chebyshev Poisson solve from the zero guess (perf-mode twin of
    ``ops.project.pressure_solve``)."""
    return cheby_diffuse(0, jnp.zeros_like(div), div, 1.0, 4.0, iters, rho)


def cheby_diffuse3(
    b: int,
    x_init: jnp.ndarray,
    x0: jnp.ndarray,
    alpha: float,
    beta: float,
    iters: int,
    rho: float,
) -> jnp.ndarray:
    """3-D twin of :func:`cheby_diffuse` (6-neighbor sweep, semantics of
    ``ops.three_d.diffuse3``): ghost FACES re-derived from the combined
    interior after every iterate (the stencil never reads ghost edges or
    corners), full ghost layer derived once at the end."""
    from .three_d import embed_faces3, embed_interior3

    dt = x0.dtype
    a = jnp.asarray(alpha, dt)
    bt = jnp.asarray(beta, dt)
    rhs = x0[1:-1, 1:-1, 1:-1]
    one = jnp.asarray(1.0, dt)

    def sweep(x):
        neigh = (
            ((x[1:-1, 1:-1, :-2] + x[1:-1, 1:-1, 2:])
             + (x[1:-1, :-2, 1:-1] + x[1:-1, 2:, 1:-1]))
            + (x[:-2, 1:-1, 1:-1] + x[2:, 1:-1, 1:-1])
        )
        return embed_faces3(b, (rhs + a * neigh) / bt)

    xm = x_init
    x = sweep(xm)
    for w in cheby_omegas(rho, iters):
        wc = jnp.asarray(w, dt)
        xn = wc * sweep(x) + (one - wc) * xm
        xm, x = x, embed_faces3(b, xn[1:-1, 1:-1, 1:-1])
    return embed_interior3(b, x[1:-1, 1:-1, 1:-1])


def cheby_pressure_solve3(div: jnp.ndarray, iters: int, rho: float) -> jnp.ndarray:
    """3-D Chebyshev Poisson solve from the zero guess (perf-mode twin of
    ``ops.three_d.pressure_solve3``)."""
    return cheby_diffuse3(0, jnp.zeros_like(div), div, 1.0, 6.0, iters, rho)
