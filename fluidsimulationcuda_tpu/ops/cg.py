"""Conjugate-gradient pressure solver — the reference's other named
future-work item (``document/main.tex:356``, "conjugate gradient /
multigrid"; multigrid lives in ``ops/multigrid.py``).

Solves the same discrete Poisson problem as the projection's Jacobi solve,

    A p = div,   A p := 4 p - (pL + pR + pU + pD)   (unit index spacing),

with the solver's copy (Neumann-like) ghost rule folded into the operator
(ghosts mirror the adjacent interior cell, so wall-adjacent rows see a
modified stencil — A stays symmetric positive semi-definite on the
mean-zero subspace CG walks).

Shape of the work: each iteration is two elementwise passes + one 5-point
stencil + two reductions — work XLA fuses well; the iteration count for a
given residual is O(n) vs Jacobi's O(n²), and ~15-20 iterations already
beat 40 Jacobi sweeps by orders of magnitude in residual (see
``tests/test_cg.py``).  Like multigrid it is an *optional alternative*
(``SimConfig.pressure_solver = "cg"``): better convergence, non-parity
numerics.

Plain CG (no preconditioner): the A-multiply dominates at ~10 ops/cell, so
a Jacobi preconditioner (diag(A) = 4I) would only rescale uniformly — a
no-op for CG directions.  IC/MG preconditioning is future work.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .boundary import embed_interior

__all__ = ["cg_pressure_solve", "cg_residual_norm"]


def _apply_A_bc(p_int: jnp.ndarray) -> jnp.ndarray:
    """A with the copy-BC ghost rule folded in: embed the interior with
    mirrored ghosts, then apply the 5-point operator."""
    p = embed_interior(0, p_int)
    return 4.0 * p[1:-1, 1:-1] - (
        (p[1:-1, :-2] + p[1:-1, 2:]) + p[:-2, 1:-1] + p[2:, 1:-1]
    )


@functools.partial(jax.jit, static_argnames=("iters",))
def cg_pressure_solve(div: jnp.ndarray, iters: int = 20) -> jnp.ndarray:
    """``iters`` conjugate-gradient iterations on A p = div from p = 0.
    Input/output are padded (n+2, n+2) grids (ghost ring rebuilt with the
    copy rule, like ``pressure_solve``)."""
    dt = div.dtype
    b = div[1:-1, 1:-1]
    # A with the copy (Neumann) BC is singular — constants are its
    # nullspace.  Deflate the RHS mean (the f32 mean of a discrete
    # divergence is small but nonzero); pressure is only ever used through
    # its gradient, so the constant shift is immaterial, and without the
    # deflation CG stalls at the inconsistency floor instead of converging.
    b = b - jnp.mean(b)
    x = jnp.zeros_like(b)
    r = b  # r0 = b - A·0
    p = r
    rs = jnp.sum(r * r)
    eps = jnp.asarray(1e-30, dt)

    def body(_, carry):
        x, r, p, rs = carry
        Ap = _apply_A_bc(p)
        alpha = rs / (jnp.sum(p * Ap) + eps)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = jnp.sum(r * r)
        beta = rs_new / (rs + eps)
        p = r + beta * p
        return x, r, p, rs_new

    x, r, p, rs = jax.lax.fori_loop(0, iters, body, (x, r, p, rs))
    return embed_interior(0, x)


def cg_residual_norm(p: jnp.ndarray, div: jnp.ndarray) -> jnp.ndarray:
    """max |div - A p| over the interior (same residual the multigrid
    module reports)."""
    return jnp.abs(div[1:-1, 1:-1] - _apply_A_bc(p[1:-1, 1:-1])).max()
