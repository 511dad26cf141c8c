"""NumPy ground-truth oracle.

A functional, vectorized float32 transcription of the reference's sequential
solver ``project/sequential/FluidSequential.c`` (the numerics oracle of the
whole repo — every CUDA variant was validated against it to ~1e-6,
``document/main.tex:349``).  Per-element arithmetic order matches the C
expressions exactly, so vectorization does not perturb results; the only
intended differences are (a) Jacobi iteration count is a parameter instead of
the hard-coded 40 (``FluidSequential.c:91``) and (b) sources are explicit
per-step inputs instead of reused ``*_prev`` scratch buffers.

Everything here is plain NumPy on purpose: it is the independent
implementation that the JAX engine is differentially tested against.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "set_bnd",
    "add_source",
    "diffuse",
    "advect",
    "divergence",
    "pressure_solve",
    "apply_pressure_gradient",
    "project",
    "vel_step",
    "dens_step",
    "step",
]

F = np.float32


def set_bnd(b: int, x: np.ndarray) -> np.ndarray:
    """Boundary conditions (``FluidSequential.c:62-75``).

    Edges copy the adjacent interior cell, negated on the wall-normal
    velocity component: b=1 flips at the left/right walls (x-velocity),
    b=2 flips at the top/bottom walls (y-velocity), b=0 plain copy.
    Corners are the mean of their two adjacent edge cells.
    """
    x = x.copy()
    sx = F(-1.0) if b == 1 else F(1.0)
    sy = F(-1.0) if b == 2 else F(1.0)
    x[1:-1, 0] = sx * x[1:-1, 1]
    x[1:-1, -1] = sx * x[1:-1, -2]
    x[0, 1:-1] = sy * x[1, 1:-1]
    x[-1, 1:-1] = sy * x[-2, 1:-1]
    half = F(0.5)
    x[0, 0] = half * (x[0, 1] + x[1, 0])
    x[-1, 0] = half * (x[-1, 1] + x[-2, 0])
    x[0, -1] = half * (x[0, -2] + x[1, -1])
    x[-1, -1] = half * (x[-2, -1] + x[-1, -2])
    return x


def _embed(interior: np.ndarray, b: int) -> np.ndarray:
    """Place an (n, n) interior into an (n+2, n+2) grid and derive the
    border from it via ``set_bnd`` — the functional equivalent of the
    reference's write-interior-then-set_bnd sequence (borders after
    ``set_bnd`` depend only on the interior, ``FluidSequential.c:100-101``)."""
    n = interior.shape[0]
    out = np.zeros((n + 2, n + 2), dtype=interior.dtype)
    out[1:-1, 1:-1] = interior
    return set_bnd(b, out)


def add_source(x: np.ndarray, s: np.ndarray, dt: float) -> np.ndarray:
    """``x += DT * s`` over the full padded grid (``FluidSequential.c:78-82``)."""
    return (x + F(dt) * s).astype(F)


def diffuse(
    b: int,
    x_init: np.ndarray,
    x0: np.ndarray,
    alpha: float,
    beta: float,
    iters: int,
) -> np.ndarray:
    """Jacobi iteration (``FluidSequential.c:85-104``):
    ``x_new[c] = (x0[c] + alpha*(xL+xR+xU+xD)) / beta`` on the interior,
    then ``set_bnd`` — repeated ``iters`` times starting from ``x_init``.

    The reference's initial guess is whatever sits in the swapped-in buffer:
    the raw source field on step 1 and zeros afterwards
    (``FluidSequential.c:201-204`` after the SWAP at ``:201``); callers here
    pass that guess explicitly.
    """
    a, bt = F(alpha), F(beta)
    x = x_init
    rhs = x0[1:-1, 1:-1]
    for _ in range(iters):
        neigh = ((x[1:-1, :-2] + x[1:-1, 2:]) + x[:-2, 1:-1]) + x[2:, 1:-1]
        x = _embed(((rhs + a * neigh) / bt).astype(F), b)
    return x


def advect(
    b: int,
    d0: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    dt: float,
    n: int,
) -> np.ndarray:
    """Semi-Lagrangian advection with bilinear gather
    (``FluidSequential.c:107-141``).  Backtrace ``(x, y) = (j, i) - dt*n*(u, v)``,
    clamp to ``[0.5, n+0.5]`` (``:117-127``), truncate to the lower cell,
    bilinear-interpolate from ``d0`` (``:136-137``)."""
    dt0 = F(F(dt) * n)
    jj, ii = np.meshgrid(
        np.arange(1, n + 1, dtype=F), np.arange(1, n + 1, dtype=F)
    )
    x = jj - dt0 * u[1:-1, 1:-1]
    y = ii - dt0 * v[1:-1, 1:-1]
    lo, hi = F(0.5), F(n + 0.5)
    x = np.clip(x, lo, hi)
    y = np.clip(y, lo, hi)
    j0 = x.astype(np.int32)  # trunc == floor: x >= 0.5
    i0 = y.astype(np.int32)
    j1 = j0 + 1
    i1 = i0 + 1
    s1 = (x - j0.astype(F)).astype(F)
    s0 = F(1.0) - s1
    t1 = (y - i0.astype(F)).astype(F)
    t0 = F(1.0) - t1
    interior = s0 * (t0 * d0[i0, j0] + t1 * d0[i1, j0]) + s1 * (
        t0 * d0[i0, j1] + t1 * d0[i1, j1]
    )
    return _embed(interior.astype(F), b)


def divergence(u: np.ndarray, v: np.ndarray, n: int) -> np.ndarray:
    """``div = -0.5*h*(uR-uL + vD-vU)``, ``h = 1/n``
    (``FluidSequential.c:143-158``)."""
    h = F(F(1.0) / n)
    d = (F(-0.5) * h) * (
        (u[1:-1, 2:] - u[1:-1, :-2]) + (v[2:, 1:-1] - v[:-2, 1:-1])
    )
    return _embed(d.astype(F), 0)


def pressure_solve(div: np.ndarray, iters: int) -> np.ndarray:
    """Pressure Poisson solve: Jacobi with alpha=1, beta=4 from a zero
    initial guess (``FluidSequential.c:218-220``; p zeroed at ``:153``)."""
    p0 = np.zeros_like(div)
    return diffuse(0, p0, div, 1.0, 4.0, iters)


def apply_pressure_gradient(
    u: np.ndarray, v: np.ndarray, p: np.ndarray, n: int
) -> tuple[np.ndarray, np.ndarray]:
    """Subtract the pressure gradient (``lastProject``,
    ``FluidSequential.c:161-173``)."""
    h = F(F(1.0) / n)
    un = u[1:-1, 1:-1] - (F(0.5) * (p[1:-1, 2:] - p[1:-1, :-2])) / h
    vn = v[1:-1, 1:-1] - (F(0.5) * (p[2:, 1:-1] - p[:-2, 1:-1])) / h
    return _embed(un.astype(F), 1), _embed(vn.astype(F), 2)


def project(
    u: np.ndarray, v: np.ndarray, n: int, iters: int
) -> tuple[np.ndarray, np.ndarray]:
    """divergence -> pressure solve -> gradient subtraction
    (``FluidSequential.c:213-226``)."""
    div = divergence(u, v, n)
    p = pressure_solve(div, iters)
    return apply_pressure_gradient(u, v, p, n)


def vel_step(
    u: np.ndarray,
    v: np.ndarray,
    u_src: np.ndarray,
    v_src: np.ndarray,
    visc: float,
    dt: float,
    n: int,
    iters: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Velocity update (``FluidSequential.c:189-241``): add sources,
    diffuse u and v (initial guess = the raw source buffers, see
    ``diffuse``), project, self-advect with the *pre-advection* velocity
    (``:232,237`` — both advections read the same swapped-out field),
    project again."""
    u = add_source(u, u_src, dt)
    v = add_source(v, v_src, dt)
    alpha = F(F(dt) * F(visc) * n * n)
    beta = F(1) + F(4) * alpha
    u = diffuse(1, u_src, u, alpha, beta, iters)
    v = diffuse(2, v_src, v, alpha, beta, iters)
    u, v = project(u, v, n, iters)
    u0, v0 = u, v
    u = advect(1, u0, u0, v0, dt, n)
    v = advect(2, v0, u0, v0, dt, n)
    u, v = project(u, v, n, iters)
    return u, v


def dens_step(
    dens: np.ndarray,
    dens_src: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    diff: float,
    dt: float,
    n: int,
    iters: int,
) -> np.ndarray:
    """Density update (``FluidSequential.c:176-186``)."""
    dens = add_source(dens, dens_src, dt)
    alpha = F(F(dt) * F(diff) * n * n)
    beta = F(1) + F(4) * alpha
    dens = diffuse(0, dens_src, dens, alpha, beta, iters)
    return advect(0, dens, u, v, dt, n)


def step(
    dens: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    dens_src: np.ndarray,
    u_src: np.ndarray,
    v_src: np.ndarray,
    *,
    dt: float,
    visc: float,
    diff: float,
    n: int,
    iters: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One full timestep: ``vel_step`` then ``dens_step``
    (``FluidSequential.c:305-306``)."""
    u, v = vel_step(u, v, u_src, v_src, visc, dt, n, iters)
    dens = dens_step(dens, dens_src, u, v, diff, dt, n, iters)
    return dens, u, v
