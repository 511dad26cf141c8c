"""Physics ground-truth tier (round 5, VERDICT item 6).

Everything else in the suite validates against the reference's numerics
(the right parity bar) — but a wrong-but-self-consistent oracle would
sail through a three-way differential.  These tests pin the solvers to
ANALYTIC properties of the discretized equations, derivable with pencil
and paper from the stencils in ``ops/`` (which transcribe
``FluidSequential.c:62-241``):

1.  The implicit diffusion solve ``(1+4a)x - a·Σnb = x0`` has exact
    eigenmodes under the reference's ghost-cell boundary modes:
    - mode 0 (ghost = copy → mirror at the half-cell face):
      ``cos(πp(i-½)/n)`` per axis;
    - mode 1/2 (no-slip: ghost = −adjacent on the wall-normal axis):
      ``sin(πp(j-½)/n)`` on that axis (antisymmetric at the face —
      the wall-normal sine family; the period condition at the far
      wall gives k = πp/n for both families).
    Each product mode is an eigenvector with neighbor-sum eigenvalue
    ``2(cos kx + cos ky)``, so the converged solve must scale it by the
    discrete diffusion factor ``1 / (1 + 4a(sin²(kx/2) + sin²(ky/2)))``.
2.  The converged diffusion solve under mode 0 conserves interior mass
    exactly (the mirror-BC Laplacian has zero column sums — the
    discrete form of Neumann no-flux).
3.  Projection is (near-)identity on a discretely solenoidal field
    (u = ∂₀ψ, v = −∂₁ψ makes the code's central divergence cancel
    term-by-term) and contracts the divergence of a random field.
4.  Advection is exact on constant fields and the identity at zero
    velocity (bilinear weights sum to 1; backtrace degenerates to the
    cell itself).

All run on the reference jnp backend, the Jacobi kernel's launch plan
(``kernel-plan``: every launch as its plain specification, on any device;
``hopper``: the compiled kernel, on the card), and — for diffusion — the
NumPy oracle, so a drift in any one backend's physics breaks here even if
the backends drift together.  Advection runs exact and windowed.

Exceeds ``document/main.tex:349``'s eyeball parity: the reference never
validates against the math it discretizes.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from fluidsimulationcuda_tpu import SimConfig
from fluidsimulationcuda_tpu.kernels import hopper_jacobi as hj
from fluidsimulationcuda_tpu.kernels.dispatch import (
    get_ops, kernel_ops, reference_ops,
)
from fluidsimulationcuda_tpu.ops.advect import advect_windowed
from fluidsimulationcuda_tpu.oracle import numpy_ref as oracle

N = 30  # interior cells; side 32
SOLVERS = ["reference", "kernel-plan",
           pytest.param("hopper", marks=pytest.mark.gpu)]
GATHERS = ["exact", "windowed"]


def _ops(backend, request):
    """OpSet for a backend: ``kernel-plan`` runs the kernel's launch plan
    with every launch as its plain specification; ``hopper`` needs the
    card; ``windowed`` is the reference with the masked-shift gather."""
    cfg = SimConfig(n=N, jacobi_iters=20, backend="reference",
                    max_courant=4)
    if backend == "kernel-plan":
        return kernel_ops(cfg, launch_fn=hj.reference_launch)
    if backend == "hopper":
        request.getfixturevalue("gpu")
        return get_ops(cfg.replace(backend="hopper"))
    if backend == "windowed":
        return reference_ops(cfg)._replace(
            advect=lambda b, d0, u, v, dt, n: advect_windowed(
                b, d0, u, v, dt, n, cfg.max_courant))
    return reference_ops(cfg)


def _mode(fam_y, p, fam_x, q, n=N):
    """Product eigenmode on the padded grid (ghosts included, so the
    invariance of the interior under set_bnd is part of what's tested).
    ``fam``: 'cos' (mirror family, modes 0 walls) or 'sin' (no-slip
    family).  Wavenumbers k = πp/n."""
    idx = np.arange(n + 2, dtype=np.float64)  # 0..n+1; cell centers i-1/2
    ky, kx = np.pi * p / n, np.pi * q / n

    def fam(f, k):
        c = (idx - 0.5) * k
        return np.cos(c) if f == "cos" else np.sin(c)

    m = np.outer(fam(fam_y, ky), fam(fam_x, kx)).astype(np.float32)
    factor_denom = 4.0 * (np.sin(kx / 2) ** 2 + np.sin(ky / 2) ** 2)
    return m, factor_denom


@pytest.mark.parametrize("backend", SOLVERS + ["oracle"])
@pytest.mark.parametrize(
    "b,fam_y,fam_x,p,q",
    [
        (0, "cos", "cos", 3, 5),  # density: mirror BCs on both axes
        (1, "cos", "sin", 2, 4),  # u: no-slip on the x (axis-1) walls
        (2, "sin", "cos", 4, 2),  # v: no-slip on the y (axis-0) walls
    ],
)
def test_diffusion_eigenmode_factor(backend, b, fam_y, fam_x, p, q, request):
    """Converged implicit diffusion must scale its boundary-compatible
    eigenmodes by exactly 1/(1 + 4a(sin²(kx/2)+sin²(ky/2)))."""
    alpha = 0.4
    beta = 1.0 + 4.0 * alpha
    m, denom = _mode(fam_y, p, fam_x, q)
    expected = m[1:-1, 1:-1] / (1.0 + alpha * denom)
    iters = 150  # Jacobi contraction 4a/(1+4a) ≈ 0.62 → 150 sweeps ≈ 1e-32
    if backend == "oracle":
        got = oracle.diffuse(b, m.copy(), m, alpha, beta, iters)
    else:
        ops = _ops(backend, request)
        got = np.asarray(
            ops.diffuse(b, jnp.asarray(m), jnp.asarray(m), alpha, beta,
                        iters))
    np.testing.assert_allclose(got[1:-1, 1:-1], expected, rtol=2e-4,
                               atol=2e-6)


@pytest.mark.parametrize("backend", SOLVERS + ["oracle"])
def test_diffusion_chebyshev_same_eigenmode_factor(backend, request):
    """The Chebyshev-accelerated solve targets the SAME fixed point — the
    physics bar applies to the perf solver family, not just parity."""
    from fluidsimulationcuda_tpu.ops.chebyshev import cheby_diffuse

    alpha = 0.4
    beta = 1.0 + 4.0 * alpha
    m, denom = _mode("cos", 3, "cos", 5)
    expected = m[1:-1, 1:-1] / (1.0 + alpha * denom)
    if backend == "oracle":
        pytest.skip("oracle has no Chebyshev solver (parity twin only)")
    if backend == "reference":
        got = np.asarray(cheby_diffuse(0, jnp.asarray(m), jnp.asarray(m),
                                       alpha, beta, 100, 0.9))
    else:
        ops = _ops(backend, request)
        got = np.asarray(ops.diffuse(0, jnp.asarray(m), jnp.asarray(m),
                                     alpha, beta, 100, cheby_rho=0.9))
    np.testing.assert_allclose(got[1:-1, 1:-1], expected, rtol=2e-3,
                               atol=2e-5)


@pytest.mark.parametrize("backend", SOLVERS + ["oracle"])
def test_diffusion_mode0_conserves_mass(backend, rng, request):
    """Interior mass conservation: under the mirror (mode 0) boundary the
    discrete Laplacian's column sums vanish — every edge cell recovers
    its missing neighbor as its own ghost copy — so the converged solve
    preserves Σ_interior x₀ (discrete no-flux / Neumann).  This is the
    guard for the density diffusion losing or minting mass."""
    alpha = 0.7
    beta = 1.0 + 4.0 * alpha  # contraction 0.74 → 150 sweeps ≈ 4e-20
    x0 = np.zeros((N + 2, N + 2), np.float32)
    x0[1:-1, 1:-1] = rng.standard_normal((N, N)).astype(np.float32)
    mass0 = float(np.sum(x0[1:-1, 1:-1], dtype=np.float64))
    iters = 150
    if backend == "oracle":
        got = oracle.diffuse(0, x0.copy(), x0, alpha, beta, iters)
    else:
        ops = _ops(backend, request)
        got = np.asarray(ops.diffuse(0, jnp.asarray(x0), jnp.asarray(x0),
                                     alpha, beta, iters))
    mass = float(np.sum(np.asarray(got)[1:-1, 1:-1], dtype=np.float64))
    assert abs(mass - mass0) <= 1e-4 * max(1.0, abs(mass0)) + 1e-4


def _solenoidal_field(rng):
    """(u, v) with EXACT (term-by-term cancelling) central divergence,
    from a streamfunction compactly supported away from the walls:
    u = ψ[i+1,j] - ψ[i-1,j], v = -(ψ[i,j+1] - ψ[i,j-1])."""
    psi = np.zeros((N + 2, N + 2), np.float64)
    yy, xx = np.meshgrid(np.arange(N + 2), np.arange(N + 2), indexing="ij")
    c = (N + 2) / 2.0
    psi = np.exp(-((yy - c) ** 2 + (xx - c) ** 2) / (2 * (N / 8.0) ** 2))
    psi[:4, :] = psi[-4:, :] = psi[:, :4] = psi[:, -4:] = 0.0
    u = np.zeros_like(psi)
    v = np.zeros_like(psi)
    u[1:-1, 1:-1] = psi[2:, 1:-1] - psi[:-2, 1:-1]
    v[1:-1, 1:-1] = -(psi[1:-1, 2:] - psi[1:-1, :-2])
    return u.astype(np.float32), v.astype(np.float32)


@pytest.mark.parametrize("backend", SOLVERS)
def test_projection_identity_on_solenoidal_field(backend, rng, request):
    """A discretely divergence-free field must pass through the
    projection (divergence → Poisson solve → gradient subtraction)
    essentially unchanged: div ≈ 0 (fp cancellation noise only), so
    p ≈ 0 and the correction vanishes."""
    u, v = _solenoidal_field(rng)
    ops = _ops(backend, request)
    div = np.asarray(ops.divergence(jnp.asarray(u), jnp.asarray(v), N))
    assert np.abs(div).max() < 1e-7  # exact modulo fp re-association
    un, vn = ops.project(jnp.asarray(u), jnp.asarray(v), N, 20)
    scale = np.abs(u).max()
    np.testing.assert_allclose(np.asarray(un)[1:-1, 1:-1], u[1:-1, 1:-1],
                               atol=1e-4 * max(scale, 1e-3))
    np.testing.assert_allclose(np.asarray(vn)[1:-1, 1:-1], v[1:-1, 1:-1],
                               atol=1e-4 * max(scale, 1e-3))


@pytest.mark.parametrize("backend", SOLVERS)
def test_projection_gradient_mode_exact_factor(backend, request):
    """The converged projection scales a pure-gradient eigenmode field by
    EXACTLY F = 1 − (sx²cx² + sy²cy²)/(sx² + sy²), s=sin(k/2), c=cos(k/2).

    Derivation (the code's own operators): the central gradient of
    φ = Cx·Cy is u = sin(kx)·Sx·Cy, v = sin(ky)·Cx·Sy (boundary-mode
    compatible: wall-normal sine ↔ modes 1/2, all-cos ↔ mode 0).  The
    central divergence maps it to −h(sin²kx+sin²ky)·CxCy; the COMPACT
    5-point Poisson solve divides by 4(sx²+sy²); the gradient
    subtraction returns F·(u, v).  F→0 for smooth modes (gradients
    removed — incompressibility) but F>0 at high k: the well-known
    collocated-grid null-space mismatch (wide D∘G vs compact L), the
    artifact the reference's double projection in vel_step exists to
    damp (``FluidSequential.c:232-240``).  Pinning F validates the
    whole projection pipeline against the math, artifact included."""
    p, q = 6, 8  # (y, x) mode numbers — high enough that Jacobi
    # converges fast: rate (cos kx + cos ky)/2 ≈ 0.74, 150 sweeps ≈ 2e-20
    ky, kx = np.pi * p / N, np.pi * q / N
    m_u, _ = _mode("cos", p, "sin", q)
    m_v, _ = _mode("sin", p, "cos", q)
    u = (np.sin(kx) * m_u).astype(np.float32)
    v = (np.sin(ky) * m_v).astype(np.float32)
    sx2, cx2 = np.sin(kx / 2) ** 2, np.cos(kx / 2) ** 2
    sy2, cy2 = np.sin(ky / 2) ** 2, np.cos(ky / 2) ** 2
    F = 1.0 - (sx2 * cx2 + sy2 * cy2) / (sx2 + sy2)
    ops = _ops(backend, request)
    un, vn = ops.project(jnp.asarray(u), jnp.asarray(v), N, 150)
    np.testing.assert_allclose(np.asarray(un)[1:-1, 1:-1],
                               F * u[1:-1, 1:-1], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vn)[1:-1, 1:-1],
                               F * v[1:-1, 1:-1], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("backend", GATHERS)
def test_advection_constant_field_identity(backend, rng, request):
    """Semi-Lagrangian bilinear advection of a constant is the constant
    (interpolation weights sum to 1) for ANY advecting velocity."""
    const = 0.7321
    d0 = np.full((N + 2, N + 2), const, np.float32)
    u = (0.5 * rng.standard_normal((N + 2, N + 2))).astype(np.float32)
    v = (0.5 * rng.standard_normal((N + 2, N + 2))).astype(np.float32)
    ops = _ops(backend, request)
    got = np.asarray(ops.advect(0, jnp.asarray(d0), jnp.asarray(u),
                                jnp.asarray(v), 0.016, N))
    np.testing.assert_allclose(got[1:-1, 1:-1], const, rtol=0, atol=2e-6)


@pytest.mark.parametrize("backend", GATHERS)
def test_advection_zero_velocity_identity(backend, rng, request):
    """Zero velocity backtraces every cell to itself — bit-identity on
    the interior."""
    d0 = np.zeros((N + 2, N + 2), np.float32)
    d0[1:-1, 1:-1] = rng.standard_normal((N, N)).astype(np.float32)
    zero = np.zeros_like(d0)
    ops = _ops(backend, request)
    got = np.asarray(ops.advect(0, jnp.asarray(d0), jnp.asarray(zero),
                                jnp.asarray(zero), 0.016, N))
    np.testing.assert_array_equal(got[1:-1, 1:-1], d0[1:-1, 1:-1])
