"""Host-side spectral numerics (numpy, float64) for the paper's SEM/DG apps.

Gauss-Lobatto-Legendre quadrature, Jacobi polynomials, 1D/2D Vandermonde and
differentiation matrices, and Warp&Blend triangle nodes — following
Hesthaven & Warburton, "Nodal Discontinuous Galerkin Methods" (paper ref [14])
and Deville/Fischer/Mund (paper ref [7]). These are trace-time constants
(OCCA 'defines'-level data) consumed by the kernels.

A verbatim copy of ``repro.apps.numerics`` (numpy only): the port imports
nothing of the JAX package, and ``tests/test_torch_apps.py`` holds every
function here equal to the original.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "jacobi_p", "grad_jacobi_p", "jacobi_gq", "jacobi_gl",
    "gll_nodes_weights", "dmatrix_1d", "vandermonde_1d",
    "triangle_nodes", "vandermonde_2d", "dmatrices_2d", "fd_second_derivative_weights",
]


# ---------------------------------------------------------------------------
# Jacobi polynomials (orthonormal on [-1,1] w.r.t. (1-x)^a (1+x)^b)
# ---------------------------------------------------------------------------

def jacobi_p(x: np.ndarray, alpha: float, beta: float, n: int) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    pl = np.zeros((n + 1,) + x.shape)
    gamma0 = (2 ** (alpha + beta + 1) / (alpha + beta + 1)
              * math.gamma(alpha + 1) * math.gamma(beta + 1)
              / math.gamma(alpha + beta + 1))
    pl[0] = 1.0 / math.sqrt(gamma0)
    if n == 0:
        return pl[0]
    gamma1 = (alpha + 1) * (beta + 1) / (alpha + beta + 3) * gamma0
    pl[1] = ((alpha + beta + 2) * x / 2 + (alpha - beta) / 2) / math.sqrt(gamma1)
    if n == 1:
        return pl[1]
    aold = 2.0 / (2 + alpha + beta) * math.sqrt(
        (alpha + 1) * (beta + 1) / (alpha + beta + 3))
    for i in range(1, n):
        h1 = 2 * i + alpha + beta
        anew = 2.0 / (h1 + 2) * math.sqrt(
            (i + 1) * (i + 1 + alpha + beta) * (i + 1 + alpha) * (i + 1 + beta)
            / ((h1 + 1) * (h1 + 3)))
        bnew = -(alpha ** 2 - beta ** 2) / (h1 * (h1 + 2))
        pl[i + 1] = 1.0 / anew * (-aold * pl[i - 1] + (x - bnew) * pl[i])
        aold = anew
    return pl[n]


def grad_jacobi_p(x: np.ndarray, alpha: float, beta: float, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros_like(np.asarray(x, dtype=np.float64))
    return math.sqrt(n * (n + alpha + beta + 1)) * jacobi_p(x, alpha + 1, beta + 1, n - 1)


def jacobi_gq(alpha: float, beta: float, n: int):
    """Gauss quadrature nodes/weights via Golub-Welsch."""
    if n == 0:
        x = np.array([-(alpha - beta) / (alpha + beta + 2)])
        w = np.array([2.0])
        return x, w
    h1 = 2 * np.arange(n + 1) + alpha + beta
    d0 = -(alpha ** 2 - beta ** 2) / (h1 + 2) / h1
    if alpha + beta == 0:
        d0[0] = 0.0
    i = np.arange(1, n + 1)
    d1 = (2.0 / (h1[:-1] + 2)
          * np.sqrt(i * (i + alpha + beta) * (i + alpha) * (i + beta)
                    / (h1[:-1] + 1) / (h1[:-1] + 3)))
    J = np.diag(d0) + np.diag(d1, 1) + np.diag(d1, -1)
    x, V = np.linalg.eigh(J)
    mu0 = (2 ** (alpha + beta + 1) * math.gamma(alpha + 1) * math.gamma(beta + 1)
           / math.gamma(alpha + beta + 2))
    w = (V[0, :] ** 2) * mu0
    return x, w


def jacobi_gl(alpha: float, beta: float, n: int) -> np.ndarray:
    """Gauss-Lobatto nodes (includes endpoints)."""
    if n == 1:
        return np.array([-1.0, 1.0])
    xint, _ = jacobi_gq(alpha + 1, beta + 1, n - 2)
    return np.concatenate([[-1.0], xint, [1.0]])


# ---------------------------------------------------------------------------
# 1D GLL quadrature + differentiation (SEM)
# ---------------------------------------------------------------------------

def _legendre(x: np.ndarray, n: int) -> np.ndarray:
    """Un-normalized Legendre P_n via recurrence."""
    p0 = np.ones_like(x)
    if n == 0:
        return p0
    p1 = x.copy()
    for k in range(1, n):
        p0, p1 = p1, ((2 * k + 1) * x * p1 - k * p0) / (k + 1)
    return p1


def gll_nodes_weights(n: int):
    """N+1 Gauss-Lobatto-Legendre nodes/weights on [-1,1] (degree N basis)."""
    x = jacobi_gl(0.0, 0.0, n)
    w = 2.0 / (n * (n + 1) * _legendre(x, n) ** 2)
    return x, w


def dmatrix_1d(n: int, x: np.ndarray | None = None) -> np.ndarray:
    """Spectral differentiation matrix on GLL nodes (Lagrange basis)."""
    if x is None:
        x, _ = gll_nodes_weights(n)
    ln = _legendre(x, n)
    D = np.zeros((n + 1, n + 1))
    for i in range(n + 1):
        for j in range(n + 1):
            if i != j:
                D[i, j] = ln[i] / (ln[j] * (x[i] - x[j]))
    D[0, 0] = -n * (n + 1) / 4.0
    D[n, n] = n * (n + 1) / 4.0
    return D


def vandermonde_1d(n: int, r: np.ndarray) -> np.ndarray:
    V = np.zeros((len(r), n + 1))
    for j in range(n + 1):
        V[:, j] = jacobi_p(r, 0.0, 0.0, j)
    return V


# ---------------------------------------------------------------------------
# Triangle nodal basis (DG): Warp & Blend nodes + Koornwinder basis
# ---------------------------------------------------------------------------

_ALPHA_OPT = [0.0000, 0.0000, 1.4152, 0.1001, 0.2751, 0.9800, 1.0999,
              1.2832, 1.3648, 1.4773, 1.4959, 1.5743, 1.5770, 1.6223, 1.6258]


def _warp_factor(n: int, rout: np.ndarray) -> np.ndarray:
    lglr = jacobi_gl(0.0, 0.0, n)
    req = np.linspace(-1.0, 1.0, n + 1)
    veq = vandermonde_1d(n, req)
    nr = len(rout)
    pmat = np.zeros((n + 1, nr))
    for i in range(n + 1):
        pmat[i, :] = jacobi_p(rout, 0.0, 0.0, i)
    lmat = np.linalg.solve(veq.T, pmat)
    warp = lmat.T @ (lglr - req)
    zerof = (np.abs(rout) < 1.0 - 1e-10).astype(np.float64)
    sf = 1.0 - (zerof * rout) ** 2
    return warp / sf + warp * (zerof - 1.0)


def triangle_nodes(n: int):
    """Warp&Blend nodes on the reference triangle; returns (r, s)."""
    alpha = _ALPHA_OPT[n - 1] if n < 16 else 5.0 / 3.0
    np_ = (n + 1) * (n + 2) // 2
    L1 = np.zeros(np_)
    L3 = np.zeros(np_)
    sk = 0
    for i in range(n + 1):
        for j in range(n + 1 - i):
            L1[sk] = i / n
            L3[sk] = j / n
            sk += 1
    L2 = 1.0 - L1 - L3
    x = -L2 + L3
    y = (-L2 - L3 + 2 * L1) / math.sqrt(3.0)

    blend1 = 4 * L2 * L3
    blend2 = 4 * L1 * L3
    blend3 = 4 * L1 * L2
    warpf1 = _warp_factor(n, L3 - L2)
    warpf2 = _warp_factor(n, L1 - L3)
    warpf3 = _warp_factor(n, L2 - L1)
    warp1 = blend1 * warpf1 * (1 + (alpha * L1) ** 2)
    warp2 = blend2 * warpf2 * (1 + (alpha * L2) ** 2)
    warp3 = blend3 * warpf3 * (1 + (alpha * L3) ** 2)
    x = x + 1 * warp1 + math.cos(2 * math.pi / 3) * warp2 + math.cos(4 * math.pi / 3) * warp3
    y = y + 0 * warp1 + math.sin(2 * math.pi / 3) * warp2 + math.sin(4 * math.pi / 3) * warp3

    # xy -> rs (barycentric inversion)
    L1b = (math.sqrt(3.0) * y + 1.0) / 3.0
    L2b = (-3.0 * x - math.sqrt(3.0) * y + 2.0) / 6.0
    L3b = (3.0 * x - math.sqrt(3.0) * y + 2.0) / 6.0
    r = -L2b + L3b - L1b
    s = -L2b - L3b + L1b
    return r, s


def _rs_to_ab(r: np.ndarray, s: np.ndarray):
    denom = np.where(np.abs(s - 1.0) > 1e-12, 1.0 - s, 1.0)
    a = np.where(np.abs(s - 1.0) > 1e-12, 2.0 * (1.0 + r) / denom - 1.0, -1.0)
    return a, s


def _simplex_2d_p(a, b, i, j):
    h1 = jacobi_p(a, 0.0, 0.0, i)
    h2 = jacobi_p(b, 2.0 * i + 1.0, 0.0, j)
    return math.sqrt(2.0) * h1 * h2 * (1 - b) ** i


def _grad_simplex_2d_p(a, b, i, j):
    fa = jacobi_p(a, 0.0, 0.0, i)
    dfa = grad_jacobi_p(a, 0.0, 0.0, i)
    gb = jacobi_p(b, 2.0 * i + 1.0, 0.0, j)
    dgb = grad_jacobi_p(b, 2.0 * i + 1.0, 0.0, j)
    # r-derivative
    dmodedr = dfa * gb
    if i > 0:
        dmodedr = dmodedr * (0.5 * (1 - b)) ** (i - 1)
    # s-derivative
    dmodeds = dfa * (gb * (0.5 * (1 + a)))
    if i > 0:
        dmodeds = dmodeds * (0.5 * (1 - b)) ** (i - 1)
    tmp = dgb * (0.5 * (1 - b)) ** i
    if i > 0:
        tmp = tmp - 0.5 * i * gb * (0.5 * (1 - b)) ** (i - 1)
    dmodeds = dmodeds + fa * tmp
    return 2 ** (i + 0.5) * dmodedr, 2 ** (i + 0.5) * dmodeds


def vandermonde_2d(n: int, r: np.ndarray, s: np.ndarray) -> np.ndarray:
    np_ = (n + 1) * (n + 2) // 2
    V = np.zeros((len(r), np_))
    a, b = _rs_to_ab(r, s)
    sk = 0
    for i in range(n + 1):
        for j in range(n + 1 - i):
            V[:, sk] = _simplex_2d_p(a, b, i, j)
            sk += 1
    return V


def dmatrices_2d(n: int, r: np.ndarray, s: np.ndarray):
    """Nodal differentiation matrices Dr, Ds on the reference triangle."""
    np_ = (n + 1) * (n + 2) // 2
    V = vandermonde_2d(n, r, s)
    Vr = np.zeros((len(r), np_))
    Vs = np.zeros((len(r), np_))
    a, b = _rs_to_ab(r, s)
    sk = 0
    for i in range(n + 1):
        for j in range(n + 1 - i):
            Vr[:, sk], Vs[:, sk] = _grad_simplex_2d_p(a, b, i, j)
            sk += 1
    Vinv = np.linalg.inv(V)
    return Vr @ Vinv, Vs @ Vinv, V


# ---------------------------------------------------------------------------
# Finite-difference stencil weights (order-2r central second derivative)
# ---------------------------------------------------------------------------

def fd_second_derivative_weights(r: int) -> np.ndarray:
    """Central FD weights for d2/dx2 with radius r (unit spacing)."""
    k = np.arange(-r, r + 1, dtype=np.float64)
    A = np.vander(k, 2 * r + 1, increasing=True).T  # A[m, j] = k_j^m
    b = np.zeros(2 * r + 1)
    b[2] = 2.0  # match x^2 -> second derivative = 2
    return np.linalg.solve(A, b)


# ---------------------------------------------------------------------------
# DG surface machinery: face masks + LIFT matrix (Hesthaven-Warburton)
# ---------------------------------------------------------------------------

def face_mask(n: int, r: np.ndarray, s: np.ndarray):
    """Node indices on the 3 faces of the reference triangle: s=-1, r+s=0,
    r=-1. Returns (3, Nfp) int array ordered along each face."""
    tol = 1e-10
    f0 = np.where(np.abs(s + 1) < tol)[0]
    f1 = np.where(np.abs(r + s) < tol)[0]
    f2 = np.where(np.abs(r + 1) < tol)[0]
    f0 = f0[np.argsort(r[f0])]
    f1 = f1[np.argsort(-s[f1])]      # along the hypotenuse from (1,-1) to (-1,1)
    f2 = f2[np.argsort(-s[f2])]
    return np.stack([f0, f1, f2])


def lift_matrix(n: int, r: np.ndarray, s: np.ndarray, V: np.ndarray,
                fmask: np.ndarray) -> np.ndarray:
    """LIFT = V V^T Emat: surface integral lifting (Np, 3*Nfp)."""
    np_ = len(r)
    nfp = n + 1
    emat = np.zeros((np_, 3 * nfp))
    for f in range(3):
        idx = fmask[f]
        # affine 1D parameterization along the face (r on f0, s on f1/f2)
        face_r = r[idx] if f == 0 else s[idx]
        v1d_face = vandermonde_1d(n, face_r)
        mass_edge = np.linalg.inv(v1d_face @ v1d_face.T)
        emat[idx, f * nfp:(f + 1) * nfp] = mass_edge
    return V @ (V.T @ emat)
