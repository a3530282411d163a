"""Spectral-element screened-Coulomb operator (the paper's SEM app) through
the ``sem_apply`` kernel: the counterpart of ``repro.apps.sem``.

Discrete operator  A u = K u + alpha M u  on hexahedral elements with GLL
tensor-product bases:  K u = D_r^T (G . D u)  with per-node symmetric
geometric factors G (kappa * J * w * (grad r_p . grad r_q)) and lumped mass
M = J * w. The mesh and the factors are host-side numpy (float64, then cast),
copied from the JAX package; C0 assembly is a gather and an ``index_add_``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import fit_block, resolve_device
from ..kernels.apps.sem import DEFAULT_EB, apply_ref, sem_apply
from .numerics import dmatrix_1d, gll_nodes_weights

__all__ = [
    "SEMOperator", "make_box_mesh", "geometric_factors", "apply_ref",
    "sem_flops_per_element", "sem_bytes_per_element", "gather", "scatter_add",
]


def sem_flops_per_element(nq: int) -> int:
    return 12 * nq ** 4 + 22 * nq ** 3


def sem_bytes_per_element(nq: int, itemsize: int) -> int:
    return (1 + 7 + 1) * nq ** 3 * itemsize


# ---------------------------------------------------------------------------
# mesh + geometric factors (host-side, float64 -> cast)
# ---------------------------------------------------------------------------

def make_box_mesh(ex: int, ey: int, ez: int, n: int, *, deform: float = 0.0,
                  seed: int = 0):
    """Structured hex mesh of [-1,1]^3, optionally smoothly deformed.

    Returns nodal coords x,y,z of shape (E, nq,nq,nq) and the local->global
    dof map (E, nq,nq,nq) int32 for continuous (C0) assembly.
    """
    nq = n + 1
    gll, _ = gll_nodes_weights(n)
    E = ex * ey * ez

    # global 1D node lines per direction (elements share boundary nodes)
    def line(ne):
        pts = []
        edges = np.linspace(-1, 1, ne + 1)
        for e in range(ne):
            a, b = edges[e], edges[e + 1]
            pts.append((a + b) / 2 + (b - a) / 2 * gll)
        return np.array(pts)  # (ne, nq)

    lx, ly, lz = line(ex), line(ey), line(ez)
    x = np.zeros((E, nq, nq, nq))
    y = np.zeros((E, nq, nq, nq))
    z = np.zeros((E, nq, nq, nq))
    gid = np.zeros((E, nq, nq, nq), dtype=np.int64)
    ngx, ngy, ngz = ex * n + 1, ey * n + 1, ez * n + 1
    e = 0
    for kz in range(ez):
        for ky in range(ey):
            for kx in range(ex):
                # index convention: u[a,b,c] ~ (r,s,t) ~ (x,y,z)
                X = lx[kx][:, None, None]
                Y = ly[ky][None, :, None]
                Z = lz[kz][None, None, :]
                x[e] = np.broadcast_to(X, (nq, nq, nq))
                y[e] = np.broadcast_to(Y, (nq, nq, nq))
                z[e] = np.broadcast_to(Z, (nq, nq, nq))
                ia = kx * n + np.arange(nq)
                ib = ky * n + np.arange(nq)
                ic = kz * n + np.arange(nq)
                gid[e] = (ia[:, None, None] * ngy * ngz
                          + ib[None, :, None] * ngz + ic[None, None, :])
                e += 1
    if deform:
        # smooth, invertible-for-small-amplitude deformation
        x2 = x + deform * np.sin(np.pi * x) * np.cos(np.pi * y) * np.cos(np.pi * z)
        y2 = y + deform * np.cos(np.pi * x) * np.sin(np.pi * y) * np.cos(np.pi * z)
        z2 = z + deform * np.cos(np.pi * x) * np.cos(np.pi * y) * np.sin(np.pi * z)
        x, y, z = x2, y2, z2
    nglob = ngx * ngy * ngz
    return (x, y, z), gid.astype(np.int32), nglob


def geometric_factors(coords, n: int, *, kappa=None, alpha: float = 1.0):
    """Per-node symmetric factors G (E,7,nq,nq,nq): 6 stiffness + 1 mass."""
    x, y, z = coords
    nq = n + 1
    D = dmatrix_1d(n)
    _, w = gll_nodes_weights(n)
    w3 = w[:, None, None] * w[None, :, None] * w[None, None, :]

    def deriv(f, axis):
        return np.einsum("am,embc->eabc" if axis == 0 else
                         ("bm,eamc->eabc" if axis == 1 else "cm,eabm->eabc"), D, f)

    xr, xs, xt = deriv(x, 0), deriv(x, 1), deriv(x, 2)
    yr, ys, yt = deriv(y, 0), deriv(y, 1), deriv(y, 2)
    zr, zs, zt = deriv(z, 0), deriv(z, 1), deriv(z, 2)
    J = (xr * (ys * zt - yt * zs) - yr * (xs * zt - xt * zs)
         + zr * (xs * yt - xt * ys))
    assert np.all(J > 0), "mesh deformation too large (negative Jacobian)"
    rx = (ys * zt - yt * zs) / J
    ry = -(xs * zt - xt * zs) / J
    rz = (xs * yt - xt * ys) / J
    sx = -(yr * zt - yt * zr) / J
    sy = (xr * zt - xt * zr) / J
    sz = -(xr * yt - xt * yr) / J
    tx = (yr * zs - ys * zr) / J
    ty = -(xr * zs - xs * zr) / J
    tz = (xr * ys - xs * yr) / J

    if kappa is None:
        kap = np.ones_like(J)
    else:
        kap = kappa(x, y, z)
    scale = kap * J * w3[None]
    G = np.stack([
        scale * (rx * rx + ry * ry + rz * rz),
        scale * (rx * sx + ry * sy + rz * sz),
        scale * (rx * tx + ry * ty + rz * tz),
        scale * (sx * sx + sy * sy + sz * sz),
        scale * (sx * tx + sy * ty + sz * tz),
        scale * (tx * tx + ty * ty + tz * tz),
        alpha * J * w3[None],
    ], axis=1)
    return G, J * w3[None]


# --- continuous (C0) gather/scatter — paper ref [10] global-local numbering --

def gather(u_glob, gid):
    return u_glob[gid]


def scatter_add(u_loc, gid, nglob):
    """Sum local dofs into ``nglob`` global ones (``index_add_``; on the
    card its atomics add in no fixed order)."""
    return torch.zeros(nglob, dtype=u_loc.dtype, device=u_loc.device
                       ).index_add_(0, gid.reshape(-1), u_loc.reshape(-1))


class SEMOperator:
    """Host driver: the operator's factors on the device and the assembled
    (gather-scatter) operator on global dof vectors.

    ``eb=None`` takes the op's default block (32 elements) fitted to E with
    ``fit_block``; an explicit ``eb`` pins it (E need not be a multiple).
    Runs on the CUDA card unless ``device="cpu"``."""

    def __init__(self, *, ex: int = 2, ey: int = 2, ez: int = 2, n: int = 4,
                 eb: int | None = None, deform: float = 0.15,
                 alpha: float = 1.0, kappa=None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.n, self.nq = n, n + 1
        coords, self.gid, self.nglob = make_box_mesh(ex, ey, ez, n,
                                                     deform=deform, seed=seed)
        self.E = self.gid.shape[0]
        G, self.mass = geometric_factors(coords, n, kappa=kappa, alpha=alpha)
        self.dtype = np.dtype("float32")
        self.geo = torch.from_numpy(G.astype(self.dtype)).to(self.device)
        self.dmat = torch.from_numpy(
            dmatrix_1d(n).astype(self.dtype)).to(self.device)
        self.eb = fit_block(DEFAULT_EB, self.E) if eb is None else eb
        self.gid_t = torch.from_numpy(self.gid.astype(np.int64)).to(self.device)

    def apply_local(self, u_local):
        return sem_apply(u_local, self.geo, self.dmat, eb=self.eb)

    def apply_global(self, u_glob):
        u_loc = gather(u_glob, self.gid_t)
        au_loc = self.apply_local(u_loc)
        return scatter_add(au_loc, self.gid_t, self.nglob)
