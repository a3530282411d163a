"""Discontinuous-Galerkin shallow-water solver (the paper's DG app) through
the ``dg_volume`` and ``dg_surface`` kernels: the counterpart of
``repro.apps.dg_swe``.

rhs = -(dF/dx + dG/dy) + S on nodal triangles (the volume kernel) plus the
local Lax-Friedrichs surface flux lifted to the nodes (the surface kernel),
with affine per-element geometric factors, bathymetry source
S = (0, -g h B_x, -g h B_y), reflective walls and 5-stage low-storage RK.
The mesh and connectivity are host-side numpy, copied from the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import fit_block, resolve_device
from ..kernels.apps.dg import (DEFAULT_EB, GRAV, dg_surface, dg_volume,
                               surface_ref, volume_ref)
from .numerics import dmatrices_2d, face_mask, lift_matrix, triangle_nodes

__all__ = [
    "DGVolume", "SWESolver", "make_tri_mesh", "build_connectivity",
    "volume_ref", "surface_ref", "dg_flops_per_element",
    "dg_bytes_per_element", "dg_surface_flops_per_element",
    "dg_surface_bytes_per_element", "GRAV", "stable_dt",
]


def dg_flops_per_element(np_: int) -> int:
    return 4 * 2 * np_ * np_ * 3 + 30 * np_


def dg_bytes_per_element(np_: int, itemsize: int) -> int:
    return (3 + 3 + 2) * np_ * itemsize + 4 * itemsize


def make_tri_mesh(nx: int, ny: int, n: int, *, seed: int = 0, jitter: float = 0.0):
    """Structured triangulation of [-1,1]^2 (2 triangles per quad) with nodal
    coordinates and affine geometric factors. Returns dict of arrays."""
    r, s = triangle_nodes(n)
    Dr, Ds, V = dmatrices_2d(n, r, s)
    np_ = len(r)

    xv = np.linspace(-1, 1, nx + 1)
    yv = np.linspace(-1, 1, ny + 1)
    rng = np.random.RandomState(seed)
    VX, VY = np.meshgrid(xv, yv, indexing="ij")
    if jitter:
        intx = slice(1, nx), slice(1, ny)
        VX = VX.copy(); VY = VY.copy()
        VX[1:nx, 1:ny] += jitter * (2 / nx) * (rng.rand(nx - 1, ny - 1) - 0.5)
        VY[1:nx, 1:ny] += jitter * (2 / ny) * (rng.rand(nx - 1, ny - 1) - 0.5)

    tris = []
    for i in range(nx):
        for j in range(ny):
            v00 = (i, j); v10 = (i + 1, j); v01 = (i, j + 1); v11 = (i + 1, j + 1)
            tris.append((v00, v10, v11))
            tris.append((v00, v11, v01))
    E = len(tris)
    x = np.zeros((E, np_))
    y = np.zeros((E, np_))
    geom = np.zeros((E, 4))
    Js = np.zeros(E)
    for e, (a, b, c) in enumerate(tris):
        xa, ya = VX[a], VY[a]
        xb, yb = VX[b], VY[b]
        xc, yc = VX[c], VY[c]
        # affine map from reference (r,s) in [-1,1] triangle
        x[e] = 0.5 * (-(r + s) * xa + (1 + r) * xb + (1 + s) * xc)
        y[e] = 0.5 * (-(r + s) * ya + (1 + r) * yb + (1 + s) * yc)
        xr, xs = 0.5 * (xb - xa), 0.5 * (xc - xa)
        yr, ys = 0.5 * (yb - ya), 0.5 * (yc - ya)
        J = xr * ys - xs * yr
        assert J > 0, "negative element Jacobian"
        geom[e] = (ys / J, -yr / J, -xs / J, xr / J)  # rx, sx, ry, sy
        Js[e] = J
    return dict(x=x, y=y, geom=geom, J=Js, Dr=Dr, Ds=Ds, V=V, np_=np_, E=E,
                r=r, s=s)


def dg_surface_flops_per_element(np_: int, nfp3: int) -> int:
    # per face node ~80 (two normal fluxes and wave speeds, f*, the jump);
    # per node and component one 3nfp-long dot product with lift
    return 80 * nfp3 + 2 * 3 * np_ * nfp3


def dg_surface_bytes_per_element(np_: int, nfp3: int, itemsize: int) -> int:
    # qm, qp, nrm (3nfp x 3 each) read, (np x 3) written
    return (3 * nfp3 * 3 + np_ * 3) * itemsize


def build_connectivity(nx, ny, n, mesh, seed=0):
    """Face-to-face node maps for the structured triangulation.

    Returns vmapM/vmapP as (E, 3, Nfp) int32 GLOBAL node ids (element-major
    node numbering) with vmapP == vmapM on boundary faces (wall sentinel
    handled via the bc mask), plus per-face normals and Fscale.
    """
    r, s = mesh["r"], mesh["s"]
    nq = n + 1
    fmask = face_mask(n, r, s)
    E, np_ = mesh["E"], mesh["np_"]
    x, y = mesh["x"], mesh["y"]

    # per-face outward normals / surface jacobians from the inverse metric:
    # reference-face normals f0=(0,-1) (s=-1), f1=(1,1) (r+s=0), f2=(-1,0)
    J = mesh["J"]
    rx, sx, ry, sy = (mesh["geom"][:, i] for i in range(4))
    nrm = np.zeros((E, 3, 2))
    sJ = np.zeros((E, 3))
    for f, (nr_, ns_) in enumerate(((0.0, -1.0), (1.0, 1.0), (-1.0, 0.0))):
        nxv = nr_ * rx + ns_ * sx
        nyv = nr_ * ry + ns_ * sy
        mag = np.sqrt(nxv ** 2 + nyv ** 2)
        nrm[:, f, 0] = nxv / mag
        nrm[:, f, 1] = nyv / mag
        sJ[:, f] = mag * J
    fscale = sJ / J[:, None]

    # connectivity by matching face node coordinates
    vmapM = np.zeros((E, 3, nq), np.int64)
    vmapP = np.zeros((E, 3, nq), np.int64)
    for e in range(E):
        for f in range(3):
            vmapM[e, f] = e * np_ + fmask[f]
    # face centers for matching
    fx = x.reshape(E, np_)[:, fmask]          # (E, 3, nfp)
    fy = y.reshape(E, np_)[:, fmask]
    centers = {}
    for e in range(E):
        for f in range(3):
            key = (round(float(fx[e, f].mean()), 8), round(float(fy[e, f].mean()), 8))
            centers.setdefault(key, []).append((e, f))
    boundary = np.zeros((E, 3), bool)
    for key, faces in centers.items():
        if len(faces) == 1:
            e, f = faces[0]
            vmapP[e, f] = vmapM[e, f]
            boundary[e, f] = True
            continue
        (e1, f1), (e2, f2) = faces
        # match nodes by coordinates
        for (ea, fa, eb, fb) in ((e1, f1, e2, f2), (e2, f2, e1, f1)):
            xa, ya = fx[ea, fa], fy[ea, fa]
            xb, yb = fx[eb, fb], fy[eb, fb]
            d2 = (xa[:, None] - xb[None, :]) ** 2 + (ya[:, None] - yb[None, :]) ** 2
            match = d2.argmin(axis=1)
            assert (np.sort(match) == np.arange(nq)).all()
            vmapP[ea, fa] = eb * np_ + fmask[fb][match]
    return dict(fmask=fmask, vmapM=vmapM.astype(np.int32),
                vmapP=vmapP.astype(np.int32), normals=nrm, fscale=fscale,
                boundary=boundary,
                lift=lift_matrix(n, r, s, mesh["V"], fmask))



# low-storage 5-stage RK (Carpenter/Kennedy)
_LSERK_A = (0.0, -567301805773 / 1357537059087, -2404267990393 / 2016746695238,
            -3550918686646 / 2091501179385, -1275806237668 / 842570457699)
_LSERK_B = (1432997174477 / 9575080441755, 5161836677717 / 13612068292357,
            1720146321549 / 2090206949498, 3134564353537 / 4481467310338,
            2277821191437 / 14882151754819)


class DGVolume:
    """Host driver for the DG SWE volume kernel.

    ``eb=None`` takes the op's default block (64 elements) fitted to E with
    ``fit_block``; an explicit ``eb`` pins it (E need not be a multiple).
    Runs on the CUDA card unless ``device="cpu"``."""

    def __init__(self, *, nx: int = 8, ny: int = 8, n: int = 3,
                 eb: int | None = None, bathymetry=None, jitter: float = 0.2,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        m = make_tri_mesh(nx, ny, n, seed=seed, jitter=jitter)
        self.mesh = m
        self.n, self.np_, self.E = n, m["np_"], m["E"]
        self.dtype = np.dtype("float32")

        if bathymetry is None:
            B = np.zeros((self.E, self.np_))
        else:
            B = bathymetry(m["x"], m["y"])
        dBdr = B @ m["Dr"].T
        dBds = B @ m["Ds"].T
        dBdx = m["geom"][:, 0][:, None] * dBdr + m["geom"][:, 1][:, None] * dBds
        dBdy = m["geom"][:, 2][:, None] * dBdr + m["geom"][:, 3][:, None] * dBds
        self.B = B
        self.dB = np.stack([dBdx, dBdy], axis=-1)

        self.geom = self._put(m["geom"])
        self.db = self._put(self.dB)
        self.dr = self._put(m["Dr"])
        self.ds = self._put(m["Ds"])
        self.eb = fit_block(DEFAULT_EB, self.E) if eb is None else eb

    def _put(self, a):
        return torch.from_numpy(np.ascontiguousarray(
            a, dtype=self.dtype)).to(self.device)

    def rhs_volume(self, Q):
        return dg_volume(Q, self.geom, self.db, self.dr, self.ds, eb=self.eb)


class SWESolver(DGVolume):
    """Full shallow-water solver: volume + surface kernels + LSERK."""

    def __init__(self, **kw):
        super().__init__(**kw)
        m = self.mesh
        nx = int(np.sqrt(self.E // 2))
        self.conn = build_connectivity(nx, nx, self.n, m)
        nfp3 = 3 * (self.n + 1)
        self.nfp3 = nfp3
        nrm = np.repeat(self.conn["normals"], self.n + 1, axis=1)  # (E,3nfp,2)
        fsc = np.repeat(self.conn["fscale"], self.n + 1, axis=1)   # (E,3nfp)
        self.nrm = self._put(np.concatenate([nrm, fsc[..., None]], -1))
        self.nrm_xy = self._put(nrm)
        self.lift = self._put(self.conn["lift"])
        dev = self.device
        self.vmapM = torch.from_numpy(
            self.conn["vmapM"].reshape(self.E, nfp3).astype(np.int64)).to(dev)
        self.vmapP = torch.from_numpy(
            self.conn["vmapP"].reshape(self.E, nfp3).astype(np.int64)).to(dev)
        self.bnd = torch.from_numpy(np.repeat(
            self.conn["boundary"], self.n + 1, axis=1)).to(dev)  # (E,3nfp)
        # nodal quadrature weights of the mass matrix, for mass() in f64
        V = m["V"]
        w = np.linalg.inv(V @ V.T) @ np.ones(self.np_)
        self._mass_w = torch.from_numpy(w).to(dev)
        self._mass_J = torch.from_numpy(m["J"]).to(dev)

    def traces(self, Q):
        """The surface kernel's inputs: this element's and the neighbour's
        face values (E, 3nfp, 3), the neighbour's mirrored at walls."""
        Qf = Q.reshape(self.E * self.np_, 3)
        QM = Qf[self.vmapM]                        # (E, 3nfp, 3)
        QP = Qf[self.vmapP]
        # reflective wall: mirror the normal momentum on boundary faces
        nx_, ny_ = self.nrm_xy[..., 0], self.nrm_xy[..., 1]
        qn = QM[..., 1] * nx_ + QM[..., 2] * ny_
        wall = torch.stack([QM[..., 0],
                            QM[..., 1] - 2 * qn * nx_,
                            QM[..., 2] - 2 * qn * ny_], -1)
        return QM, torch.where(self.bnd[..., None], wall, QP)

    def rhs(self, Q):
        QM, QP = self.traces(Q)
        surf = dg_surface(QM, QP, self.nrm, self.lift, eb=self.eb)
        return self.rhs_volume(Q) + surf

    def step(self, Q, dt):
        res = torch.zeros_like(Q)
        for a, b in zip(_LSERK_A, _LSERK_B):
            res = a * res + dt * self.rhs(Q)
            Q = Q + b * res
        return Q

    def mass(self, Q) -> float:
        """Total water volume (exact nodal quadrature via the mass matrix),
        summed in float64 from the f32 state so that a conservation check
        measures the scheme and not the summation."""
        return float(torch.einsum("en,n,e->", Q[..., 0].double(),
                                  self._mass_w, self._mass_J))


def stable_dt(solver: DGVolume, Q) -> float:
    """An LSERK step for the state ``Q``: ``0.5 * hmin / ((N+1)^2 * cmax)``
    with hmin the mesh's shortest element edge and cmax the largest wave
    speed ``|u| + sqrt(g h)`` of ``Q``: the DG operator's largest
    eigenvalues grow like (N+1)^2 cmax / hmin, and 0.5 is a Courant number
    well inside the 5-stage scheme's stability region."""
    m = solver.mesh
    r, s = m["r"], m["s"]
    verts = [int(np.argmin((r - vr) ** 2 + (s - vs) ** 2))
             for vr, vs in ((-1, -1), (1, -1), (-1, 1))]
    x, y = m["x"][:, verts], m["y"][:, verts]
    hmin = min(float(np.hypot(x[:, i] - x[:, j], y[:, i] - y[:, j]).min())
               for i, j in ((0, 1), (1, 2), (2, 0)))
    q = Q.detach().double()
    h = q[..., 0]
    speed = torch.sqrt(q[..., 1] ** 2 + q[..., 2] ** 2) / h + torch.sqrt(
        GRAV * h)
    return 0.5 * hmin / ((solver.n + 1) ** 2 * float(speed.max()))
