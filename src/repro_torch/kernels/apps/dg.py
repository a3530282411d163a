"""The DG shallow-water right-hand side of the paper's DG app: the CUDA
kernels (``csrc/dg.cu``) on CUDA tensors, the plain versions on the CPU
(the counterparts of ``repro.kernels.apps.ops.dg_volume`` and
``dg_surface``).

``dg_volume(q, geom, db, dr, ds)``: ``-(dF/dx + dG/dy) + S`` on nodal
triangles, ``q`` (E, np, 3) conserved variables, ``geom`` (E, 4) affine
factors (rx, sx, ry, sy), ``db`` (E, np, 2) bathymetry gradients,
``dr``/``ds`` (np, np) derivative matrices.

``dg_surface(qm, qp, nrm, lift)``: the local Lax-Friedrichs flux on
pre-gathered face traces ``qm``/``qp`` (E, 3nfp, 3), ``nrm`` (E, 3nfp, 3)
= (nx, ny, fscale), lifted by ``lift`` (np, 3nfp) to (E, np, 3). The face
gather and the wall mirror stay outside the kernel (``SWESolver.rhs``).
"""

from __future__ import annotations

import ctypes

import torch

from .._build import check, load, ptr, stream
from ._common import SMEM_MAX, app_on_cpu

__all__ = ["dg_volume", "dg_surface", "volume_ref", "surface_ref", "GRAV",
           "DEFAULT_EB"]

GRAV = 9.81
DEFAULT_EB = 64  # elements per block: the JAX ops' default
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {"dg_volume": ([_P] * 6 + [_I] * 3 + [_F, _P], _I),
        "dg_surface": ([_P] * 5 + [_I] * 4 + [_F, _P], _I)}


def volume_ref(Q, geom, dB, Dr, Ds, g=GRAV):
    """Plain PyTorch volume RHS: the torch mirror of the JAX oracle
    ``repro.apps.dg_swe.volume_ref``."""
    h, hu, hv = Q[..., 0], Q[..., 1], Q[..., 2]
    u, v = hu / h, hv / h
    gh2 = 0.5 * g * h * h
    F = torch.stack([hu, hu * u + gh2, hu * v], -1)
    G = torch.stack([hv, hu * v, hv * v + gh2], -1)
    dFdx = (geom[:, 0][:, None, None] * torch.einsum("nm,emf->enf", Dr, F)
            + geom[:, 1][:, None, None] * torch.einsum("nm,emf->enf", Ds, F))
    dGdy = (geom[:, 2][:, None, None] * torch.einsum("nm,emf->enf", Dr, G)
            + geom[:, 3][:, None, None] * torch.einsum("nm,emf->enf", Ds, G))
    S = torch.stack([torch.zeros_like(h), -g * h * dB[..., 0],
                     -g * h * dB[..., 1]], -1)
    return -(dFdx + dGdy) + S


def surface_ref(QM, QP, nrm, lift, g=GRAV):
    """Plain PyTorch surface RHS: the torch mirror of the JAX oracle
    ``repro.apps.dg_swe.surface_ref``."""
    nx_, ny_, fsc = nrm[..., 0], nrm[..., 1], nrm[..., 2]

    def flux(Q):
        h, hu, hv = Q[..., 0], Q[..., 1], Q[..., 2]
        u, v = hu / h, hv / h
        gh2 = 0.5 * g * h * h
        Fn = torch.stack([hu * nx_ + hv * ny_,
                          (hu * u + gh2) * nx_ + hu * v * ny_,
                          hu * v * nx_ + (hv * v + gh2) * ny_], -1)
        lam = torch.abs(u * nx_ + v * ny_) + torch.sqrt(g * h)
        return Fn, lam

    FM, lamM = flux(QM)
    FP, lamP = flux(QP)
    C = torch.maximum(lamM, lamP)[..., None]
    fstar = 0.5 * (FM + FP) + 0.5 * C * (QM - QP)
    dflux = (FM - fstar) * fsc[..., None]
    return torch.einsum("nf,efq->enq", lift, dflux)


def _check_eb(name, E, eb, smem):
    if E < 1 or eb < 1 or smem > SMEM_MAX:
        raise ValueError(f"{name}: E={E}, eb={eb}: need E, eb >= 1 and "
                         f"{smem} B of shared memory <= {SMEM_MAX}")


def dg_volume(q, geom, db, dr, ds, *, g=GRAV, eb=DEFAULT_EB):
    """q (E, np, 3), geom (E, 4), db (E, np, 2), dr/ds (np, np) f32 -> the
    volume RHS (E, np, 3). ``eb``: elements per block on the card."""
    name = "dg_volume"
    if app_on_cpu(name, q, geom, db, dr, ds):
        return volume_ref(q, geom, db, dr, ds, g)
    E, np_ = (q.shape[0], q.shape[1]) if q.dim() == 3 else (0, 0)
    if (tuple(q.shape) != (E, np_, 3) or tuple(geom.shape) != (E, 4)
            or tuple(db.shape) != (E, np_, 2)
            or tuple(dr.shape) != (np_, np_) or ds.shape != dr.shape):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, geom "
                         f"{tuple(geom.shape)}, db {tuple(db.shape)}, dr "
                         f"{tuple(dr.shape)}, ds {tuple(ds.shape)} must be "
                         "(E, np, 3), (E, 4), (E, np, 2), (np, np) x 2")
    _check_eb(name, E, eb, 4 * (2 * np_ * np_ + 6 * eb * np_))
    out = torch.empty_like(q)
    lib = load("dg", _SIG)
    err = lib.dg_volume(ptr(q), ptr(geom), ptr(db), ptr(dr), ptr(ds),
                        ptr(out), E, np_, int(eb), float(g), stream())
    check(lib, err, name)
    dg_volume.launches += 1
    return out


def dg_surface(qm, qp, nrm, lift, *, g=GRAV, eb=DEFAULT_EB):
    """qm, qp, nrm (E, 3nfp, 3), lift (np, 3nfp) f32 -> the surface RHS
    (E, np, 3). ``eb``: elements per block on the card."""
    name = "dg_surface"
    if app_on_cpu(name, qm, qp, nrm, lift):
        return surface_ref(qm, qp, nrm, lift, g)
    E, nfp3 = (qm.shape[0], qm.shape[1]) if qm.dim() == 3 else (0, 0)
    np_ = lift.shape[0] if lift.dim() == 2 else 0
    if (tuple(qm.shape) != (E, nfp3, 3) or qp.shape != qm.shape
            or nrm.shape != qm.shape or tuple(lift.shape) != (np_, nfp3)):
        raise ValueError(f"{name}: shapes qm {tuple(qm.shape)}, qp "
                         f"{tuple(qp.shape)}, nrm {tuple(nrm.shape)}, lift "
                         f"{tuple(lift.shape)} must be (E, 3nfp, 3) x 3 and "
                         "(np, 3nfp)")
    _check_eb(name, E, eb, 4 * (np_ * nfp3 + 3 * eb * nfp3))
    out = torch.empty((E, np_, 3), dtype=qm.dtype, device=qm.device)
    lib = load("dg", _SIG)
    err = lib.dg_surface(ptr(qm), ptr(qp), ptr(nrm), ptr(lift), ptr(out), E,
                         np_, nfp3, int(eb), float(g), stream())
    check(lib, err, name)
    dg_surface.launches += 1
    return out


dg_volume.launches = 0
dg_surface.launches = 0
