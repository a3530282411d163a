"""The SEM operator of the paper's SEM app: the CUDA kernel
(``csrc/sem.cu``) on CUDA tensors, the plain version on the CPU (the
counterpart of ``repro.kernels.apps.ops.sem_apply``).

``sem_apply(u, geo, dmat)`` returns ``A u = K u + alpha M u`` on local
dofs: ``u`` (E, nq, nq, nq), ``geo`` (E, 7, nq, nq, nq) the symmetric
geometric factors and lumped mass, ``dmat`` (nq, nq) the 1-D GLL
derivative matrix; all f32.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import check, load, ptr, stream
from ._common import app_on_cpu

__all__ = ["sem_apply", "apply_ref", "DEFAULT_EB", "MAX_NQ"]

DEFAULT_EB = 32  # elements per block: the JAX op's default
# csrc/sem.cu's limit: (nq^2 + 4 nq^3) * 4 B of shared memory fits the
# 227 KB a block can have up to nq = 24
MAX_NQ = 24
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"sem_apply": ([_P] * 4 + [_I] * 3 + [_P], _I)}


def apply_ref(u, geo, dmat):
    """Plain PyTorch operator: the torch mirror of the JAX oracle
    ``repro.apps.sem.apply_ref`` (whole-array einsum)."""
    ur = torch.einsum("am,embc->eabc", dmat, u)
    us = torch.einsum("bm,eamc->eabc", dmat, u)
    ut = torch.einsum("cm,eabm->eabc", dmat, u)
    wr = geo[:, 0] * ur + geo[:, 1] * us + geo[:, 2] * ut
    ws = geo[:, 1] * ur + geo[:, 3] * us + geo[:, 4] * ut
    wt = geo[:, 2] * ur + geo[:, 4] * us + geo[:, 5] * ut
    return (torch.einsum("ma,embc->eabc", dmat, wr)
            + torch.einsum("mb,eamc->eabc", dmat, ws)
            + torch.einsum("mc,eabm->eabc", dmat, wt)
            + geo[:, 6] * u)


def sem_apply(u, geo, dmat, *, eb=DEFAULT_EB):
    """u (E, nq, nq, nq), geo (E, 7, nq, nq, nq), dmat (nq, nq) f32 -> A u
    (E, nq, nq, nq). ``eb``: elements per block on the card (E need not be
    a multiple)."""
    name = "sem_apply"
    if app_on_cpu(name, u, geo, dmat):
        return apply_ref(u, geo, dmat)
    E, nq = (u.shape[0], u.shape[1]) if u.dim() == 4 else (0, 0)
    if (tuple(u.shape) != (E, nq, nq, nq)
            or tuple(geo.shape) != (E, 7, nq, nq, nq)
            or tuple(dmat.shape) != (nq, nq)):
        raise ValueError(f"{name}: shapes u {tuple(u.shape)}, geo "
                         f"{tuple(geo.shape)}, dmat {tuple(dmat.shape)} must "
                         "be (E, nq, nq, nq), (E, 7, nq, nq, nq), (nq, nq)")
    if E < 1 or eb < 1 or not 1 <= nq <= MAX_NQ:
        raise ValueError(f"{name}: E={E}, eb={eb}, nq={nq}: need E, eb >= 1 "
                         f"and nq <= {MAX_NQ}")
    out = torch.empty_like(u)
    lib = load("sem", _SIG)
    err = lib.sem_apply(ptr(u), ptr(geo), ptr(dmat), ptr(out), E, nq, int(eb),
                        stream())
    check(lib, err, name)
    sem_apply.launches += 1
    return out


sem_apply.launches = 0
