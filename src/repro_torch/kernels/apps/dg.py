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

The volume kernel folds the affine factors first (P = rx F + ry G, S = sx
F + sy G; :func:`volume_folded_ref` is its plain model) and keeps the sums
of a group of an element's nodes, for all three fields, in registers. It has an instance for each np of
N = 1..7 and a generic one, picked up front by :func:`volume_route` and
counted in ``dg_volume.routes``. Its wrapper binds the C function once
and passes ints for pointers: at E = 131072 the kernel takes a few tens of
microseconds, and the LSERK step calls it five times. ``eb``
(elements a block) assigns elements to blocks and does not change any
element's arithmetic in either kernel.

``dg_volume_op`` and ``dg_surface_op`` declare them for the op front end
(``repro_torch.core``) under the JAX ops' names, over
``repro_torch.apps.dg_swe``'s builders and tuned over ``eb``; the
module also binds the kernel language's ``dg_swe_volume`` and
``dg_swe_surface`` specs to them for the cuda backend (``core.cuda``).
"""

from __future__ import annotations

import ctypes

import torch

from ...core.cuda import bind_cuda
from ...core.device import fit_block
from ...core.lang import as_dtype
from ...core.op import define_op, oracle_vjp
from ...core.tune import Tolerance
from .._build import check, load, ptr, stream
from ._common import SMEM_MAX, app_builder, app_on_cpu, out_for

__all__ = ["dg_volume", "dg_surface", "dg_volume_op", "dg_surface_op",
           "volume_ref", "volume_folded_ref", "volume_route", "surface_ref",
           "GRAV", "DEFAULT_EB", "volume_refusal", "surface_refusal"]

GRAV = 9.81
DEFAULT_EB = 64  # elements per block: the JAX ops' default
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {"dg_volume": ([_I] + [_P] * 6 + [_I] * 3 + [_F, _P], _I),
        "dg_surface": ([_P] * 5 + [_I] * 4 + [_F, _P], _I)}
# csrc/dg.cu: the np of the templated instances (N = 1..7), elements a chunk
TEMPLATED_NP = (3, 6, 10, 15, 21, 28, 36)
_VOL_EC = 64
_VOL_ENTRY = None   # (library, its dg_volume function), bound on first use


def volume_route(np_) -> str:
    """``"templated"`` for the np of N = 1..7 (an instance with the sums
    of every node in registers, loops unrolled), ``"generic"`` for any
    other np (sums in blocks of 8 nodes)."""
    return "templated" if np_ in TEMPLATED_NP else "generic"


def _r4(n):
    return (n + 3) // 4 * 4


def _volume_smem_at(np_, ec, generic):
    ng = (np_ + 2) // 3
    ngp = (ng + 7) // 8 * 8 if generic else _r4(ng)
    buf = _r4(3 * ec * np_ + 4) + _r4(2 * ec * np_ + 4) + 4 * ec + 4
    return 4 * (6 * np_ * ngp + buf + _r4(6 * np_ * ec)
                + (_r4(3 * ec * np_ + 4) if generic else 0))


def _volume_smem(np_, eb, generic):
    """Shared bytes of a block of the volume kernel (csrc/dg.cu
    ``vol_smem_floats`` at ``vol_chunk``'s chunk): Dr and Ds by node
    group, q, db and geom of a chunk of min(eb, 64) elements (fewer where
    that would pass the card's shared memory), P/S and, on the generic
    instance, the outputs."""
    ec = min(eb, _VOL_EC)
    while ec > 1 and _volume_smem_at(np_, ec, generic) > SMEM_MAX:
        ec -= 1
    return _volume_smem_at(np_, ec, generic)


def _volume_entry():
    global _VOL_ENTRY
    if _VOL_ENTRY is None:
        lib = load("dg", _SIG)
        _VOL_ENTRY = (lib, lib.dg_volume)
    return _VOL_ENTRY


def _surface_smem(np_, nfp3, eb):
    """Shared bytes of a block of the surface kernel: LIFT and a chunk of
    eb elements' three face fluxes."""
    return 4 * (np_ * nfp3 + 3 * eb * nfp3)


def _eb_refusal(E, eb, smem):
    if E < 1 or eb < 1 or smem > SMEM_MAX:
        return (f"E={E}, eb={eb}: need E, eb >= 1 and {smem} B of shared "
                f"memory <= {SMEM_MAX}")
    return None


def volume_refusal(E, np_, eb):
    """Why the volume kernel refuses ``eb`` at (E, np), or None."""
    return _eb_refusal(E, eb, _volume_smem(np_, eb,
                                           volume_route(np_) == "generic"))


def surface_refusal(E, np_, nfp3, eb):
    """Why the surface kernel refuses ``eb`` at (E, np, 3nfp), or None."""
    return _eb_refusal(E, eb, _surface_smem(np_, nfp3, eb))


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


def volume_folded_ref(Q, geom, dB, Dr, Ds, g=GRAV):
    """Plain model of the volume kernel's order, for the tests: the affine
    factors folded first, P = rx F + ry G and S = sx F + sy G per node, then
    the two sums Dr P and Ds S kept apart and added at the end."""
    h, hu, hv = Q[..., 0], Q[..., 1], Q[..., 2]
    u, v = hu / h, hv / h
    gh2 = 0.5 * g * h * h
    F = torch.stack([hu, hu * u + gh2, hu * v], -1)
    G = torch.stack([hv, hu * v, hv * v + gh2], -1)
    rx, sx, ry, sy = (geom[:, i][:, None, None] for i in range(4))
    P, S = rx * F + ry * G, sx * F + sy * G
    src = torch.stack([torch.zeros_like(h), -g * h * dB[..., 0],
                       -g * h * dB[..., 1]], -1)
    return -(torch.einsum("nm,emf->enf", Dr, P)
             + torch.einsum("nm,emf->enf", Ds, S)) + src


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


def dg_volume(q, geom, db, dr, ds, *, g=GRAV, eb=DEFAULT_EB, out=None):
    """q (E, np, 3), geom (E, 4), db (E, np, 2), dr/ds (np, np) f32 -> the
    volume RHS (E, np, 3). ``eb``: elements per block on the card.
    ``out=`` writes into a preallocated tensor (it must not alias q) and
    returns it."""
    name = "dg_volume"
    ts = (q, geom, db, dr, ds) + (() if out is None else (out,))
    if app_on_cpu(name, *ts):
        rhs = volume_ref(q, geom, db, dr, ds, g)
        return rhs if out is None else out.copy_(rhs)
    E, np_ = (q.shape[0], q.shape[1]) if q.dim() == 3 else (0, 0)
    if (tuple(q.shape) != (E, np_, 3) or tuple(geom.shape) != (E, 4)
            or tuple(db.shape) != (E, np_, 2)
            or tuple(dr.shape) != (np_, np_) or ds.shape != dr.shape):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, geom "
                         f"{tuple(geom.shape)}, db {tuple(db.shape)}, dr "
                         f"{tuple(dr.shape)}, ds {tuple(ds.shape)} must be "
                         "(E, np, 3), (E, 4), (E, np, 2), (np, np) x 2")
    path = volume_route(np_)
    refused = volume_refusal(E, np_, eb)
    if refused:
        raise ValueError(f"{name}: {refused}")
    out = out_for(name, out, q.shape, q, q, db)
    lib, fn = _volume_entry()
    err = fn(path == "templated", q.data_ptr(), geom.data_ptr(),
             db.data_ptr(), dr.data_ptr(), ds.data_ptr(), out.data_ptr(), E,
             np_, int(eb), float(g), stream())
    if err:
        check(lib, err, name)
    dg_volume.launches += 1
    dg_volume.routes[path] += 1
    return out


def dg_surface(qm, qp, nrm, lift, *, g=GRAV, eb=DEFAULT_EB, out=None):
    """qm, qp, nrm (E, 3nfp, 3), lift (np, 3nfp) f32 -> the surface RHS
    (E, np, 3). ``eb``: elements per block on the card. ``out=`` writes
    into a preallocated tensor and returns it."""
    name = "dg_surface"
    ts = (qm, qp, nrm, lift) + (() if out is None else (out,))
    if app_on_cpu(name, *ts):
        rhs = surface_ref(qm, qp, nrm, lift, g)
        return rhs if out is None else out.copy_(rhs)
    E, nfp3 = (qm.shape[0], qm.shape[1]) if qm.dim() == 3 else (0, 0)
    np_ = lift.shape[0] if lift.dim() == 2 else 0
    if (tuple(qm.shape) != (E, nfp3, 3) or qp.shape != qm.shape
            or nrm.shape != qm.shape or tuple(lift.shape) != (np_, nfp3)):
        raise ValueError(f"{name}: shapes qm {tuple(qm.shape)}, qp "
                         f"{tuple(qp.shape)}, nrm {tuple(nrm.shape)}, lift "
                         f"{tuple(lift.shape)} must be (E, 3nfp, 3) x 3 and "
                         "(np, 3nfp)")
    refused = surface_refusal(E, np_, nfp3, eb)
    if refused:
        raise ValueError(f"{name}: {refused}")
    out = out_for(name, out, (E, np_, 3), qm, qm, qp, nrm)
    lib = load("dg", _SIG)
    err = lib.dg_surface(ptr(qm), ptr(qp), ptr(nrm), ptr(lift), ptr(out), E,
                         np_, nfp3, int(eb), float(g), stream())
    check(lib, err, name)
    dg_surface.launches += 1
    return out


dg_volume.launches = 0
dg_volume.routes = {"templated": 0, "generic": 0}
dg_surface.launches = 0


# ---------------------------------------------------------------------------
# the op declarations (repro.kernels.apps.ops.dg_volume / dg_surface)
# ---------------------------------------------------------------------------

def _dtype(t):
    return str(t.dtype).removeprefix("torch.")


def _dgv_defines(args, params):
    q, geom, db, dr, ds = args
    E, np_ = (int(q.shape[0]), int(q.shape[1])) if q.dim() == 3 else (0, 0)
    if (tuple(q.shape) != (E, np_, 3) or tuple(geom.shape) != (E, 4)
            or tuple(db.shape) != (E, np_, 2)
            or tuple(dr.shape) != (np_, np_) or ds.shape != dr.shape):
        raise ValueError(f"dg_volume: shapes q {tuple(q.shape)}, geom "
                         f"{tuple(geom.shape)}, db {tuple(db.shape)}, dr "
                         f"{tuple(dr.shape)}, ds {tuple(ds.shape)}")
    return dict(E=E, np_=np_, eb=fit_block(params["eb"], E),
                g=float(params["g"]), dtype=_dtype(q))


def _dgs_defines(args, params):
    qm, qp, nrm, lift = args
    E, nfp3 = (int(qm.shape[0]), int(qm.shape[1])) if qm.dim() == 3 else (
        0, 0)
    np_ = int(lift.shape[0]) if lift.dim() == 2 else 0
    if (tuple(qm.shape) != (E, nfp3, 3) or qp.shape != qm.shape
            or nrm.shape != qm.shape or tuple(lift.shape) != (np_, nfp3)):
        raise ValueError(f"dg_surface: shapes qm {tuple(qm.shape)}, qp "
                         f"{tuple(qp.shape)}, nrm {tuple(nrm.shape)}, lift "
                         f"{tuple(lift.shape)}")
    return dict(E=E, np_=np_, nfp3=nfp3, eb=fit_block(params["eb"], E),
                g=float(params["g"]), dtype=_dtype(qm))


def _dgv_example(rng):
    E, np_ = 16, 6
    q = rng.standard_normal((E, np_, 3)).astype("float32") * 0.1
    q[..., 0] += 1.5                          # positive water height
    geom = rng.standard_normal((E, 4)).astype("float32")
    db = rng.standard_normal((E, np_, 2)).astype("float32")
    dr = rng.standard_normal((np_, np_)).astype("float32")
    ds = rng.standard_normal((np_, np_)).astype("float32")
    return (q, geom, db, dr, ds), dict(eb=4)


def _dgs_example(rng):
    import numpy as np

    E, np_, nfp3 = 16, 6, 9
    qm = rng.standard_normal((E, nfp3, 3)).astype("float32") * 0.1
    qp = rng.standard_normal((E, nfp3, 3)).astype("float32") * 0.1
    qm[..., 0] += 1.5
    qp[..., 0] += 1.5
    theta = rng.standard_normal((E, nfp3)).astype("float32")
    nrm = np.stack([np.cos(theta), np.sin(theta),
                    np.abs(rng.standard_normal((E, nfp3))).astype("float32")],
                   axis=-1).astype("float32")
    lift = rng.standard_normal((np_, nfp3)).astype("float32")
    return (qm, qp, nrm, lift), dict(eb=4)


_EB_SWEEP = [1, 2, 4, 8, 16, 32, 64]

dg_volume_op = define_op(
    "dg_volume",
    builder=app_builder("dg_swe", "dg_volume_builder"),
    ref=volume_ref,
    derive_defines=_dgv_defines,
    vjp=oracle_vjp(volume_ref, params=("g",)),
    defaults=dict(g=GRAV, eb=DEFAULT_EB),
    ref_params=("g",),
    tune_ref=lambda args, params: volume_ref(*args, g=params["g"]),
    sweep=dict(eb=_EB_SWEEP),
    smem=lambda d: _volume_smem(d["np_"], d["eb"],
                                volume_route(d["np_"]) == "generic"),
    refusal=lambda d: volume_refusal(d["E"], d["np_"], d["eb"]),
    tolerance=Tolerance(f32=(2e-4, 2e-4), scaled=True),
    sources=("dg",),
    exact_knobs=True,
    example=_dgv_example,
    doc="""DG SWE volume RHS -(dF/dx + dG/dy) + S: q (E, np, 3), geom
    (E, 4), db (E, np, 2), dr/ds (np, np), f32; ``eb`` elements a
    block.""",
)

dg_surface_op = define_op(
    "dg_surface",
    builder=app_builder("dg_swe", "dg_surface_builder"),
    ref=surface_ref,
    derive_defines=_dgs_defines,
    vjp=oracle_vjp(surface_ref, params=("g",)),
    defaults=dict(g=GRAV, eb=DEFAULT_EB),
    ref_params=("g",),
    tune_ref=lambda args, params: surface_ref(*args, g=params["g"]),
    sweep=dict(eb=_EB_SWEEP),
    smem=lambda d: _surface_smem(d["np_"], d["nfp3"], d["eb"]),
    refusal=lambda d: surface_refusal(d["E"], d["np_"], d["nfp3"], d["eb"]),
    tolerance=Tolerance(f32=(2e-4, 2e-4), scaled=True),
    sources=("dg",),
    exact_knobs=True,
    example=_dgs_example,
    doc="""DG SWE surface RHS: the local Lax-Friedrichs flux on face
    traces qm/qp (E, 3nfp, 3), nrm (E, 3nfp, 3) = (nx, ny, fscale), lifted
    by lift (np, 3nfp), f32; ``eb`` elements a block.""",
)


# ---------------------------------------------------------------------------
# the cuda bindings of the kernel language's "dg_swe_volume" and
# "dg_swe_surface" specs (apps/dg_swe.py's builders)
# ---------------------------------------------------------------------------

def _f32_refusal(D):
    if as_dtype(D.dtype) != torch.float32:
        return f"dtype {D.dtype}; the kernels take float32"
    return None


bind_cuda("dg_swe_volume", wrapper=dg_volume,
          launch=lambda D, ins, outs: (dg_volume(
              *ins, g=D.g, eb=D.eb, out=None if outs is None else outs[0]),),
          refusal=lambda spec, D: _f32_refusal(D) or volume_refusal(
              D.E, D.np_, D.eb),
          launch_defines=("g", "eb"))
bind_cuda("dg_swe_surface", wrapper=dg_surface,
          launch=lambda D, ins, outs: (dg_surface(
              *ins, g=D.g, eb=D.eb, out=None if outs is None else outs[0]),),
          refusal=lambda spec, D: _f32_refusal(D) or surface_refusal(
              D.E, D.np_, D.nfp3, D.eb),
          launch_defines=("g", "eb"))
