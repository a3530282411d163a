"""The SEM operator of the paper's SEM app: the CUDA kernel
(``csrc/sem.cu``) on CUDA tensors, the plain version on the CPU (the
counterpart of ``repro.kernels.apps.ops.sem_apply``).

``sem_apply(u, geo, dmat)`` returns ``A u = K u + alpha M u`` on local
dofs: ``u`` (E, nq, nq, nq), ``geo`` (E, 7, nq, nq, nq) the symmetric
geometric factors and lumped mass, ``dmat`` (nq, nq) the 1-D GLL
derivative matrix; all f32.

On the card the kernel has an instance for each nq of N = 1..9 (nq
2..10: thread (b, c) of an element owns its column in registers, several
elements side by side, the next element's loads in flight while one
computes) and a generic one for any other nq <= 24, picked up front by
:func:`sem_route` and counted in ``sem_apply.routes``. ``eb`` (elements a
block) assigns elements to blocks and does not change any element's
arithmetic.

``sem_apply_op`` declares it for the op front end (``repro_torch.core``)
under the JAX op's name, over ``repro_torch.apps.sem.sem_builder`` and
tuned over ``eb``; the module also binds the
kernel language's ``sem_ax`` spec to it for the cuda backend
(``core.cuda``).
"""

from __future__ import annotations

import ctypes

import torch

from ...core.cuda import bind_cuda
from ...core.lang import as_dtype
from ...core.device import fit_block
from ...core.op import define_op, oracle_vjp
from ...core.tune import Tolerance
from .._build import check, load, stream
from ._common import app_builder, app_on_cpu, out_for

__all__ = ["sem_apply", "sem_apply_op", "apply_ref", "sem_route",
           "DEFAULT_EB", "MAX_NQ", "TEMPLATED_NQ", "eb_refusal"]

# elements per block: the fastest of 8..128 on the H100 at the SEM app's
# E = 32768 (by 0.5%) and at the PCG solve's E = 512 (3.5x eb = 32, whose
# 16 blocks leave most SMs idle); tools/ab_sem_delta.py --ebs. The JAX
# op's default is 32.
DEFAULT_EB = 8
# csrc/sem.cu's limit: the generic kernel's (nq^2 + 4 nq^3) * 4 B of shared
# memory fits the 227 KB a block can have up to nq = 24
MAX_NQ = 24
# csrc/sem.cu: the nq of the templated instances (N = 1..9)
TEMPLATED_NQ = tuple(range(2, 11))
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"sem_apply": ([_I] + [_P] * 4 + [_I] * 3 + [_P], _I)}
_ENTRY = None   # (library, its sem_apply function), bound on first use


def eb_refusal(E, nq, eb):
    """Why the kernel refuses ``eb`` elements a block at (E, nq), or
    None."""
    if E < 1 or eb < 1 or not 1 <= nq <= MAX_NQ:
        return (f"E={E}, eb={eb}, nq={nq}: need E, eb >= 1 and nq <= "
                f"{MAX_NQ}")
    return None


def sem_route(nq) -> str:
    """``"templated"`` for nq 2..10 (an instance with the element's columns
    in registers, loops unrolled), ``"generic"`` for any other nq."""
    return "templated" if nq in TEMPLATED_NQ else "generic"


def _entry():
    global _ENTRY
    if _ENTRY is None:
        lib = load("sem", _SIG)
        _ENTRY = (lib, lib.sem_apply)
    return _ENTRY


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


def sem_apply(u, geo, dmat, *, eb=DEFAULT_EB, out=None):
    """u (E, nq, nq, nq), geo (E, 7, nq, nq, nq), dmat (nq, nq) f32 -> A u
    (E, nq, nq, nq). ``eb``: elements per block on the card (E need not be
    a multiple). ``out=`` writes into a preallocated tensor (it must not
    alias u or geo) and returns it."""
    name = "sem_apply"
    ts = (u, geo, dmat) if out is None else (u, geo, dmat, out)
    if app_on_cpu(name, *ts):
        au = apply_ref(u, geo, dmat)
        return au if out is None else out.copy_(au)
    E, nq = (u.shape[0], u.shape[1]) if u.dim() == 4 else (0, 0)
    if (tuple(u.shape) != (E, nq, nq, nq)
            or tuple(geo.shape) != (E, 7, nq, nq, nq)
            or tuple(dmat.shape) != (nq, nq)):
        raise ValueError(f"{name}: shapes u {tuple(u.shape)}, geo "
                         f"{tuple(geo.shape)}, dmat {tuple(dmat.shape)} must "
                         "be (E, nq, nq, nq), (E, 7, nq, nq, nq), (nq, nq)")
    refused = eb_refusal(E, nq, eb)
    if refused:
        raise ValueError(f"{name}: {refused}")
    path = sem_route(nq)
    out = out_for(name, out, u.shape, u, u, geo)
    lib, fn = _entry()
    err = fn(path == "templated", u.data_ptr(), geo.data_ptr(),
             dmat.data_ptr(), out.data_ptr(), E, nq, int(eb), stream())
    if err:
        check(lib, err, name)
    sem_apply.launches += 1
    sem_apply.routes[path] += 1
    return out


sem_apply.launches = 0
sem_apply.routes = {"templated": 0, "generic": 0}


# ---------------------------------------------------------------------------
# the op declaration (repro.kernels.apps.ops.sem_apply)
# ---------------------------------------------------------------------------

def _sem_plain(u, geo, dmat):
    return apply_ref(u, geo, dmat)


def _sem_defines(args, params):
    """JAX's ``_sem_defines``: ``eb`` fitted to divide E."""
    u, geo, dmat = args
    E, nq = (int(u.shape[0]), int(u.shape[1])) if u.dim() == 4 else (0, 0)
    if (tuple(u.shape) != (E, nq, nq, nq)
            or tuple(geo.shape) != (E, 7, nq, nq, nq)
            or tuple(dmat.shape) != (nq, nq)):
        raise ValueError(f"sem_apply: shapes u {tuple(u.shape)}, geo "
                         f"{tuple(geo.shape)}, dmat {tuple(dmat.shape)}")
    return dict(E=E, nq=nq, eb=fit_block(params["eb"], E),
                dtype=str(u.dtype).removeprefix("torch."))


def _sem_example(rng):
    E, nq = 8, 3
    u = rng.standard_normal((E, nq, nq, nq)).astype("float32")
    geo = rng.standard_normal((E, 7, nq, nq, nq)).astype("float32")
    dmat = rng.standard_normal((nq, nq)).astype("float32")
    return (u, geo, dmat), dict(eb=4)


sem_apply_op = define_op(
    "sem_apply",
    builder=app_builder("sem", "sem_builder"),
    ref=_sem_plain,
    derive_defines=_sem_defines,
    vjp=oracle_vjp(_sem_plain),
    defaults=dict(eb=DEFAULT_EB),
    tune_ref=lambda args, params: _sem_plain(*args),
    sweep=dict(eb=[1, 2, 4, 8, 16, 32, 64]),
    # the generic kernel's (nq^2 + 4 nq^3) * 4 B; eb does not change it
    smem=lambda d: (d["nq"] ** 2 + 4 * d["nq"] ** 3) * 4,
    refusal=lambda d: eb_refusal(d["E"], d["nq"], d["eb"]),
    tolerance=Tolerance(f32=(2e-4, 2e-4), scaled=True),
    sources=("sem",),
    exact_knobs=True,
    example=_sem_example,
    doc="""A u = K u + alpha M u on local dofs: u (E, nq, nq, nq), geo
    (E, 7, nq, nq, nq), dmat (nq, nq), f32; ``eb`` elements a block.""",
)


# ---------------------------------------------------------------------------
# the cuda binding of the kernel language's "sem_ax" spec (apps/sem.py's
# sem_builder)
# ---------------------------------------------------------------------------

def _spec_refusal(spec, D):
    if as_dtype(D.dtype) != torch.float32:
        return f"dtype {D.dtype}; the kernel takes float32"
    return eb_refusal(D.E, D.nq, D.eb)


def _spec_launch(D, ins, outs):
    return (sem_apply(*ins, eb=D.eb, out=None if outs is None else outs[0]),)


bind_cuda("sem_ax", wrapper=sem_apply, launch=_spec_launch,
          refusal=_spec_refusal, launch_defines=("eb",))
