"""Public RMSNorm: the CUDA kernel (``csrc/rmsnorm.cu``) on a CUDA tensor,
the plain version on the CPU (the counterpart of
``repro.kernels.rmsnorm.ops.rmsnorm``).

The card has two variants of one kernel, picked up front by :func:`route`
from dtype and layout, never after a failure, and counted in
``rmsnorm.routes``: ``"vec"`` (each row in registers, 16-byte loads and
stores) and ``"elem"`` (one element a lane, for rows that 16-byte accesses
cannot serve or that the registers cannot hold).

A decode step calls rmsnorm 33 times on 8 rows, where the host's cost of a
call is the kernel's whole cost, so the card path is lean: the C function
is looked up once and kept, pointers and the stream go as Python ints, the
checks read attributes only, and ``torch.autograd.Function`` runs only
when a gradient is asked. Its backward is autograd through the plain
:func:`rmsnorm_ref` for x and w, as the JAX op's
``vjp=oracle_vjp(rmsnorm_ref, ...)`` is (the JAX package has no rmsnorm
backward kernel).

``rmsnorm_op`` declares it for the op front end (``repro_torch.core``)
under the JAX op's name. The JAX op sweeps block_rows; here a warp takes a
row and the variant follows the layout, so it declares no sweep. The
module also binds the kernel language's ``rmsnorm`` spec (``kernel.py``)
to it for the cuda backend (``core.cuda``).
"""

from __future__ import annotations

import ctypes

import torch

from ...core.cuda import bind_cuda
from ...core.device import fit_block
from ...core.op import define_op, oracle_vjp
from .._build import check, load, on_cpu, stream
from .kernel import rmsnorm_builder
from .ref import rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_op", "route"]

_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ESIZE = (4, 2)         # bytes of an element, by code
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIG = {"rmsnorm": ([_I, _P, _P, _P, _I, _I, _L, _I, _I, _F, _P], _I)}
_MAX_VECS = 32          # csrc/rmsnorm.cu: MAX_NV, 16-byte vectors a lane
_ENTRY = None           # (library, its rmsnorm function), bound on first use


def _vec(d, sx, xp, wp, xes, wes):
    n = 16 // xes                                  # elements a vector of x
    return (d % n == 0 and sx % n == 0 and d <= 32 * n * _MAX_VECS
            and xp % 16 == 0 and wp % min(16, n * wes) == 0)


def route(x2, w) -> str:
    """The variant a CUDA call launches for x2 (rows, d) and w (d,):
    ``"vec"`` when d and x2's row stride are whole 16-byte vectors of x,
    x2 and w start 16-byte aligned (8-byte for a bf16 w under f32 x) and a
    row is at most 32 vectors a lane; ``"elem"`` otherwise."""
    return "vec" if _vec(x2.shape[1], x2.stride(0), x2.data_ptr(),
                         w.data_ptr(), x2.element_size(),
                         w.element_size()) else "elem"


def _entry():
    global _ENTRY
    if _ENTRY is None:
        lib = load("rmsnorm", _SIG)
        _ENTRY = (lib, lib.rmsnorm)
    return _ENTRY


def _forward(x, w, eps):
    if on_cpu("rmsnorm", x, w):
        return rmsnorm_ref(x, w, eps=eps)
    d = x.shape[-1]
    xc, wc = _CODE.get(x.dtype), _CODE.get(w.dtype)
    if xc is None or wc is None:
        raise ValueError(f"rmsnorm: dtypes {x.dtype}/{w.dtype} not in "
                         f"{tuple(_CODE)}")
    if w.shape != (d,) or not w.is_contiguous():
        raise ValueError(f"rmsnorm: w shape {tuple(w.shape)} (contiguous) "
                         f"must be ({d},)")
    numel = x.numel()
    if numel == 0:
        return torch.empty_like(x)
    if x.is_contiguous():                          # (..., d) rows as they are
        x2, sx = x, d
        out = torch.empty_like(x)
    else:
        x2 = x.reshape(-1, d)
        if x2.stride(1) != 1:
            raise ValueError("rmsnorm: the last axis of x must be contiguous")
        sx = x2.stride(0)
        out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    xp, wp = x2.data_ptr(), w.data_ptr()
    vec = _vec(d, sx, xp, wp, _ESIZE[xc], _ESIZE[wc])
    lib, fn = _entry()
    err = fn(vec, xp, wp, out.data_ptr(), numel // d, d, sx, xc, wc, eps,
             stream())
    if err:
        check(lib, err, "rmsnorm")
    rmsnorm.launches += 1
    rmsnorm.routes["vec" if vec else "elem"] += 1
    return out if x2 is x else out.view(x.shape)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _forward(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            wd = w.detach().requires_grad_()
            y = rmsnorm_ref(xd, wd, eps=ctx.eps)
            dx, dw = torch.autograd.grad(y, (xd, wd), g)
        return dx, dw, None


def rmsnorm(x, w, *, eps=1e-6):
    """x: (..., d) f32/bf16; w: (d,). Normalizes the last axis; the output
    has x's dtype and shape. Differentiable in x and w."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps)
    return _forward(x, w, eps)


rmsnorm.launches = 0
rmsnorm.routes = {"vec": 0, "elem": 0}


def _example(rng):
    x = rng.standard_normal((3, 20, 64)).astype("float32")
    w = rng.standard_normal((64,)).astype("float32")
    return (x, w), dict(eps=1e-6)


def _early(args, params):
    x, w = args
    if x.numel() == 0:
        return x.clone()               # empty input: nothing to normalise
    return None


def _pre(args, params):
    x, w = args
    return x.reshape(-1, x.shape[-1]), w


def _defines(args, params):
    x2, w = args
    rows, d = x2.shape
    return dict(rows=int(rows), d=int(d),
                block_rows=fit_block(params["block_rows"], rows),
                eps=float(params["eps"]),
                dtype=str(x2.dtype).removeprefix("torch."),
                wdtype=str(w.dtype).removeprefix("torch."))


def _post(outs, args, params):
    return outs[0].reshape(args[0].shape)


rmsnorm_op = define_op(
    "rmsnorm",
    builder=rmsnorm_builder,
    ref=rmsnorm_ref,
    derive_defines=_defines,
    early=_early,
    pre=_pre,
    post=_post,
    vjp=oracle_vjp(rmsnorm_ref, params=("eps",)),
    defaults=dict(eps=1e-6, block_rows=256),
    ref_params=("eps",),
    sources=("rmsnorm",),
    example=_example,
    doc="""x (..., d) normalised over its last axis times w (d,)
    (``rmsnorm_builder``), differentiable through its plain version. The
    block of rows tiles the torch and loops expansions; a warp takes a row
    in the kernel, so it declares no sweep.""",
)


# ---------------------------------------------------------------------------
# the cuda binding of the kernel language's "rmsnorm" spec (kernel.py's
# rmsnorm_builder): a warp takes a row, so block_rows is not a launch
# argument; the kernel writes a tensor of its own, copied into the output
# ---------------------------------------------------------------------------

def _spec_refusal(spec, D):
    x, w = spec.inputs
    if x.dtype not in _CODE or w.dtype not in _CODE:
        return (f"dtypes {x.dtype}/{w.dtype}; the kernel takes "
                f"{tuple(_CODE)}")
    return None


def _spec_launch(D, ins, outs):
    return (rmsnorm(*ins, eps=D.eps),)


bind_cuda("rmsnorm", wrapper=rmsnorm, launch=_spec_launch,
          refusal=_spec_refusal, launch_defines=("eps",),
          fixed_defines=("block_rows",), copies=True)
