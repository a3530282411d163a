"""Public blocked-matmul op: the ``csrc/matmul.cu`` kernels on CUDA tensors,
the plain version on the CPU (counterpart of
``repro.kernels.matmul.ops``).

On the card the wrapper picks one of two kernels up front, by
:func:`route` (dtype and layout alone, never after a failure): the
tensor-core kernel (``matmul_tc``: TMA + ``wgmma``, ``csrc/gemm_sm90.cuh``)
or the CUDA-core SGEMM (``matmul``). ``matmul.launches`` counts every launch
and ``matmul.routes`` counts them by route.

The JAX op's host path fits its TPU blocks to divisors of the shapes and
raises when that degrades them into a grid too large to build ("degraded
blocks"); that guard belongs to the TPU grid and is not ported: the Hopper
kernel masks ragged tiles itself and takes any M, N and K.

``matmul_op`` declares it for the op front end (``repro_torch.core``)
under the JAX op's name. Its tiles are template constants (the JAX op
sweeps bm, bn, bk), so it declares no sweep. The module also binds the
kernel language's ``matmul`` spec (``kernel.py``) to it for the cuda
backend (``core.cuda``).
"""

from __future__ import annotations

import ctypes

import torch

from ...core.cuda import bind_cuda
from ...core.device import fit_block
from ...core.lang import as_dtype
from ...core.op import define_op
from .._build import check, load, on_cpu, ptr, stream, tma_ok
from .kernel import matmul_builder
from .ref import matmul_ref

__all__ = ["matmul", "matmul_op", "route"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {"matmul": ([_P] * 3 + [_I] * 5 + [_L, _L, _P], _I),
        "matmul_tc": ([_P] * 3 + [_I] * 4 + [_L, _L, _P], _I)}


def route(a, b) -> str:
    """The kernel a CUDA call of :func:`matmul` launches, from dtype and
    layout alone: ``"wgmma"`` (the tensor-core kernel) when a and b are
    bf16 and TMA can read both (:func:`tma_ok`), else ``"simt"`` (the
    CUDA-core kernel: f32 operands, whose exact f32 products TF32 would
    change, and bf16 views with unaligned rows)."""
    return "wgmma" if tma_ok(a) and tma_ok(b) else "simt"


def matmul(a, b, *, out_dtype=None):
    """a (M, K) @ b (K, N) -> (M, N) in ``out_dtype`` (default a's dtype),
    products summed in f32. a and b share one dtype (float32 or bfloat16 on
    the card). K == 0 or an empty M or N gives zeros without a launch. Records
    no autograd graph, as the JAX op has no VJP. On the card bf16 operands
    run on the tensor cores when :func:`route` says so."""
    name = "matmul"
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"{name}: expected 2-D operands, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"{name}: inner dims disagree ({k} vs {k2})")
    if a.dtype != b.dtype:
        raise ValueError(f"{name}: dtypes disagree ({a.dtype} vs {b.dtype})")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise RuntimeError(f"{name} records no autograd graph; call it under "
                           "torch.no_grad()")
    out_dtype = out_dtype or a.dtype
    cpu = on_cpu(name, a, b)
    if m == 0 or n == 0 or k == 0:  # nothing to tile; K == 0 contracts to 0
        return torch.zeros((m, n), dtype=out_dtype, device=a.device)
    if cpu:
        return matmul_ref(a, b, out_dtype=out_dtype)
    if a.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: the kernel takes float32 or bfloat16 in "
                         f"and out, got {a.dtype} -> {out_dtype}")
    if (a.stride(1) != 1 and k > 1) or (b.stride(1) != 1 and n > 1):
        raise ValueError(f"{name}: the rows of a and b must be contiguous")
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    lib = load("matmul", _SIG)
    path = route(a, b)
    if path == "wgmma":
        err = lib.matmul_tc(ptr(a), ptr(b), ptr(c), m, n, k,
                            _DTYPE_CODE[out_dtype], a.stride(0), b.stride(0),
                            stream())
    else:
        err = lib.matmul(ptr(a), ptr(b), ptr(c), m, n, k,
                         _DTYPE_CODE[a.dtype], _DTYPE_CODE[out_dtype],
                         a.stride(0), b.stride(0), stream())
    check(lib, err, f"{name} ({path})")
    matmul.launches += 1
    matmul.routes[path] += 1
    return c


matmul.launches = 0
matmul.routes = {"wgmma": 0, "simt": 0}


def _early(args, params):
    a, b = args
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"matmul: inner dims disagree ({k} vs {k2})")
    if a.dtype != b.dtype:
        raise ValueError(f"matmul: dtypes disagree ({a.dtype} vs {b.dtype})")
    if m == 0 or n == 0 or k == 0:  # nothing to tile; K == 0 contracts to 0
        return torch.zeros((m, n), dtype=as_dtype(params["out_dtype"]
                                                  or a.dtype),
                           device=a.device)
    return None


def _name(dtype):
    return str(as_dtype(dtype)).removeprefix("torch.")


def _defines(args, params):
    """JAX's ``_defines``: blocks fitted to divide, and a loud error when
    awkward dims degrade them into a huge grid."""
    a, b = args
    (m, k), (_, n) = a.shape, b.shape
    block_m, block_n, block_k = (params["block_m"], params["block_n"],
                                 params["block_k"])
    bm, bk, bn = fit_block(block_m, m), fit_block(block_k, k), \
        fit_block(block_n, n)
    degraded = (bm < min(block_m, m) or bk < min(block_k, k)
                or bn < min(block_n, n))
    if degraded and (m // bm) * (n // bn) * (k // bk) > 1 << 16:
        raise ValueError(
            f"matmul: {m}x{k}x{n} degraded the requested blocks to "
            f"({bm},{bk},{bn}); pad the operands or pass block sizes that "
            "divide the shapes")
    return dict(M=int(m), K=int(k), N=int(n), bm=bm, bk=bk, bn=bn,
                dtype=_name(a.dtype),
                out_dtype=_name(params["out_dtype"] or a.dtype))


def _example(rng):
    a = rng.standard_normal((48, 64)).astype("float32")
    b = rng.standard_normal((64, 32)).astype("float32")
    return (a, b), {}


matmul_op = define_op(
    "matmul",
    builder=matmul_builder,
    ref=matmul_ref,
    derive_defines=_defines,
    early=_early,
    defaults=dict(block_m=128, block_n=128, block_k=128, out_dtype=None),
    ref_params=("out_dtype",),
    sources=("matmul",),
    example=_example,
    doc="""a (M, K) @ b (K, N) with f32 sums over a reduce axis
    (``matmul_builder``). The blocks tile the torch and loops expansions;
    the kernel's tiles are template constants, so it declares no
    sweep.""",
)


# ---------------------------------------------------------------------------
# the cuda binding of the kernel language's "matmul" spec
# (kernel.py's matmul_builder): the kernel's tiles are template constants,
# so bm, bn, bk are not launch arguments; it computes into a tensor of its
# own, copied into the output
# ---------------------------------------------------------------------------

def _spec_refusal(spec, D):
    a, b = spec.inputs
    (c,) = spec.outputs
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE \
            or c.dtype not in _DTYPE_CODE:
        return (f"dtypes {a.dtype} @ {b.dtype} -> {c.dtype}; the kernel "
                f"takes one of {tuple(_DTYPE_CODE)} in and out")
    return None


def _spec_launch(D, ins, outs):
    out_dtype = getattr(D, "out_dtype", None) or D.dtype
    return (matmul(*ins, out_dtype=as_dtype(out_dtype)),)


bind_cuda("matmul", wrapper=matmul, launch=_spec_launch,
          refusal=_spec_refusal, launch_defines=("out_dtype",),
          fixed_defines=("bm", "bn", "bk"), copies=True)
