"""Public blocked-matmul op: the ``csrc/matmul.cu`` kernel on CUDA tensors,
the plain version on the CPU (counterpart of
``repro.kernels.matmul.ops``).

The JAX op's host path fits its TPU blocks to divisors of the shapes and
raises when that degrades them into a grid too large to build ("degraded
blocks"); that guard belongs to the TPU grid and is not ported: the Hopper
kernel masks ragged tiles itself and takes any M, N and K.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import check, load, on_cpu, ptr, stream
from .ref import matmul_ref

__all__ = ["matmul"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {"matmul": ([_P] * 3 + [_I] * 5 + [_L, _L, _P], _I)}


def matmul(a, b, *, out_dtype=None):
    """a (M, K) @ b (K, N) -> (M, N) in ``out_dtype`` (default a's dtype),
    products summed in f32. a and b share one dtype (float32 or bfloat16 on
    the card). K == 0 or an empty M or N gives zeros without a launch. Records
    no autograd graph, as the JAX op has no VJP."""
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
    err = lib.matmul(ptr(a), ptr(b), ptr(c), m, n, k, _DTYPE_CODE[a.dtype],
                     _DTYPE_CODE[out_dtype], a.stride(0), b.stride(0),
                     stream())
    check(lib, err, name)
    matmul.launches += 1
    return c


matmul.launches = 0
