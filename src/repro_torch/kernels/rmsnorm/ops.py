"""Public RMSNorm: the Triton kernel on a CUDA tensor, the plain version on
the CPU (the counterpart of ``repro.kernels.rmsnorm.ops.rmsnorm``)."""

from __future__ import annotations

import math

import torch

from . import kernel
from .ref import rmsnorm_ref

__all__ = ["rmsnorm"]

_DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm(x, w, *, eps=1e-6):
    """x: (..., d) f32/bf16; w: (d,). Normalizes the last axis; the output
    has x's dtype and shape."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps=eps)
    if not x.is_cuda or not w.is_cuda or x.device != w.device:
        raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}; both "
                         "must be on one CUDA device (or x on the CPU)")
    d = x.shape[-1]
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm: dtypes {x.dtype}/{w.dtype} not in "
                         f"{_DTYPES}")
    if tuple(w.shape) != (d,) or not w.is_contiguous():
        raise ValueError(f"rmsnorm: w shape {tuple(w.shape)} (contiguous) "
                         f"must be ({d},)")
    if x.numel() == 0:
        return torch.empty_like(x)
    x2 = x.reshape(math.prod(x.shape[:-1]), d)
    if x2.stride(1) != 1:
        raise ValueError("rmsnorm: the last axis of x must be contiguous")
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    kernel.launch(x2, w, out, eps)
    rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0
