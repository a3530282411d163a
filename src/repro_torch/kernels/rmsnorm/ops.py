"""Public RMSNorm: the Triton kernel on a CUDA tensor, the plain version on
the CPU (the counterpart of ``repro.kernels.rmsnorm.ops.rmsnorm``).

``rmsnorm`` is a ``torch.autograd.Function`` on both devices: the forward
is the kernel (or the plain version), the backward is autograd through the
plain :func:`rmsnorm_ref` for x and w, as the JAX op's
``vjp=oracle_vjp(rmsnorm_ref, ...)`` is (the JAX package has no rmsnorm
backward kernel).
"""

from __future__ import annotations

import math

import torch

from . import kernel
from .ref import rmsnorm_ref

__all__ = ["rmsnorm"]

_DTYPES = (torch.float32, torch.bfloat16)


def _forward(x, w, eps):
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
    return _RMSNorm.apply(x, w, eps)


rmsnorm.launches = 0
