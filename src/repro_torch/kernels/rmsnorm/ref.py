"""Plain PyTorch RMSNorm: the function the CUDA C++ kernel computes."""

from __future__ import annotations

import torch

__all__ = ["rmsnorm_ref"]


def rmsnorm_ref(x, w, *, eps=1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)
