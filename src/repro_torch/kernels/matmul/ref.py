"""Plain PyTorch blocked matmul: the function ``csrc/matmul.cu`` computes
(counterpart of ``repro.kernels.matmul.ref``)."""

from __future__ import annotations

import torch

__all__ = ["matmul_ref"]


def matmul_ref(a, b, *, out_dtype=None):
    """a (M, K) @ b (K, N) with every product and the sum in f32, cast to
    ``out_dtype`` (default a's dtype)."""
    out = torch.matmul(a.float(), b.float())
    return out.to(out_dtype or a.dtype)
