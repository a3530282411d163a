"""Checks shared by the app kernels' wrappers."""

from __future__ import annotations

import torch

from .._build import on_cpu

__all__ = ["SMEM_MAX", "app_on_cpu"]

# shared memory one block may use on the H100 (227 KB, opt-in above 48 KB)
SMEM_MAX = 232448


def app_on_cpu(name, *tensors) -> bool:
    """:func:`on_cpu` for the app kernels, which take float32 only (the apps
    are f32 throughout) and, on the card, contiguous tensors."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}; the app kernels take "
                             "float32 only")
    if on_cpu(name, *tensors):
        return True
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: CUDA inputs must be contiguous")
    return False
