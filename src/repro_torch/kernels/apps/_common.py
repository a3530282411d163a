"""Checks shared by the app kernels' wrappers."""

from __future__ import annotations

import torch

from .._build import on_cpu

__all__ = ["SMEM_MAX", "app_builder", "app_on_cpu", "out_for"]

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


def out_for(name, out, shape, like, *inputs):
    """The output tensor of a CUDA call: ``out`` checked (its shape, and
    that it aliases none of ``inputs``), or a new tensor of ``shape`` with
    ``like``'s dtype and device. The wrapper has checked out's dtype,
    device and layout with its inputs (:func:`app_on_cpu`)."""
    if out is None:
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"{name}: out {tuple(out.shape)} must be "
                         f"{tuple(shape)}")
    if any(out.data_ptr() == t.data_ptr() for t in inputs):
        raise ValueError(f"{name}: out must not alias an input")
    return out


def app_builder(module: str, name: str):
    """The app builder ``repro_torch.apps.<module>.<name>``, looked up at
    its first call: the app drivers import these modules, so the op
    declarations cannot import their builders at import time. One shim a
    builder, made once, so the Device's kernel cache keys on it."""
    import importlib

    def builder(D):
        return getattr(importlib.import_module(f"repro_torch.apps.{module}"),
                       name)(D)

    builder.__name__ = builder.__qualname__ = name
    return builder
