"""Weights across frameworks: a JAX ``LM.init`` tree, turned into numpy
arrays by the caller, becomes the port's parameter dict with the same tree
paths and the same stacked ``(n, ...)`` layer axis."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map

__all__ = ["from_jax_params", "tree_to"]


def _tensor(a, device):
    a = np.array(a)                       # a writable, contiguous copy
    if a.dtype.name == "bfloat16":        # ml_dtypes bf16: reinterpret bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def from_jax_params(tree, *, device=None):
    """A tree of dicts/lists/tuples of numpy arrays (e.g. a JAX parameter
    tree after ``jax.tree.map(np.asarray, params)``) -> the same tree of
    tensors on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return _tensor(t, dev)

    return conv(tree)


def tree_to(tree, device):
    """Copy a tree of tensors to ``device``."""
    return tree_map(lambda t: t.to(device), tree)
