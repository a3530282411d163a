"""Public decode LM head: the CUDA kernel (``csrc/lm_head.cu``) on CUDA
tensors, the plain version on the CPU (counterpart of
``repro.kernels.lm_head.ops.lm_head_logits``).

``lm_head_logits(x, w, vocab=)`` returns the masked logits;
``lm_head_logits.raw`` returns (logits, row max, first-occurrence argmax),
all from one pass of the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import check, load, ptr, stream
from .ref import lm_head_logits_ref

__all__ = ["lm_head_logits"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {"lm_head": ([_P] * 7 + [_I] * 5 + [_L] * 3 + [_P], _I),
        "lm_head_partials": ([_I], _I)}


def _raw(x, w, *, vocab=None):
    """x (R, d) @ w (d, V) -> (logits (R, V) f32 with -1e30 on columns
    >= vocab, m (R, 1) f32, arg (R, 1) i32). ``w`` may be any strided view
    (the tied head ``embed.T`` is read in place)."""
    if x.device.type == "cpu":
        return lm_head_logits_ref(x, w, vocab=vocab)
    name = "lm_head_logits"
    if not x.is_cuda or not w.is_cuda or x.device != w.device:
        raise ValueError(f"{name}: x on {x.device}, w on {w.device}; both "
                         "must be on one CUDA device (or x on the CPU)")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"{name}: dtypes {x.dtype}/{w.dtype}; both must be "
                         "float32 or bfloat16")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} must be (R, d) and (d, V)")
    if x.stride(1) != 1:
        raise ValueError(f"{name}: the last axis of x must be contiguous")
    R, d = x.shape
    V = w.shape[1]
    vocab = V if vocab is None else int(vocab)
    if not 0 < vocab <= V or R == 0:
        raise ValueError(f"{name}: vocab={vocab} outside (0, {V}] or no rows")
    lib = load("lm_head", _SIG)
    nblk = lib.lm_head_partials(V)
    dev = x.device
    logits = torch.empty((R, V), dtype=torch.float32, device=dev)
    m = torch.empty((R, 1), dtype=torch.float32, device=dev)
    arg = torch.empty((R, 1), dtype=torch.int32, device=dev)
    part_m = torch.empty((nblk, R), dtype=torch.float32, device=dev)
    part_arg = torch.empty((nblk, R), dtype=torch.int32, device=dev)
    err = lib.lm_head(ptr(x), ptr(w), ptr(logits), ptr(m), ptr(arg),
                      ptr(part_m), ptr(part_arg), R, d, V, vocab,
                      _DTYPE_CODE[x.dtype], x.stride(0), w.stride(0),
                      w.stride(1), stream())
    check(lib, err, "lm_head")
    lm_head_logits.launches += 1
    return logits, m, arg


def lm_head_logits(x, w, *, vocab=None):
    """The masked logits of :func:`lm_head_logits.raw`."""
    return _raw(x, w, vocab=vocab)[0]


lm_head_logits.raw = _raw
lm_head_logits.launches = 0
