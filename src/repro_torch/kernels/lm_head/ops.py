"""Public LM-head ops: the CUDA kernels on CUDA tensors, the plain
versions on the CPU (counterparts of ``repro.kernels.lm_head.ops``).

``lm_head_logits(x, w, vocab=)`` (decode, ``csrc/lm_head.cu``) returns the
masked logits; ``lm_head_logits.raw`` returns (logits, row max,
first-occurrence argmax), all from one pass of the kernel. It has no
backward (nor has the JAX op) and raises when asked for a gradient.

``lm_head_ce(x, w, labels, vocab=)`` (training, ``csrc/lm_head_ce.cu``) is
a ``torch.autograd.Function`` on both devices: the forward
(``lm_head_ce.raw``) streams each row's lse and label logit out of the
product without keeping the (R, V) logits, the backward
(``lm_head_bwd``) recomputes ``softmax - onehot`` from the saved lse.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import check, load, on_cpu, ptr, stream
from .ref import lm_head_bwd_ref, lm_head_ce_stats_ref, lm_head_logits_ref

__all__ = ["lm_head_logits", "lm_head_ce", "lm_head_bwd"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {"lm_head": ([_P] * 7 + [_I] * 5 + [_L] * 3 + [_P], _I),
        "lm_head_partials": ([_I], _I)}
_CE_SIG = {"lm_head_ce_splits": ([_I], _I),
           "lm_head_ce_fwd": ([_P] * 6 + [_I] * 5 + [_L] * 3 + [_P], _I),
           "lm_head_ce_bwd": ([_P] * 8 + [_I] * 5 + [_L] * 5 + [_P], _I)}


def _check_head(name, x, w):
    """Checks shared by the LM-head kernels on the card; returns (R, d,
    V)."""
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"{name}: dtypes {x.dtype}/{w.dtype}; both must be "
                         "float32 or bfloat16")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} must be (R, d) and (d, V)")
    if x.stride(1) != 1:
        raise ValueError(f"{name}: the last axis of x must be contiguous")
    return x.shape[0], x.shape[1], w.shape[1]


def _vocab(name, vocab, V, R):
    vocab = V if vocab is None else int(vocab)
    if not 0 < vocab <= V or R == 0:
        raise ValueError(f"{name}: vocab={vocab} outside (0, {V}] or no rows")
    return vocab


def _check_labels(name, labels, x):
    R = x.shape[0]
    if (tuple(labels.shape) != (R, 1) or labels.dtype != torch.int32
            or not labels.is_contiguous() or labels.device != x.device):
        raise ValueError(f"{name}: labels must be contiguous int32 ({R}, 1) "
                         f"on {x.device}, got {tuple(labels.shape)} "
                         f"{labels.dtype} on {labels.device}")


def _raw(x, w, *, vocab=None):
    """x (R, d) @ w (d, V) -> (logits (R, V) f32 with -1e30 on columns
    >= vocab, m (R, 1) f32, arg (R, 1) i32). ``w`` may be any strided view
    (the tied head ``embed.T`` is read in place)."""
    name = "lm_head_logits"
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(
            f"{name} has no backward (nor has the JAX op): call it under "
            "torch.no_grad(), or train through lm_head_ce")
    if on_cpu(name, x, w):
        return lm_head_logits_ref(x, w, vocab=vocab)
    R, d, V = _check_head(name, x, w)
    vocab = _vocab(name, vocab, V, R)
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


def _ce_raw(x, w, labels, *, vocab=None):
    """x (R, d) @ w (d, V) -> (lse (R, 1) f32 over the true vocab, gold
    (R, 1) f32 = each row's label logit). ``w`` may be any strided view
    (the tied head ``embed.T`` is read in place); labels (R, 1) int32."""
    name = "lm_head_ce"
    if on_cpu(name, x, w):
        return lm_head_ce_stats_ref(x, w, labels, vocab=vocab)
    R, d, V = _check_head(name, x, w)
    vocab = _vocab(name, vocab, V, R)
    _check_labels(name, labels, x)
    lib = load("lm_head_ce", _CE_SIG)
    nsplit = lib.lm_head_ce_splits(V)
    dev = x.device
    lse = torch.empty((R, 1), dtype=torch.float32, device=dev)
    gold = torch.empty((R, 1), dtype=torch.float32, device=dev)
    part = torch.empty((3, nsplit, R), dtype=torch.float32, device=dev)
    err = lib.lm_head_ce_fwd(ptr(x), ptr(w), ptr(labels), ptr(lse), ptr(gold),
                             ptr(part), R, d, V, vocab, _DTYPE_CODE[x.dtype],
                             x.stride(0), w.stride(0), w.stride(1), stream())
    check(lib, err, "lm_head_ce_fwd")
    lm_head_ce.launches += 1
    return lse, gold


def lm_head_bwd(x, w, labels, lse, g, *, vocab=None):
    """The CE backward: (dx (R, d) f32, dw (d, V) f32) for the per-row NLL
    cotangent ``g`` (R, 1) f32, recomputed from the forward's ``lse``. On
    the card dw is written in w's memory layout: for the tied head
    ``embed.T`` it is the transposed view of an (V, d) tensor, so the
    embedding's gradient needs no transpose copy."""
    name = "lm_head_bwd"
    if on_cpu(name, x, w):
        return lm_head_bwd_ref(x, w, labels, lse, g, vocab=vocab)
    R, d, V = _check_head(name, x, w)
    vocab = _vocab(name, vocab, V, R)
    _check_labels(name, labels, x)
    for t, n in ((lse, "lse"), (g, "g")):
        if (tuple(t.shape) != (R, 1) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"{name}: {n} must be contiguous f32 ({R}, 1) "
                             f"on {x.device}")
    dev = x.device
    dl = torch.empty((R, V), dtype=torch.float32, device=dev)
    dx = torch.empty((R, d), dtype=torch.float32, device=dev)
    if w.stride(0) == 1 and w.stride(1) != 1:
        dw = torch.empty((V, d), dtype=torch.float32, device=dev).T
    else:
        dw = torch.empty((d, V), dtype=torch.float32, device=dev)
    lib = load("lm_head_ce", _CE_SIG)
    err = lib.lm_head_ce_bwd(ptr(x), ptr(w), ptr(labels), ptr(lse), ptr(g),
                             ptr(dl), ptr(dx), ptr(dw), R, d, V, vocab,
                             _DTYPE_CODE[x.dtype], x.stride(0), w.stride(0),
                             w.stride(1), dw.stride(0), dw.stride(1), stream())
    check(lib, err, "lm_head_ce_bwd")
    lm_head_bwd.launches += 1
    return dx, dw


lm_head_bwd.launches = 0


class _LMHeadCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, vocab):
        lse, gold = _ce_raw(x, w, labels, vocab=vocab)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.vocab = vocab
        return (lse - gold)[:, 0]

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        dx, dw = lm_head_bwd(x, w, labels, lse,
                             g.float().reshape(-1, 1).contiguous(),
                             vocab=ctx.vocab)
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def lm_head_ce(x, w, labels, *, vocab=None):
    """Fused LM-head cross-entropy: x (R, d) @ w (d, V) -> per-row NLL
    ``lse - gold`` (R,) f32, with padded columns >= ``vocab`` excluded.
    labels (R, 1) int32. Differentiable in x and w."""
    return _LMHeadCE.apply(x, w, labels, vocab)


lm_head_ce.raw = _ce_raw
lm_head_ce.launches = 0
