"""Plain PyTorch LM head: the functions the decode LM-head kernel and the
fused cross-entropy kernels compute (counterpart of
``repro.kernels.lm_head.ref``, plus the CE backward of
``lm_head_bwd_builder``)."""

from __future__ import annotations

import torch

__all__ = ["masked_logits_ref", "lm_head_logits_ref", "lm_head_ce_ref",
           "lm_head_ce_stats_ref", "lm_head_bwd_ref", "split_hi_lo",
           "lm_head_bwd_split_ref"]

_PAD_LOGIT = -1e30


def masked_logits_ref(x, w, *, vocab=None):
    """x (R, d) @ w (d, V) in f32, padded columns >= vocab masked to -1e30."""
    V = w.shape[1]
    vocab = V if vocab is None else int(vocab)
    logits = torch.matmul(x.float(), w.float())
    pad = torch.where(torch.arange(V, device=x.device) < vocab, 0.0,
                      _PAD_LOGIT)
    return logits + pad


def lm_head_logits_ref(x, w, *, vocab=None):
    """(masked logits (R, V) f32, row max (R, 1) f32, first-occurrence
    argmax over the true vocab (R, 1) i32)."""
    V = w.shape[1]
    vocab = V if vocab is None else int(vocab)
    logits = masked_logits_ref(x, w, vocab=vocab)
    live = logits[:, :vocab]
    m = live.amax(-1, keepdim=True)
    arg = torch.argmax(live, dim=-1).to(torch.int32)[:, None]
    return logits, m, arg


def lm_head_ce_stats_ref(x, w, labels, *, vocab=None):
    """What the CE forward kernel emits: (lse (R, 1) f32, gold (R, 1) f32),
    the log-sum-exp over the true vocab and each row's label logit (0 for a
    label outside the true vocab, which never matches a valid column)."""
    V = w.shape[1]
    vocab = V if vocab is None else int(vocab)
    logits = masked_logits_ref(x, w, vocab=vocab)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    lab = labels.reshape(-1, 1).long()
    hit = (lab < vocab) & (lab >= 0)
    gold = torch.gather(logits, 1, lab.clamp(0, V - 1))
    return lse, torch.where(hit, gold, 0.0)


def lm_head_ce_ref(x, w, labels, *, vocab=None):
    """Per-row token NLL ``logsumexp(logits) - logits[label]``: (R,) f32."""
    lse, gold = lm_head_ce_stats_ref(x, w, labels, vocab=vocab)
    return (lse - gold)[:, 0]


def _dlogits(x, w, labels, lse, g, vocab):
    V = w.shape[1]
    vocab = V if vocab is None else int(vocab)
    s = torch.matmul(x.float(), w.float())
    valid = torch.arange(V, device=x.device) < vocab
    p = torch.where(valid, torch.exp(s - lse), 0.0)
    hit = (labels.reshape(-1, 1).long()
           == torch.arange(V, device=x.device)) & valid
    return (p - hit.float()) * g


def lm_head_bwd_ref(x, w, labels, lse, g, *, vocab=None):
    """The CE backward, recomputed from the saved lse as the TPU kernel
    does: ``dl = g * (exp(s - lse) - onehot)`` on the true vocab (0 on the
    padded columns), ``dx = dl w^T`` (R, d) f32, ``dw = x^T dl`` (d, V)
    f32. ``lse`` and ``g`` are (R, 1) f32."""
    dl = _dlogits(x, w, labels, lse, g, vocab)
    return torch.matmul(dl, w.float().T), torch.matmul(x.float().T, dl)


def split_hi_lo(t):
    """An f32 tensor as two bf16 planes, ``hi = bf16(t)`` and ``lo =
    bf16(t - hi)``: hi + lo is t within 2^-16 of |t| (each rounding keeps 8
    significant bits, and t - hi is exact in f32)."""
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


def lm_head_bwd_split_ref(x, w, labels, lse, g, *, vocab=None):
    """What the CE backward's tensor-core route computes: dl in f32 as in
    :func:`lm_head_bwd_ref`, split into bf16 planes (:func:`split_hi_lo`),
    and each product taken as the sum of the two planes' products in f32:
    ``dx = hi w^T + lo w^T``, ``dw = x^T hi + x^T lo``. For bf16 x and w
    (exact as f32) it reproduces :func:`lm_head_bwd_ref` to ~2^-16
    relative."""
    hi, lo = split_hi_lo(_dlogits(x, w, labels, lse, g, vocab))
    wt, xt = w.float().T, x.float().T
    return (torch.matmul(hi.float(), wt) + torch.matmul(lo.float(), wt),
            torch.matmul(xt, hi.float()) + torch.matmul(xt, lo.float()))
