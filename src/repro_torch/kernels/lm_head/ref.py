"""Plain PyTorch LM head: the function the decode LM-head kernel computes
(counterpart of ``repro.kernels.lm_head.ref``)."""

from __future__ import annotations

import torch

__all__ = ["masked_logits_ref", "lm_head_logits_ref"]

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
