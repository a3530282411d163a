"""Pre-norm dense transformer blocks (GQA attention + SwiGLU MLP) with
init / forward / prefill / paged-decode entry points: the dense ``tblock_*``
half of ``repro.layers.blocks``. MoE, MLA and mamba blocks come in later
slices.

Parameters of ``n`` stacked layers carry a leading ``(n, ...)`` axis, as the
JAX package's scanned stacks do; these functions take ONE layer's slice.
"""

from __future__ import annotations

import torch

from . import attention as attn
from .common import rmsnorm
from .mlp import mlp_forward, mlp_init

__all__ = [
    "tblock_init", "tblock_forward", "tblock_prefill", "tblock_paged_decode",
    "tblock_paged_cache_init",
]


def tblock_init(gen, cfg, dtype, device, *, n):
    """Parameters of ``n`` stacked dense blocks."""
    return {
        "norm1": torch.ones((n, cfg.d_model), dtype=torch.float32,
                            device=device),
        "norm2": torch.ones((n, cfg.d_model), dtype=torch.float32,
                            device=device),
        "attn": attn.gqa_init(gen, cfg, dtype, device, n=n),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device, n=n),
    }


def _ffn(params, x, cfg):
    h = rmsnorm(x, params["norm2"], eps=cfg.norm_eps)
    return mlp_forward(params["mlp"], h)


def tblock_forward(params, x, cfg):
    h = rmsnorm(x, params["norm1"], eps=cfg.norm_eps)
    x = x + attn.gqa_forward(params["attn"], h, cfg)
    return x + _ffn(params, x, cfg)


def tblock_prefill(params, x, cfg, *, max_len=None):
    """Forward + this layer's contiguous cache of ``max_len`` (default: the
    sequence length) slots, in x's dtype: (y, cache)."""
    max_len = max_len or x.shape[1]
    h = rmsnorm(x, params["norm1"], eps=cfg.norm_eps)
    a, (k, v) = attn.gqa_forward(params["attn"], h, cfg, return_kv=True)
    cache = attn.gqa_cache_init(cfg, x.shape[0], max_len, x.dtype, x.device)
    cache = attn.gqa_prefill_cache(cache, k, v, cfg)
    x = x + a
    return x + _ffn(params, x, cfg), cache


def tblock_paged_decode(params, x, cache, cfg, *, table, lens, pos_pages,
                        page_ids, offs):
    h = rmsnorm(x, params["norm1"], eps=cfg.norm_eps)
    a, cache = attn.gqa_paged_decode(params["attn"], h, cache, cfg,
                                     table=table, lens=lens,
                                     pos_pages=pos_pages, page_ids=page_ids,
                                     offs=offs)
    x = x + a
    return x + _ffn(params, x, cfg), cache


def tblock_paged_cache_init(cfg, num_pages, page_size, dtype, device):
    return attn.gqa_paged_cache_init(cfg, num_pages, page_size, dtype, device)
