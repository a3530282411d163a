"""Pre-norm dense transformer blocks (GQA attention + SwiGLU MLP) with
init / forward / prefill / decode / paged-decode entry points, and mamba1
blocks (RMSNorm + mixer) with init / forward / prefill / decode: the dense
``tblock_*`` and the mamba1 ``mamba_block_*`` halves of
``repro.layers.blocks``. MoE, MLA and mamba2 blocks come in later slices.

Parameters of ``n`` stacked layers carry a leading ``(n, ...)`` axis, as the
JAX package's scanned stacks do; these functions take ONE layer's slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssm_scan import ssm_scan_state

from . import attention as attn
from . import mamba as mb
from .common import rmsnorm, silu
from .mlp import mlp_forward, mlp_init

__all__ = [
    "tblock_init", "tblock_forward", "tblock_prefill", "tblock_cache_init",
    "tblock_decode", "tblock_paged_decode", "tblock_paged_cache_init",
    "mamba_block_init", "mamba_block_forward", "mamba_block_cache_init",
    "mamba_block_prefill", "mamba_block_decode",
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


def tblock_cache_init(cfg, batch, max_len, dtype, device):
    return attn.gqa_cache_init(cfg, batch, max_len, dtype, device)


def tblock_prefill(params, x, cfg, *, max_len=None):
    """Forward + this layer's contiguous cache of ``max_len`` (default: the
    sequence length) slots, a rolling window of ``min(max_len, window)``
    slots when ``cfg.window``, in x's dtype: (y, cache)."""
    max_len = max_len or x.shape[1]
    h = rmsnorm(x, params["norm1"], eps=cfg.norm_eps)
    a, (k, v) = attn.gqa_forward(params["attn"], h, cfg, return_kv=True)
    cache = attn.gqa_cache_init(cfg, x.shape[0], max_len, x.dtype, x.device)
    cache = attn.gqa_prefill_cache(cache, k, v, cfg)
    x = x + a
    return x + _ffn(params, x, cfg), cache


def tblock_decode(params, x, cache, cfg, *, pos: int):
    """One-token decode at host position ``pos``; ``cache`` is updated in
    place. Returns (y, cache)."""
    h = rmsnorm(x, params["norm1"], eps=cfg.norm_eps)
    a, cache = attn.gqa_decode(params["attn"], h, cache, cfg, pos=pos)
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


# ---------------------------------------------------------------------------
# mamba1 blocks
# ---------------------------------------------------------------------------

def mamba_block_init(gen, cfg, dtype, device, *, n):
    """Parameters of ``n`` stacked mamba1 blocks."""
    return {
        "norm": torch.ones((n, cfg.d_model), dtype=torch.float32,
                           device=device),
        "mixer": mb.mamba1_init(gen, cfg, dtype, device, n=n),
    }


def mamba_block_forward(params, x, cfg):
    h = rmsnorm(x, params["norm"], eps=cfg.norm_eps)
    return x + mb.mamba1_forward(params["mixer"], h, cfg)


def mamba_block_cache_init(cfg, batch, dtype, device):
    return mb.mamba1_cache_init(cfg, batch, dtype, device)


def mamba_block_prefill(params, x, cfg):
    """Forward + cache (the final SSM state and the conv tail): (y, cache).
    The scan is the state-returning ``ssm_scan_state``: the kernel on the
    card, the plain chunked scan on the CPU (the function the JAX block's
    ``_chunked_scan_jnp`` computes), differentiable on both."""
    h = rmsnorm(x, params["norm"], eps=cfg.norm_eps)
    p = params["mixer"]
    kc = cfg.ssm_conv
    xi = h @ p["in_x"]
    z = h @ p["in_z"]
    tail = xi[:, -(kc - 1):]
    if tail.shape[1] < kc - 1:             # shorter than the conv: zeros
        tail = torch.nn.functional.pad(tail, (0, 0, kc - 1 - tail.shape[1], 0))
    xi = silu(mb._causal_conv(xi, p["conv_w"], p["conv_b"]).to(xi.dtype))
    dt, Bm, Cm = mb._mamba1_dtbc(p, xi, cfg)
    A = -torch.exp(p["A_log"])
    y, hT = ssm_scan_state(xi, dt, A, Bm, Cm, p["D"])
    y = y * silu(z)
    out = x + (y @ p["out_proj"])
    return out, {"conv": tail.to(x.dtype).contiguous(), "h": hT}


def mamba_block_decode(params, x, cache, cfg):
    """One-token decode; ``cache`` is updated in place. Returns (y, cache)."""
    h = rmsnorm(x, params["norm"], eps=cfg.norm_eps)
    y, cache = mb.mamba1_decode(params["mixer"], h, cache, cfg)
    return x + y, cache
