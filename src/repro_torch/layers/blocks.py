"""Pre-norm transformer blocks (GQA or MLA attention + a SwiGLU MLP or a
MoE layer) with init / forward / prefill / decode / paged-decode entry
points, and mamba blocks (RMSNorm + a mamba1 or mamba2 mixer, by
``cfg.ssm_type``) with init / forward / prefill / decode: the counterpart
of ``repro.layers.blocks``.

Parameters of ``n`` stacked layers carry a leading ``(n, ...)`` axis, as the
JAX package's scanned stacks do; these functions take ONE layer's slice.
The attention kind follows ``cfg.attn_type``; ``moe=True`` swaps the MLP
for :func:`repro_torch.layers.moe.moe_forward` with ``dispatch``. A MoE
layer's auxiliary losses come out as the (2,) f32 vector [moe_lb_loss,
moe_z_loss] (zeros for a dense layer), as the JAX blocks return them.
"""

from __future__ import annotations

import torch

from . import attention as attn
from . import mamba as mb
from .common import rmsnorm
from .mlp import mlp_forward, mlp_init
from .moe import moe_forward, moe_init

__all__ = [
    "tblock_init", "tblock_forward", "tblock_prefill", "tblock_cache_init",
    "tblock_decode", "tblock_paged_decode", "tblock_paged_cache_init",
    "mamba_block_init", "mamba_block_forward", "mamba_block_cache_init",
    "mamba_block_prefill", "mamba_block_decode",
]


def tblock_init(gen, cfg, dtype, device, *, n, moe=False):
    """Parameters of ``n`` stacked transformer blocks (MoE when ``moe``)."""
    params = {
        "norm1": torch.ones((n, cfg.d_model), dtype=torch.float32,
                            device=device),
        "norm2": torch.ones((n, cfg.d_model), dtype=torch.float32,
                            device=device),
    }
    if cfg.attn_type == "mla":
        params["attn"] = attn.mla_init(gen, cfg, dtype, device, n=n)
    else:
        params["attn"] = attn.gqa_init(gen, cfg, dtype, device, n=n)
    if moe:
        params["moe"] = moe_init(gen, cfg, dtype, device, n=n)
    else:
        params["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device,
                                 n=n)
    return params


def _aux_vec(aux, device):
    if not aux:
        return torch.zeros((2,), dtype=torch.float32, device=device)
    return torch.stack([aux["moe_lb_loss"], aux["moe_z_loss"]]).float()


def _ffn(params, x, cfg, moe, dispatch):
    """The block's second half on the residual x: (y, the MoE layer's aux
    dict, or None for the MLP). The decode paths drop the aux, so a dense
    step allocates no zeros for it."""
    h = rmsnorm(x, params["norm2"], eps=cfg.norm_eps)
    if moe:
        return moe_forward(params["moe"], h, cfg, dispatch=dispatch)
    return mlp_forward(params["mlp"], h, cfg.d_ff), None


def tblock_forward(params, x, cfg, *, moe=False, prefix_len=0,
                   dispatch="einsum"):
    """The block over a full sequence, its first ``prefix_len`` positions
    visible to every query: (y, the auxiliary-loss vector)."""
    h = rmsnorm(x, params["norm1"], eps=cfg.norm_eps)
    if cfg.attn_type == "mla":
        x = x + attn.mla_forward(params["attn"], h, cfg)
    else:
        x = x + attn.gqa_forward(params["attn"], h, cfg,
                                 prefix_len=prefix_len)
    y, aux = _ffn(params, x, cfg, moe, dispatch)
    return x + y, _aux_vec(aux, x.device)


def tblock_cache_init(cfg, batch, max_len, dtype, device):
    if cfg.attn_type == "mla":
        return attn.mla_cache_init(cfg, batch, max_len, dtype, device)
    return attn.gqa_cache_init(cfg, batch, max_len, dtype, device)


def tblock_prefill(params, x, cfg, *, moe=False, dispatch="einsum",
                   max_len=None, prefix_len=0):
    """Forward (the first ``prefix_len`` positions visible to every query)
    + this layer's cache of ``max_len`` (default: the sequence length)
    slots in x's dtype: GQA's contiguous k/v (a rolling window of
    ``min(max_len, window)`` slots when ``cfg.window``) or MLA's latent.
    Returns (y, cache)."""
    max_len = max_len or x.shape[1]
    h = rmsnorm(x, params["norm1"], eps=cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, latent = attn.mla_forward(params["attn"], h, cfg,
                                     return_latent=True)
        cache = attn.mla_cache_init(cfg, x.shape[0], max_len, x.dtype,
                                    x.device)
        cache = attn.mla_prefill_cache(cache, latent, cfg)
    else:
        a, (k, v) = attn.gqa_forward(params["attn"], h, cfg,
                                     prefix_len=prefix_len, return_kv=True,
                                     max_len=max_len)
        cache = attn.gqa_cache_init(cfg, x.shape[0], max_len, x.dtype,
                                    x.device)
        cache = attn.gqa_prefill_cache(cache, k, v, cfg)
    x = x + a
    return x + _ffn(params, x, cfg, moe, dispatch)[0], cache


def tblock_decode(params, x, cache, cfg, *, pos, moe=False,
                  dispatch="einsum", split=None):
    """One-token decode at position ``pos`` (the model's 0-dim device
    ``cache["pos"]``); ``cache`` is updated in place. ``split``: GQA
    decode's split length (``flash_decode``'s; None its rule). Returns
    (y, cache)."""
    h = rmsnorm(x, params["norm1"], eps=cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, cache = attn.mla_decode(params["attn"], h, cache, cfg, pos=pos)
    else:
        a, cache = attn.gqa_decode(params["attn"], h, cache, cfg, pos=pos,
                                   split=split)
    x = x + a
    return x + _ffn(params, x, cfg, moe, dispatch)[0], cache


def tblock_paged_decode(params, x, cache, cfg, *, table, lens, pos_pages,
                        page_ids, offs, moe=False, dispatch="einsum",
                        split=None):
    """``tblock_decode`` over a paged KV pool (GQA only: MLA's latent cache
    is not pageable, ``LM.pageable``)."""
    h = rmsnorm(x, params["norm1"], eps=cfg.norm_eps)
    a, cache = attn.gqa_paged_decode(params["attn"], h, cache, cfg,
                                     table=table, lens=lens,
                                     pos_pages=pos_pages, page_ids=page_ids,
                                     offs=offs, split=split)
    x = x + a
    return x + _ffn(params, x, cfg, moe, dispatch)[0], cache


def tblock_paged_cache_init(cfg, num_pages, page_size, dtype, device):
    return attn.gqa_paged_cache_init(cfg, num_pages, page_size, dtype, device)


# ---------------------------------------------------------------------------
# mamba blocks (mamba1 / mamba2)
# ---------------------------------------------------------------------------

def _mamba2(cfg):
    return cfg.ssm_type == "mamba2"


def mamba_block_init(gen, cfg, dtype, device, *, n):
    """Parameters of ``n`` stacked mamba blocks."""
    init = mb.mamba2_init if _mamba2(cfg) else mb.mamba1_init
    return {
        "norm": torch.ones((n, cfg.d_model), dtype=torch.float32,
                           device=device),
        "mixer": init(gen, cfg, dtype, device, n=n),
    }


def mamba_block_forward(params, x, cfg):
    h = rmsnorm(x, params["norm"], eps=cfg.norm_eps)
    fwd = mb.mamba2_forward if _mamba2(cfg) else mb.mamba1_forward
    return x + fwd(params["mixer"], h, cfg)


def mamba_block_cache_init(cfg, batch, dtype, device):
    init = mb.mamba2_cache_init if _mamba2(cfg) else mb.mamba1_cache_init
    return init(cfg, batch, dtype, device)


def _conv_tail(raw, kc, dtype):
    """The last K - 1 pre-conv rows a decode's conv window starts from;
    a prompt shorter than that leaves zeros in front, as the causal conv
    pads."""
    tail = raw[:, -(kc - 1):]
    if tail.shape[1] < kc - 1:
        tail = torch.nn.functional.pad(tail, (0, 0, kc - 1 - tail.shape[1], 0))
    return tail.to(dtype).contiguous()


def mamba_block_prefill(params, x, cfg):
    """Forward + cache (the final SSM state and the conv tail of the raw
    pre-conv projection, in x's dtype): (y, cache). The scan is the
    state-returning ``ssm_scan_state``: the kernel on the card, the plain
    chunked scan on the CPU, differentiable on both. For mamba1 that is the
    function the JAX block's ``_chunked_scan_jnp`` computes. For mamba2 the
    JAX block's ``_mamba2_forward_with_state`` takes the SSD form; the
    scan's final state (B, di, N) viewed as (B, H, P, N) is the SSD state
    (channel h P + p), and the mixer hands back its pre-conv xBC for the
    tail."""
    h = rmsnorm(x, params["norm"], eps=cfg.norm_eps)
    p = params["mixer"]
    kc = cfg.ssm_conv
    if _mamba2(cfg):
        y, state, raw = mb._mamba2_scan(p, h, cfg)
        return x + y, {"conv": _conv_tail(raw, kc, x.dtype), "h": state}
    y, hT, raw = mb._mamba1_scan(p, h, cfg, state=True)
    return x + y, {"conv": _conv_tail(raw, kc, x.dtype), "h": hT}


def mamba_block_decode(params, x, cache, cfg):
    """One-token decode; ``cache`` is updated in place. Returns (y, cache)."""
    h = rmsnorm(x, params["norm"], eps=cfg.norm_eps)
    dec = mb.mamba2_decode if _mamba2(cfg) else mb.mamba1_decode
    y, cache = dec(params["mixer"], h, cache, cfg)
    return x + y, cache
