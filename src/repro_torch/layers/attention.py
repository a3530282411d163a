"""GQA attention (covers MHA/MQA/SWA): init, full-sequence forward, the
contiguous (and rolling-window) cache, one-token decode against it, and
one-token decode over a paged KV pool.

Counterpart of the GQA half of ``repro.layers.attention``. Prefill runs
``flash_attention`` (causal, optional sliding window), static decode
``flash_decode`` (on positional and rotated caches alike) and paged decode ``paged_decode_attention``; each is
the CUDA kernel on a CUDA tensor and the plain version on the CPU.
Prefix-LM masks are not ported yet; ``gqa_forward`` raises for them.

Under ``parallel.use_rules(Rules(mesh=..., ring_axis=...))`` full-sequence
attention runs the sequence-parallel ring (``ring_flash_attention`` with
``mesh``) when the sequence divides the ring: q/k/v are computed on the full,
replicated x at global positions, each rank runs the ring on its sequence
slice, and o is all-gathered along the sequence. This is what GSPMD makes of
the JAX package's replicated x and sequence-sharded q/k/v; the weights stay
replicated. Both steps are autograd Functions whose backward is the other
(slice <-> all-gather), so gradients are the single-device ones on every rank.

Decode takes the position ``pos`` as a host int (the model's ``cache["pos"]``)
and writes the cache IN PLACE (JAX returns a new one), so a step never
reads the device to place its write.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_decode,
                                                 paged_decode_attention,
                                                 ring_flash_attention)
from repro_torch.parallel.context import current_rules
from repro_torch.parallel.rules import ring_axis_for

from .common import dense_init
from .rope import apply_rope

__all__ = [
    "gqa_init", "gqa_forward", "gqa_cache_init", "gqa_prefill_cache",
    "gqa_decode", "gqa_paged_cache_init", "gqa_paged_decode",
]


def _ring_target(seq_len):
    """(mesh, axis) when the ambient rules declare sequence-parallel ring
    attention for this sequence length, else (None, None). Callers opt in
    via ``Rules(ring_axis=...)`` (e.g. ``build_prefill_step(ring=True)``);
    the divisibility guard keeps ragged lengths on the one-device path."""
    rules = current_rules()
    if rules is None or rules.ring_axis is None or rules.mesh is None:
        return None, None
    ax = ring_axis_for(rules.mesh, seq_len, model_axis=rules.ring_axis)
    if ax is None:
        return None, None
    return rules.mesh, ax


def _gather_seq(group, x):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=2)


def _slice_seq(group, x):
    n, i = dist.get_world_size(group), dist.get_rank(group)
    c = x.shape[2] // n
    return x[:, :, i * c:(i + 1) * c]


class _SeqShard(torch.autograd.Function):
    """This rank's slice of a replicated (B, H, S, D) tensor; the backward
    all-gathers the slices' gradients into the full one."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _slice_seq(group, x)

    @staticmethod
    def backward(ctx, g):
        return None, _gather_seq(ctx.group, g)


class _SeqGather(torch.autograd.Function):
    """The ranks' (B, H, S/n, D) slices all-gathered along the sequence; the
    backward keeps this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _gather_seq(group, x)

    @staticmethod
    def backward(ctx, g):
        return None, _slice_seq(ctx.group, g)


def _ring_attention(q, k, v, mesh, axis, window):
    group = mesh.get_group(axis)
    qs, ks, vs = (_SeqShard.apply(group, t) for t in (q, k, v))
    o = ring_flash_attention(qs, ks, vs, mesh=mesh, mesh_axis=axis,
                             causal=True, window=window)
    return _SeqGather.apply(group, o)


def gqa_init(gen, cfg, dtype, device, *, n=None):
    d, h, hk, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    return {
        "wq": dense_init(gen, (d, h * hd), dtype, device, n=n),
        "wk": dense_init(gen, (d, hk * hd), dtype, device, n=n),
        "wv": dense_init(gen, (d, hk * hd), dtype, device, n=n),
        "wo": dense_init(gen, (h * hd, d), dtype, device, n=n),
    }


def _qkv(params, x, cfg):
    """(B, S, d) -> q (B, H, S, hd), k/v (B, Hk, S, hd): strided views of
    the projections (the kernels take the strides as they are)."""
    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(b, s, h, hd).transpose(1, 2)
    k = (x @ params["wk"]).reshape(b, s, hk, hd).transpose(1, 2)
    v = (x @ params["wv"]).reshape(b, s, hk, hd).transpose(1, 2)
    return q, k, v


def gqa_forward(params, x, cfg, *, return_kv=False):
    """Causal full-sequence (prefill) attention, windowed when
    ``cfg.window``; the ring schedule under ring rules. x: (B, S, d_model)."""
    if cfg.prefix_lm:
        raise NotImplementedError(
            "gqa_forward: prefix-LM masks are not ported to the Hopper "
            "prefill kernel yet")
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    if cfg.pos_embed == "rope":
        positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    ring_mesh, ring_ax = _ring_target(s)
    if ring_mesh is not None:
        o = _ring_attention(q, k, v, ring_mesh, ring_ax, cfg.window or None)
    else:
        o = flash_attention(q, k, v, causal=True, window=cfg.window or None)
    y = o.transpose(1, 2).reshape(b, s, -1) @ params["wo"]
    if return_kv:
        return y, (k, v)
    return y


def gqa_cache_init(cfg, batch, max_len, dtype, device):
    """A contiguous cache of ``max_len`` slots (``min(max_len, window)`` for
    a rolling window, whose ``slot_pos`` (m,) i32 maps slots to absolute
    positions, -1 = empty)."""
    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    m = min(max_len, cfg.window) if cfg.window else max_len
    cache = {
        "k": torch.zeros((batch, hk, m, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, hk, m, hd), dtype=dtype, device=device),
    }
    if cfg.window:
        cache["slot_pos"] = torch.full((m,), -1, dtype=torch.int32,
                                       device=device)
    return cache


def gqa_prefill_cache(cache, k, v, cfg):
    """Fill ``cache`` (updated in place) from prefill k/v (B, Hk, S, hd). A
    rolling window shorter than S keeps the last m tokens at slot pos % m."""
    s = k.shape[2]
    m = cache["k"].shape[2]
    if cfg.window and s > m:
        last_pos = torch.arange(s - m, s, device=k.device)
        slots = last_pos % m
        cache["k"][:, :, slots] = k[:, :, -m:].to(cache["k"].dtype)
        cache["v"][:, :, slots] = v[:, :, -m:].to(cache["v"].dtype)
        cache["slot_pos"][slots] = last_pos.to(torch.int32)
        return cache
    n = min(s, m)
    cache["k"][:, :, :n] = k[:, :, :n]
    cache["v"][:, :, :n] = v[:, :, :n]
    if cfg.window:
        cache["slot_pos"][:n] = torch.arange(n, dtype=torch.int32,
                                             device=k.device)
    return cache


def gqa_decode(params, x, cache, cfg, *, pos: int):
    """One-token decode at position ``pos`` (a host int: the tokens already
    in the cache). x: (B, 1, d_model). Writes the new k/v into ``cache`` in
    place: at slot ``pos % m`` of a rolling window (stamping ``slot_pos``),
    else at ``min(pos, m - 1)`` (decoding past the cache is rejected by the
    model before it gets here). Returns (y, cache)."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k1, v1 = _qkv(params, x, cfg)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k1 = apply_rope(k1, pos, cfg.rope_theta)
    m = cache["k"].shape[2]
    if cfg.window:
        write = pos % m
        cache["slot_pos"][write] = pos
        kv_len, slot_pos = pos + 1, cache["slot_pos"]
    else:
        write = min(pos, m - 1)
        kv_len, slot_pos = write + 1, None
    cache["k"][:, :, write] = k1[:, :, 0]
    cache["v"][:, :, write] = v1[:, :, 0]
    o = flash_decode(q, cache["k"], cache["v"], kv_len=kv_len,
                     window=cfg.window or None, slot_pos=slot_pos,
                     sm_scale=hd ** -0.5)
    y = o.transpose(1, 2).reshape(b, 1, -1) @ params["wo"]
    return y, cache


def gqa_paged_cache_init(cfg, num_pages, page_size, dtype, device):
    """Per-layer paged KV pools. Page 0 is the NULL page: idle slots' block
    tables point at it and their per-step writes land there."""
    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (num_pages, hk, page_size, hd)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_paged_decode(params, x, cache, cfg, *, table, lens, pos_pages,
                     page_ids, offs):
    """One-token decode over a PAGED cache. x: (B, 1, d_model).

    ``table`` (B, nsp) i32 names each sequence's pages in logical order,
    ``lens`` (B,) i32 its length (the new token's position), ``pos_pages``
    (P, page) i32 the pool-slot -> position map (already stamped with the
    new token), ``page_ids``/``offs`` (B,) the pool coordinates of this
    step's write. The new k/v are written into the pools IN PLACE (JAX
    returns new pools); returns (y, cache)."""
    b = x.shape[0]
    q, k1, v1 = _qkv(params, x, cfg)
    if cfg.pos_embed == "rope":
        p = lens[:, None, None]                   # per-sequence positions
        q = apply_rope(q, p, cfg.rope_theta)
        k1 = apply_rope(k1, p, cfg.rope_theta)
    kp, vp = cache["kp"], cache["vp"]
    kp[page_ids, :, offs] = k1[:, :, 0].to(kp.dtype)
    vp[page_ids, :, offs] = v1[:, :, 0].to(vp.dtype)
    o = paged_decode_attention(q, kp, vp, block_table=table, kv_len=lens + 1,
                               pos_pages=pos_pages)
    y = o.transpose(1, 2).reshape(b, 1, -1) @ params["wo"]
    return y, cache
