"""GQA attention (covers MHA/MQA/SWA): init, full-sequence forward, the
contiguous (and rolling-window) cache, one-token decode against it, and
one-token decode over a paged KV pool; and MLA (deepseek-v2: a latent KV
cache, prefill through ``flash_attention`` at d_qk = nope + rope, d_v =
v_head_dim, and the absorbed decode).

Counterpart of ``repro.layers.attention``. Prefill runs
``flash_attention`` (causal, optional sliding window and prefix-LM
prefix), static decode ``flash_decode`` (on positional and rotated caches
alike) and paged decode ``paged_decode_attention``; each is the CUDA
kernel on a CUDA tensor and the plain version on the CPU.

Under ``parallel.use_rules(Rules(mesh=..., ring_axis=...))`` full-sequence
attention runs the sequence-parallel ring (``ring_flash_attention`` with
``mesh``) when the sequence divides the ring: q/k/v are computed on the full,
replicated x at global positions, each rank runs the ring on its sequence
slice, and o is all-gathered along the sequence. This is what GSPMD makes of
the JAX package's replicated x and sequence-sharded q/k/v; the weights stay
replicated. Both steps are autograd Functions whose backward is the other
(slice <-> all-gather), so gradients are the single-device ones on every rank.

Decode takes the position ``pos`` as the model's ``cache["pos"]``, a 0-dim
int32 tensor on the cache's device (a host int is copied there), and
writes the cache IN PLACE (JAX returns a new one) through index writes at
a slot computed on the device: a step never reads the device, so it can
be captured into a CUDA graph and replayed at the next position.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_decode,
                                                 paged_decode_attention,
                                                 ring_flash_attention)
from repro_torch.parallel.context import current_rules, shard_activation
from repro_torch.parallel.rules import ring_axis_for

from .common import dense_init, rmsnorm
from .rope import apply_rope

__all__ = [
    "gqa_init", "gqa_forward", "gqa_cache_init", "gqa_prefill_cache",
    "gqa_decode", "gqa_paged_cache_init", "gqa_paged_decode",
    "mla_init", "mla_forward", "mla_cache_init", "mla_prefill_cache",
    "mla_decode",
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


def _ring_attention(q, k, v, mesh, axis, window, prefix_len):
    group = mesh.get_group(axis)
    qs, ks, vs = (_SeqShard.apply(group, t) for t in (q, k, v))
    o = ring_flash_attention(qs, ks, vs, mesh=mesh, mesh_axis=axis,
                             causal=True, window=window,
                             prefix_len=prefix_len)
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


def gqa_forward(params, x, cfg, *, prefix_len=0, return_kv=False):
    """Causal full-sequence (prefill) attention, windowed when
    ``cfg.window``, with the first ``prefix_len`` positions visible to every
    query (the prefix-LM mask); the ring schedule under ring rules.
    x: (B, S, d_model)."""
    b, s, _ = x.shape
    x = shard_activation(x, "act_btd")
    q, k, v = _qkv(params, x, cfg)
    if cfg.pos_embed == "rope":
        positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    ring_mesh, ring_ax = _ring_target(s)
    if ring_mesh is not None:
        o = _ring_attention(q, k, v, ring_mesh, ring_ax, cfg.window or None,
                            prefix_len)
    else:
        o = flash_attention(q, k, v, causal=True, window=cfg.window or None,
                            prefix_len=prefix_len)
    y = shard_activation(o.transpose(1, 2).reshape(b, s, -1) @ params["wo"],
                         "act_btd", partial=True)
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


def _position(pos, device):
    """The decode position as a 0-dim int32 tensor on ``device``: the
    model's ``cache["pos"]`` as it is, or a host int copied there."""
    if torch.is_tensor(pos):
        return pos.to(torch.int32)
    return torch.full((), pos, dtype=torch.int32, device=device)


def gqa_decode(params, x, cache, cfg, *, pos, split=None):
    """One-token decode at position ``pos`` (the tokens already in the
    cache: a 0-dim int32 tensor on x's device, or a host int). x: (B, 1,
    d_model). Writes the new k/v into ``cache`` in place: at slot
    ``pos % m`` of a rolling window (stamping ``slot_pos``), else at
    ``min(pos, m - 1)`` (decoding past the cache is rejected by the model
    before it gets here); the slot and ``kv_len`` stay on the device.
    ``split`` goes to ``flash_decode``. Returns (y, cache)."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    pos = _position(pos, x.device)
    x = shard_activation(x, "act_btd")
    q, k1, v1 = _qkv(params, x, cfg)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k1 = apply_rope(k1, pos, cfg.rope_theta)
    m = cache["k"].shape[2]
    if cfg.window:
        write = torch.remainder(pos, m)
        kv_len, slot_pos = pos + 1, cache["slot_pos"]
    else:
        write = torch.clamp(pos, max=m - 1)
        kv_len, slot_pos = write + 1, None
    idx = write.reshape(1).long()
    if slot_pos is not None:
        slot_pos.index_copy_(0, idx, pos.reshape(1))
    cache["k"].index_copy_(2, idx, k1.to(cache["k"].dtype))
    cache["v"].index_copy_(2, idx, v1.to(cache["v"].dtype))
    o = flash_decode(q, cache["k"], cache["v"], kv_len=kv_len.reshape(1),
                     window=cfg.window or None, slot_pos=slot_pos,
                     sm_scale=hd ** -0.5, split=split)
    y = shard_activation(o.transpose(1, 2).reshape(b, 1, -1) @ params["wo"],
                         "act_btd", partial=True)
    return y, cache


def gqa_paged_cache_init(cfg, num_pages, page_size, dtype, device):
    """Per-layer paged KV pools. Page 0 is the NULL page: idle slots' block
    tables point at it and their per-step writes land there."""
    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (num_pages, hk, page_size, hd)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_paged_decode(params, x, cache, cfg, *, table, lens, pos_pages,
                     page_ids, offs, split=None):
    """One-token decode over a PAGED cache. x: (B, 1, d_model).

    ``table`` (B, nsp) i32 names each sequence's pages in logical order,
    ``lens`` (B,) i32 its length (the new token's position), ``pos_pages``
    (P, page) i32 the pool-slot -> position map (already stamped with the
    new token), ``page_ids``/``offs`` (B,) the pool coordinates of this
    step's write. The new k/v are written into the pools IN PLACE (JAX
    returns new pools); ``split`` goes to ``paged_decode_attention``.
    Returns (y, cache)."""
    b = x.shape[0]
    x = shard_activation(x, "act_btd")
    q, k1, v1 = _qkv(params, x, cfg)
    if cfg.pos_embed == "rope":
        p = lens[:, None, None]                   # per-sequence positions
        q = apply_rope(q, p, cfg.rope_theta)
        k1 = apply_rope(k1, p, cfg.rope_theta)
    kp, vp = cache["kp"], cache["vp"]
    kp[page_ids, :, offs] = k1[:, :, 0].to(kp.dtype)
    vp[page_ids, :, offs] = v1[:, :, 0].to(vp.dtype)
    o = paged_decode_attention(q, kp, vp, block_table=table, kv_len=lens + 1,
                               pos_pages=pos_pages, split=split)
    y = shard_activation(o.transpose(1, 2).reshape(b, 1, -1) @ params["wo"],
                         "act_btd", partial=True)
    return y, cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v2): latent-compressed KV; absorbed decode
# ---------------------------------------------------------------------------

def mla_init(gen, cfg, dtype, device, *, n=None):
    d, h = cfg.d_model, cfg.n_heads
    nope, rope, dv, lora = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                            cfg.kv_lora_rank)
    lead = () if n is None else (n,)
    return {
        "wq": dense_init(gen, (d, h * (nope + rope)), dtype, device, n=n),
        "wkv_a": dense_init(gen, (d, lora + rope), dtype, device, n=n),
        "kv_norm": torch.ones((*lead, lora), dtype=torch.float32,
                              device=device),
        "wkv_b": dense_init(gen, (lora, h * (nope + dv)), dtype, device, n=n),
        "wo": dense_init(gen, (h * dv, d), dtype, device, n=n),
    }


def _mla_qkr(params, x, cfg, positions):
    """Project to per-head q (nope and rope parts, (B, H, S, .)) and the
    shared latent: c_kv (B, S, lora), normalised by rmsnorm on the strided
    view of the projection, and k_rope (B, 1, S, rope)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope, lora = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    q = (x @ params["wq"]).reshape(b, s, h, nope + rope).transpose(1, 2)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = x @ params["wkv_a"]                          # (B, S, lora + rope)
    c_kv = rmsnorm(kv_a[..., :lora], params["kv_norm"], eps=cfg.norm_eps)
    k_rope = kv_a[..., None, lora:].transpose(1, 2)    # (B, 1, S, rope)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(params, x, cfg, *, return_latent=False):
    """Causal full-sequence MLA: per-head k and v expanded from the latent,
    attention through ``flash_attention`` at d_qk = nope + rope and d_v =
    v_head_dim (v a strided view of the expansion). x: (B, S, d_model).
    ``return_latent`` also returns (c_kv (B, S, lora), k_rope (B, S, rope))
    for the cache."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    positions = torch.arange(s, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(params, x, cfg, positions)
    kv = (c_kv @ params["wkv_b"]).reshape(b, s, h, nope + dv).transpose(1, 2)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q = torch.cat([q_nope, q_rope], dim=-1)             # (B, H, S, nope+rope)
    k = torch.cat([k_nope, k_rope.expand(b, h, s, rope)], dim=-1)
    o = flash_attention(q, k, v, causal=True)
    y = o.transpose(1, 2).reshape(b, s, -1) @ params["wo"]
    if return_latent:
        return y, (c_kv, k_rope[:, 0])
    return y


def mla_cache_init(cfg, batch, max_len, dtype, device):
    """The latent cache of ``max_len`` slots: ckv (B, m, lora) and krope
    (B, m, rope); the position is the model's ``cache["pos"]``."""
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                             device=device),
    }


def mla_prefill_cache(cache, latent, cfg):
    """Write the prefill's latent (c_kv, k_rope) into slots [0, S) of
    ``cache``, in place."""
    c_kv, k_rope = latent
    s = c_kv.shape[1]
    cache["ckv"][:, :s] = c_kv
    cache["krope"][:, :s] = k_rope
    return cache


def _bmm_f32(a, b):
    """Batched ``a @ b`` with an f32 result, the JAX op's
    ``preferred_element_type=jnp.float32``. On the card, bf16 or f16
    operands are multiplied as stored (``out_dtype``: no f32 copy of the
    latent cache or the weights); the CPU's matmul has no ``out_dtype`` and
    multiplies f32 copies (the same products, exact in f32; only the sums'
    order differs)."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype in (torch.bfloat16,
                                                        torch.float16):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def mla_decode(params, x, cache, cfg, *, pos):
    """Absorbed-matmul decode at position ``pos`` (as :func:`gqa_decode`
    takes it): scores and outputs in latent space (W_uk folded into q, W_uv
    into the output), so the cache stays (lora + rope) wide. x: (B, 1,
    d_model). The new latent goes into slot ``min(pos, m - 1)`` of
    ``cache`` in place, the slot and the mask computed on the device; the
    products have f32 results and are cast where the JAX layer casts.
    Returns (y, cache)."""
    b = x.shape[0]
    h = cfg.n_heads
    nope, rope, dv, lora = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                            cfg.kv_lora_rank)
    pos = _position(pos, x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(params, x, cfg, pos)
    ckv, krope = cache["ckv"], cache["krope"]
    m = ckv.shape[1]
    write = torch.clamp(pos, max=m - 1)
    idx = write.reshape(1).long()
    ckv.index_copy_(1, idx, c_kv.to(ckv.dtype))
    krope.index_copy_(1, idx, k_rope[:, 0].to(krope.dtype))
    wkv_b = params["wkv_b"].reshape(lora, h, nope + dv)
    w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
    cdt = ckv.dtype
    # (B, H, nope) @ W_uk per head -> q_lat (B, H, lora)
    q_lat = _bmm_f32(q_nope[:, :, 0].transpose(0, 1),
                     w_uk.permute(1, 2, 0)).transpose(0, 1)
    s = (_bmm_f32(q_lat.to(cdt), ckv.transpose(1, 2))
         + _bmm_f32(q_rope[:, :, 0].to(cdt), krope.transpose(1, 2)))
    s = s * (nope + rope) ** -0.5
    s = s.masked_fill(torch.arange(m, device=x.device) > write, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o_lat = _bmm_f32(p.to(cdt), ckv)                         # (B, H, lora)
    o = _bmm_f32(o_lat.to(x.dtype).transpose(0, 1),
                 w_uv.permute(1, 0, 2)).transpose(0, 1)      # (B, H, dv)
    y = o.reshape(b, 1, h * dv).to(x.dtype) @ params["wo"]
    return y, cache
