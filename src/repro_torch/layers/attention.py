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

Under tensor parallelism (``parallel.use_rules`` of ``make_shardings``'
rules) each layer reads its leaves' splits (``model_split``) and follows
them: GQA runs the query heads whose output columns its ``wo`` rows take,
gathering q, k or v where their projection's shard splits a head
(:class:`_Plan`); its caches rest in the rules' cache layout (kv heads,
head dim, or the sequence, merged by lse in decode); MLA runs its heads
with the latent replicated and ``ckv``'s lora columns split.

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
from repro_torch.parallel.context import (cache_split, copy_to_model,
                                          current_rules, gather_over_model,
                                          local_shape, merge_over_model,
                                          model_split, row_parallel,
                                          shard_activation)
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


class _Plan:
    """This rank's part of a GQA layer under the ambient rules, read off
    its leaves' splits (``model_split``): the output columns [c0, c1) of
    the attention (H * hd) its ``wo`` rows take (all of them where ``wo``
    is replicated), the query heads [h0, h1) that cover them and the kv
    heads [k0, k1) those read. ``rank_specific``: the rank works on its
    own part (``wo`` split), so replicated values entering that work are
    marked (``copy_to_model``) and its product is summed over "model"."""

    def __init__(self, params, cfg):
        d, h, hk = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        hd = cfg.resolved_head_dim
        self.hd, self.g = hd, h // hk
        self.sq = model_split("wq", (d, h * hd), params["wq"])
        self.sk = model_split("wk", (d, hk * hd), params["wk"])
        self.sv = model_split("wv", (d, hk * hd), params["wv"])
        self.so = model_split("wo", (h * hd, d), params["wo"])
        self.rank_specific = self.so is not None
        self.cols = ((self.so.lo, self.so.hi) if self.so is not None
                     else (0, h * hd))
        self.heads = (self.cols[0] // hd, -(-self.cols[1] // hd))
        self.kv = (self.heads[0] // self.g, (self.heads[1] - 1) // self.g + 1)
        self.n_heads, self.n_kv = h, hk

    def project(self, x, xc, w, split, heads):
        """The heads ``heads`` = [a, b) of ``x @ w`` as (B, S, b - a, hd):
        from this rank's column shard where it holds exactly those heads,
        else from the whole product (the shard gathered over "model", or
        the replicated weight's product, marked where the rank's own work
        reads it)."""
        b, s, _ = x.shape
        a, e = heads
        hd = self.hd
        if split is None:
            y = x @ w
            if self.rank_specific:
                y = copy_to_model(y)
        else:
            y = xc @ w
            if (split.lo, split.hi) != (a * hd, e * hd):
                y = gather_over_model(y, -1)
            else:
                a, e = 0, e - a
        return y.reshape(b, s, -1, hd)[:, :, a:e]

    def out(self, o, w, b, s):
        """The row-parallel output product: the attention output ``o``
        (B, h1 - h0, S, hd) of heads [h0, h1) -> its columns [c0, c1) @ the
        rank's ``wo`` rows, summed over "model" where ``wo`` is split."""
        c0 = self.cols[0] - self.heads[0] * self.hd
        flat = o.transpose(1, 2).reshape(b, s, -1)
        flat = flat[..., c0:c0 + self.cols[1] - self.cols[0]]
        return row_parallel(flat, w) if self.rank_specific else flat @ w


def _group_kv(k, v, heads, kv0, g):
    """k, v (B, n, S, hd) holding kv heads [kv0, kv0 + n) for the query
    heads ``heads`` = [h0, h1) (global query head i reads kv head i // g):
    as they are when the kernels' rule (local query head j reads local kv
    head j // ((h1 - h0) / n)) maps the same pairs, else one kv head a
    query head."""
    h0, h1 = heads
    n = k.shape[1]
    want = [(h0 + j) // g - kv0 for j in range(h1 - h0)]
    if (h1 - h0) % n == 0:
        gl = (h1 - h0) // n
        if want == [j // gl for j in range(h1 - h0)]:
            return k, v
    idx = torch.tensor(want, device=k.device)
    return k.index_select(1, idx), v.index_select(1, idx)


def _qkv_heads(plan, params, x, kv_heads, heads=None):
    """q for the query heads ``heads`` (default the rank's, [h0, h1)) as
    (B, ., S, hd) and k, v for the kv heads ``kv_heads`` (B, n, S, hd),
    before RoPE."""
    xc = shard_activation(x, "act_btd")
    q = plan.project(x, xc, params["wq"], plan.sq, heads or plan.heads)
    k = plan.project(x, xc, params["wk"], plan.sk, kv_heads)
    v = plan.project(x, xc, params["wv"], plan.sv, kv_heads)
    return (t.transpose(1, 2) for t in (q, k, v))


def _cache_kv_heads(plan, batch, max_len):
    """The kv heads the layer's cache holds on this rank under the ambient
    cache layout: its share of them where the cache is split by heads, else
    all (a replicated cache, or one split by head dim or sequence)."""
    hk, hd = plan.n_kv, plan.hd
    sp = cache_split("k", (batch, hk, max_len, hd))
    if sp is not None and sp.dim == 1:
        return sp.lo, sp.hi
    return 0, hk


def gqa_forward(params, x, cfg, *, prefix_len=0, return_kv=False,
                max_len=None):
    """Causal full-sequence (prefill) attention, windowed when
    ``cfg.window``, with the first ``prefix_len`` positions visible to every
    query (the prefix-LM mask); the ring schedule under ring rules; under
    tensor parallelism this rank's query heads (:class:`_Plan`).
    x: (B, S, d_model). ``return_kv`` also returns (k, v) of the kv heads
    the cache of ``max_len`` slots holds on this rank (after RoPE)."""
    b, s, _ = x.shape
    plan = _Plan(params, cfg)
    kv = plan.kv
    if return_kv:
        c0, c1 = _cache_kv_heads(plan, b, max_len or s)
        kv = (min(kv[0], c0), max(kv[1], c1))
    q, k, v = _qkv_heads(plan, params, x, kv)
    if cfg.pos_embed == "rope":
        positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    ka, va = _group_kv(k[:, plan.kv[0] - kv[0]:plan.kv[1] - kv[0]],
                       v[:, plan.kv[0] - kv[0]:plan.kv[1] - kv[0]],
                       plan.heads, plan.kv[0], plan.g)
    ring_mesh, ring_ax = _ring_target(s)
    if ring_mesh is not None:
        o = _ring_attention(q, ka, va, ring_mesh, ring_ax,
                            cfg.window or None, prefix_len)
    else:
        o = flash_attention(q, ka, va, causal=True, window=cfg.window or None,
                            prefix_len=prefix_len)
    y = plan.out(o, params["wo"], b, s)
    if return_kv:
        c0, c1 = _cache_kv_heads(plan, b, max_len or s)
        return y, (k[:, c0 - kv[0]:c1 - kv[0]], v[:, c0 - kv[0]:c1 - kv[0]])
    return y


def gqa_cache_init(cfg, batch, max_len, dtype, device):
    """A contiguous cache of ``max_len`` slots (``min(max_len, window)`` for
    a rolling window, whose ``slot_pos`` (m,) i32 maps slots to absolute
    positions, -1 = empty); this rank's shard of each leaf under the
    ambient cache layout."""
    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    m = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, hk, m, hd)
    shape = local_shape(shape, cache_split("k", shape))
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }
    if cfg.window:
        cache["slot_pos"] = torch.full(
            local_shape((m,), cache_split("slot_pos", (m,))), -1,
            dtype=torch.int32, device=device)
    return cache


def gqa_prefill_cache(cache, k, v, cfg):
    """Fill ``cache`` (updated in place) from prefill k/v (B, Hk', S, hd),
    the kv heads it holds: a cache split by head dim keeps this rank's
    columns (JAX's "prefill" layout where the kv heads do not divide the
    axis). A rolling window shorter than S keeps the last m tokens at slot
    pos % m."""
    sp = cache_split("k", tuple(k.shape[:2]) + (cache["k"].shape[2],)
                     + tuple(k.shape[3:]))
    if sp is not None and sp.dim == 3:
        k, v = k[..., sp.lo:sp.hi], v[..., sp.lo:sp.hi]
    elif sp is not None and sp.dim != 1:
        raise ValueError(f"gqa_prefill_cache: a prefill writes no cache "
                         f"split along dim {sp.dim}")
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


def _write_slot(t, dim, idx, own, new):
    """``t``'s slot ``idx`` along ``dim`` set to ``new``, in place with no
    host read; given ``own`` (a 0-dim bool on the device) only where it
    holds (a sequence shard's slot that another rank owns is kept)."""
    new = new.to(t.dtype)
    if own is not None:
        new = torch.where(own, new, t.index_select(dim, idx))
    t.index_copy_(dim, idx, new)


def gqa_decode(params, x, cache, cfg, *, pos, split=None):
    """One-token decode at position ``pos`` (the tokens already in the
    cache: a 0-dim int32 tensor on x's device, or a host int). x: (B, 1,
    d_model). Writes the new k/v into ``cache`` in place: at slot
    ``pos % m`` of a rolling window (stamping ``slot_pos``), else at
    ``min(pos, m - 1)`` (decoding past the cache is rejected by the model
    before it gets here); the slot and ``kv_len`` stay on the device.
    ``split`` goes to ``flash_decode``. Returns (y, cache).

    Under tensor parallelism the cache rests in the ambient layout: split
    by kv heads (this rank's heads), replicated, or split by sequence (the
    kv heads do not divide the axis: JAX's decode layout). A sequence shard
    holds slots [r m / n, (r + 1) m / n) of every kv head: the rank whose
    slots hold the new token's slot writes it, every rank attends all query
    heads over its slots with ``flash_decode`` (its lse too), and the
    partials are merged over "model" (``merge_over_model``)."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    pos = _position(pos, x.device)
    plan = _Plan(params, cfg)
    kc = cache["k"]
    sp = cache_split("k", tuple(kc.shape), local=True)
    seq = sp is not None and sp.dim == 2
    if sp is not None and sp.dim not in (1, 2):
        raise ValueError("gqa_decode: a decode cache is split by kv heads or "
                         f"by sequence, not along dim {sp.dim}")
    # a sequence shard attends every query head over every kv head
    heads = (0, cfg.n_heads) if seq else plan.heads
    kv = (0, cfg.n_kv_heads) if seq else _cache_kv_heads(
        plan, b, kc.shape[2])
    q, k1, v1 = _qkv_heads(plan, params, x, kv, heads)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k1 = apply_rope(k1, pos, cfg.rope_theta)
    m_local = kc.shape[2]
    m = sp.size if seq else m_local
    if cfg.window:
        write = torch.remainder(pos, m)
        kv_len = pos + 1
    else:
        write = torch.clamp(pos, max=m - 1)
        kv_len = write + 1
    if seq:
        local = write - sp.lo
        own = (local >= 0) & (local < m_local)
        idx = torch.clamp(local, 0, m_local - 1).reshape(1).long()
    else:
        own, idx = None, write.reshape(1).long()
    if cfg.window:
        slot_pos = cache["slot_pos"]
        _write_slot(slot_pos, 0, idx, own, pos.reshape(1))
    elif seq:
        slot_pos = torch.arange(sp.lo, sp.hi, dtype=torch.int32,
                                device=x.device)
    else:
        slot_pos = None
    _write_slot(kc, 2, idx, own, k1)
    _write_slot(cache["v"], 2, idx, own, v1)
    kw = dict(kv_len=kv_len.reshape(1), window=cfg.window or None,
              slot_pos=slot_pos, sm_scale=hd ** -0.5, split=split)
    if seq:
        o, lse = flash_decode(q, kc, cache["v"], return_lse=True, **kw)
        o = merge_over_model(o, lse)[:, plan.heads[0]:plan.heads[1]]
    else:
        ka = kc.narrow(1, plan.kv[0] - kv[0], plan.kv[1] - plan.kv[0])
        va = cache["v"].narrow(1, plan.kv[0] - kv[0],
                               plan.kv[1] - plan.kv[0])
        ka, va = _group_kv(ka, va, heads, plan.kv[0], plan.g)
        o = flash_decode(q, ka, va, **kw)
    return plan.out(o, params["wo"], b, 1), cache


def gqa_paged_cache_init(cfg, num_pages, page_size, dtype, device):
    """Per-layer paged KV pools (this rank's kv heads where the ambient
    cache layout splits them, else all). Page 0 is the NULL page: idle
    slots' block tables point at it and their per-step writes land
    there."""
    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (num_pages, hk, page_size, hd)
    shape = local_shape(shape, cache_split("kp", shape))
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
    returns new pools); ``split`` goes to ``paged_decode_attention``. Under
    tensor parallelism the pools hold this rank's kv heads, or all of them
    (replicated, where they do not divide the axis: every rank writes the
    whole new k/v and attends its query heads). Returns (y, cache)."""
    b = x.shape[0]
    plan = _Plan(params, cfg)
    kp, vp = cache["kp"], cache["vp"]
    sp = cache_split("kp", tuple(kp.shape), local=True)
    kv = (sp.lo, sp.hi) if sp is not None else (0, cfg.n_kv_heads)
    q, k1, v1 = _qkv_heads(plan, params, x, kv)
    if cfg.pos_embed == "rope":
        p = lens[:, None, None]                   # per-sequence positions
        q = apply_rope(q, p, cfg.rope_theta)
        k1 = apply_rope(k1, p, cfg.rope_theta)
    kp[page_ids, :, offs] = k1[:, :, 0].to(kp.dtype)
    vp[page_ids, :, offs] = v1[:, :, 0].to(vp.dtype)
    ka = kp.narrow(1, plan.kv[0] - kv[0], plan.kv[1] - plan.kv[0])
    va = vp.narrow(1, plan.kv[0] - kv[0], plan.kv[1] - plan.kv[0])
    ka, va = _group_kv(ka, va, plan.heads, plan.kv[0], plan.g)
    o = paged_decode_attention(q, ka, va, block_table=table, kv_len=lens + 1,
                               pos_pages=pos_pages, split=split)
    return plan.out(o, params["wo"], b, 1), cache


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


def _mla_heads(params, cfg):
    """(h0, h1, rank_specific): the query heads this rank runs under the
    ambient rules, read off ``wq``, ``wkv_b`` and ``wo`` (split by heads
    together, or replicated), and whether they are its own share."""
    d, h = cfg.d_model, cfg.n_heads
    nope, rope, dv, lora = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                            cfg.kv_lora_rank)
    splits = [(model_split("wq", (d, h * (nope + rope)), params["wq"]),
               nope + rope),
              (model_split("wkv_b", (lora, h * (nope + dv)),
                           params["wkv_b"]), nope + dv),
              (model_split("wo", (h * dv, d), params["wo"]), dv)]
    ranges = {None if sp is None else (sp.lo / w, sp.hi / w)
              for sp, w in splits}
    if len(ranges) != 1:
        raise ValueError(f"mla: wq, wkv_b and wo split over different heads "
                         f"{sorted(map(str, ranges))}")
    (r,) = ranges
    if r is None:
        return 0, h, False
    if r[0] != int(r[0]) or r[1] != int(r[1]):
        raise ValueError(f"mla: the heads split mid-head over the model axis "
                         f"({r}); the axis must divide n_heads={h}")
    return int(r[0]), int(r[1]), True


def _mla_qkr(params, x, cfg, positions, mark=False):
    """Project to per-head q (nope and rope parts, (B, H', S, .), the
    columns of ``wq`` this rank holds) and the shared latent: c_kv (B, S,
    lora), normalised by rmsnorm on the strided view of the projection, and
    k_rope (B, 1, S, rope). ``mark``: the rank runs its own heads, so q's
    input and the (replicated) latent are marked for the backward's sum."""
    b, s, _ = x.shape
    nope, rope, lora = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    xq = shard_activation(x, "act_btd") if mark else x
    q = (xq @ params["wq"]).reshape(b, s, -1, nope + rope).transpose(1, 2)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = x @ params["wkv_a"]                          # (B, S, lora + rope)
    c_kv = rmsnorm(kv_a[..., :lora], params["kv_norm"], eps=cfg.norm_eps)
    k_rope = kv_a[..., None, lora:].transpose(1, 2)    # (B, 1, S, rope)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    if mark:
        c_kv, k_rope = copy_to_model(c_kv), copy_to_model(k_rope)
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(params, x, cfg, *, return_latent=False):
    """Causal full-sequence MLA: per-head k and v expanded from the latent,
    attention through ``flash_attention`` at d_qk = nope + rope and d_v =
    v_head_dim (v a strided view of the expansion). x: (B, S, d_model).
    ``return_latent`` also returns (c_kv (B, S, lora), k_rope (B, S, rope))
    for the cache. Under tensor parallelism each rank runs its heads
    (``wq``, ``wkv_b`` column shards), ``wo`` is row-parallel, and the
    latent (``wkv_a``, ``kv_norm``) is computed replicated."""
    b, s, _ = x.shape
    h0, h1, mine = _mla_heads(params, cfg)
    h = h1 - h0
    nope, rope, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    positions = torch.arange(s, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(params, x, cfg, positions, mine)
    kv = (c_kv @ params["wkv_b"]).reshape(b, s, h, nope + dv).transpose(1, 2)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q = torch.cat([q_nope, q_rope], dim=-1)             # (B, H, S, nope+rope)
    k = torch.cat([k_nope, k_rope.expand(b, h, s, rope)], dim=-1)
    o = flash_attention(q, k, v, causal=True)
    flat = o.transpose(1, 2).reshape(b, s, -1)
    y = row_parallel(flat, params["wo"]) if mine else flat @ params["wo"]
    if return_latent:
        return y, (c_kv, k_rope[:, 0])
    return y


def mla_cache_init(cfg, batch, max_len, dtype, device):
    """The latent cache of ``max_len`` slots: ckv (B, m, lora) and krope
    (B, m, rope), each this rank's shard under the ambient cache layout
    (JAX's: ckv's lora columns over "model", krope replicated); the
    position is the model's ``cache["pos"]``."""
    out = {}
    for key, w in (("ckv", cfg.kv_lora_rank), ("krope", cfg.qk_rope_dim)):
        shape = (batch, max_len, w)
        out[key] = torch.zeros(local_shape(shape, cache_split(key, shape)),
                               dtype=dtype, device=device)
    return out


def _latent_shard(t, key, cache):
    """The columns of a (B, S, w) latent the cache leaf ``key`` holds."""
    sp = cache_split(key, tuple(cache[key].shape), local=True)
    if sp is None:
        return t
    if sp.dim != 2:
        raise ValueError(f"mla: the latent cache {key!r} is split along "
                         f"dim {sp.dim}, not its columns")
    return t[..., sp.lo:sp.hi]


def mla_prefill_cache(cache, latent, cfg):
    """Write the prefill's latent (c_kv, k_rope) into slots [0, S) of
    ``cache`` (the columns each leaf holds on this rank), in place."""
    c_kv, k_rope = latent
    s = c_kv.shape[1]
    cache["ckv"][:, :s] = _latent_shard(c_kv, "ckv", cache)
    cache["krope"][:, :s] = _latent_shard(k_rope, "krope", cache)
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
    Under tensor parallelism each rank runs its heads; a ``ckv`` split by
    its lora columns is written by each rank's columns and gathered whole
    for the scores (every lora column enters each head's). Returns
    (y, cache)."""
    b = x.shape[0]
    h0, h1, mine = _mla_heads(params, cfg)
    h = h1 - h0
    nope, rope, dv, lora = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                            cfg.kv_lora_rank)
    pos = _position(pos, x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(params, x, cfg, pos, mine)
    m = cache["ckv"].shape[1]
    write = torch.clamp(pos, max=m - 1)
    idx = write.reshape(1).long()
    for key, t in (("ckv", c_kv), ("krope", k_rope[:, 0])):
        cache[key].index_copy_(1, idx, _latent_shard(t, key, cache).to(
            cache[key].dtype))
    ckv, krope = cache["ckv"], cache["krope"]
    if cache_split("ckv", tuple(ckv.shape), local=True) is not None:
        ckv = gather_over_model(ckv, -1)
    if cache_split("krope", tuple(krope.shape), local=True) is not None:
        krope = gather_over_model(krope, -1)
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
    flat = o.reshape(b, 1, h * dv).to(x.dtype)
    y = row_parallel(flat, params["wo"]) if mine else flat @ params["wo"]
    return y, cache
