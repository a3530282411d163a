"""Plain PyTorch attention: the functions the prefill, decode, paged-decode,
backward and ring-step kernels compute (counterparts of
``repro.kernels.flash_attention.ref``, of ``ring.py::ring_step_ref`` and of
the TPU kernels' arithmetic in ``repro.kernels.flash_attention.kernel``).

Scores and the softmax are f32; as in the JAX oracle, the probabilities are
cast to v's dtype before the product with v, and the output to q's dtype.
GQA runs as grouped matmuls: kv heads are never repeated in memory.
"""

from __future__ import annotations

import torch

__all__ = ["mha_ref", "flash_fwd_ref", "decode_ref", "decode_split_ref",
           "paged_decode_ref", "paged_decode_split_ref",
           "flash_delta_ref", "flash_bwd_ref", "rolling_slot_pos",
           "ring_step_ref", "ring_fwd_ref", "ring_bwd_ref",
           "ring_bwd_tc_ref"]


def rolling_slot_pos(window: int, t: int):
    """The slot -> absolute-position map of a rolling cache of ``window``
    slots after ``t`` tokens (slot = pos % window; -1 = never written), as
    an int32 tensor on the CPU: the layout contract of rolling caches."""
    sp = torch.full((window,), -1, dtype=torch.int32)
    for p in range(max(t - window, 0), t):
        sp[p % window] = p
    return sp


def _mask(sq, skv, *, causal, window, prefix_len, device, q_start=None,
          k_start=0):
    """(sq, skv) visibility of keys at ``k_start + j`` to queries at
    ``q_start + i`` (default: queries aligned to the end of the kv stream).
    The offsets may be ints or one-element int tensors on ``device``."""
    if q_start is None:
        q_start = skv - sq
    q_pos = torch.arange(sq, device=device) + _offset(q_start)
    k_pos = torch.arange(skv, device=device) + _offset(k_start)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    if prefix_len:
        mask |= k_pos[None, :] < prefix_len
    return mask


def _offset(x):
    """An int, or a one-element int tensor as a 0-d int64 tensor (read on
    the tensor's device, never synchronised to the host)."""
    return x.reshape(()).long() if torch.is_tensor(x) else int(x)


def _softmax_av(s, mask, v):
    """Masked softmax of f32 scores s (.., sq, skv) against v (.., skv, dv):
    (o f32, lse f32). Fully masked rows give o = 0, lse = -inf."""
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    denom = p.sum(-1, keepdim=True)
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    p = p / safe
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o, (m + torch.log(safe)).squeeze(-1)


def flash_fwd_ref(q, k, v, *, causal=True, window=None, sm_scale=None,
                  prefix_len=0):
    """q (B, H, Sq, D); k (B, Hk, Skv, D); v (B, Hk, Skv, Dv) -> (o (B, H,
    Sq, Dv) in q's dtype, lse (B, H, Sq) f32). Queries are aligned to the
    END of the kv sequence; ``window``/``prefix_len`` as in the JAX oracle."""
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hk
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    qg = q.reshape(b, hk, g, sq, d).float()
    s = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2)) * sm_scale
    mask = _mask(sq, skv, causal=causal, window=window, prefix_len=prefix_len,
                 device=q.device)
    o, lse = _softmax_av(s, mask, v[:, :, None])
    return (o.reshape(b, h, sq, dv).to(q.dtype), lse.reshape(b, h, sq))


def mha_ref(q, k, v, *, causal=True, window=None, sm_scale=None,
            prefix_len=0):
    """The attention output of :func:`flash_fwd_ref`."""
    return flash_fwd_ref(q, k, v, causal=causal, window=window,
                         sm_scale=sm_scale, prefix_len=prefix_len)[0]


def decode_ref(q, k, v, *, window=None, sm_scale=None, kv_len=None,
               slot_pos=None, return_lse=False):
    """One query token per (batch, head): q (B, H, 1, D) against a
    contiguous cache k (B, Hk, S, D), v (B, Hk, S, Dv) -> (B, H, 1, Dv) in
    q's dtype. The query sits at position ``kv_len - 1`` (``kv_len`` an int
    or a one-element int tensor, read where it lies; default: the newest
    slot position, or S without ``slot_pos``). ``slot_pos`` ((S,) int32,
    -1 = empty) gives each slot's
    absolute position, so rotated rolling-window caches mask correctly;
    omitted, slot i holds position i. A slot is visible when 0 <= pos <=
    q_pos and q_pos - pos < window; a row that sees no slot gives 0.
    ``return_lse``: (o, lse (B, H) f32), the row's natural-log softmax
    normaliser (-inf for a row that sees no slot)."""
    b, h, _, d = q.shape
    hk, m = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hk
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    if slot_pos is None:
        sp = torch.arange(m, device=q.device)
    else:
        sp = slot_pos.reshape(-1).long()
    q_pos = (_offset(kv_len) - 1 if kv_len is not None
             else sp.max() if slot_pos is not None else m - 1)
    mask = (sp >= 0) & (sp <= q_pos)
    if window is not None:
        mask &= (q_pos - sp) < window
    qg = q.reshape(b, hk, g, 1, d).float()
    s = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2)) * sm_scale
    o, lse = _softmax_av(s, mask, v[:, :, None])
    o = o.reshape(b, h, 1, dv).to(q.dtype)
    return (o, lse.reshape(b, h)) if return_lse else o


def _split_merge(q, kb, vb, mask, split, sm_scale, dtype):
    """The split kernels' arithmetic: q (b, hk, g, d) against kb, vb
    (b, hk, cap, d) f32 under mask (b, nsplit, split), the slots padded to
    nsplit * split; f32 partials (m, l, acc) per range, merged by their
    maxima. -> (b, hk * g, 1, d) in ``dtype``."""
    b, hk, g, d = q.shape
    cap = kb.shape[2]
    nsplit = mask.shape[1]
    pad = nsplit * split - cap
    kb = torch.nn.functional.pad(kb, (0, 0, 0, pad))
    vb = torch.nn.functional.pad(vb, (0, 0, 0, pad))
    kb = kb.reshape(b, hk, 1, nsplit, split, d)
    vb = vb.reshape(b, hk, 1, nsplit, split, d)
    qg = q.reshape(b, hk, g, 1, 1, d).float()
    s = (qg * kb).sum(-1) * sm_scale                # (b, hk, g, nsplit, split)
    mk = mask[:, None, None]
    s = s.masked_fill(~mk, float("-inf"))
    m = s.amax(-1)                                  # (b, hk, g, nsplit)
    p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m)[..., None])
    p = p.masked_fill(~mk, 0.0)
    l = p.sum(-1)
    vb = torch.where(mk[..., None], vb, 0.0)        # a masked v adds 0
    acc = (p[..., None] * vb).sum(-2)               # (b, hk, g, nsplit, d)
    big = m.amax(-1, keepdim=True)
    wgt = torch.exp(m - torch.where(big == float("-inf"), 0.0, big))
    wgt = wgt.masked_fill(m == float("-inf"), 0.0)
    den = (wgt * l).sum(-1)
    num = (wgt[..., None] * acc).sum(-2)
    o = torch.where(den[..., None] > 0, num / torch.where(
        den > 0, den, 1.0)[..., None], 0.0)
    return o.reshape(b, hk * g, 1, d).to(dtype)


def decode_split_ref(q, k, v, *, split, kv_len=None, slot_pos=None,
                     window=None, sm_scale=None):
    """The split-KV form of :func:`decode_ref` that ``csrc/flash_decode.cu``
    computes: the S slots of each (sequence, kv head) are cut into ranges
    of ``split``; while the cache is unwrapped (q_pos < S, so slot i holds
    position i or nothing) a range wholly past q_pos or wholly below the
    window is skipped, as the TPU kernel skips whole blocks, and once
    wrapped every range runs; each range gives f32 partials over its live
    slots (m = max score, l = sum of exp(s - m), acc = sum of exp(s - m) v,
    p kept in f32), a range with no live slot is empty (m = -inf, l = 0), a
    masked slot adds nothing, whatever its k and v hold; the partials merge
    as sum exp(m_s - M) acc_s / sum exp(m_s - M) l_s, and a query that sees
    no slot gives exactly 0. ``kv_len`` defaults to S."""
    b, h, _, d = q.shape
    hk, m = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    sp = (torch.arange(m, device=q.device) if slot_pos is None
          else slot_pos.reshape(-1).long())
    q_pos = _offset(m if kv_len is None else kv_len) - 1
    mask = (sp >= 0) & (sp <= q_pos)
    if window is not None:
        mask &= (q_pos - sp) < window
    nsplit = -(-m // split)
    start = torch.arange(nsplit, device=q.device) * split
    last = torch.clamp(start + split, max=m) - 1       # each range's last slot
    live = start <= q_pos
    if window is not None:
        live &= (q_pos - last) < window
    live |= torch.as_tensor(q_pos >= m, device=q.device)
    mask = torch.nn.functional.pad(mask, (0, nsplit * split - m))
    mask = (mask.reshape(nsplit, split) & live[:, None]).expand(b, -1, -1)
    return _split_merge(q.reshape(b, hk, h // hk, d), k.float(), v.float(),
                        mask, split, sm_scale, q.dtype)


def paged_decode_ref(q, k_pages, v_pages, *, block_table, kv_len=None,
                     pos_pages=None, window=None, sm_scale=None):
    """q (B, H, 1, D) against page pools k/v (P, Hk, page, D|Dv): logical
    page j of sequence b is pool page ``block_table[b, j]``; ``kv_len`` (B,)
    is each sequence's valid length (the query sits at kv_len - 1);
    ``pos_pages`` (P, page), -1 = empty, gives each pool slot's absolute
    position (omitted, logical order is positional)."""
    b, h, _, d = q.shape
    _, hk, page, _ = k_pages.shape
    dv = v_pages.shape[-1]
    g = h // hk
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    tab = block_table.reshape(b, -1).long()
    nsp = tab.shape[1]
    m = nsp * page
    if kv_len is None:
        n = torch.full((b,), m, dtype=torch.int64, device=q.device)
    else:
        n = torch.as_tensor(kv_len, device=q.device).reshape(-1).long()
        n = n.expand(b) if n.shape[0] == 1 else n
    # gather each sequence's pages into logical-contiguous (B, Hk, m, D)
    kb = k_pages[tab].transpose(1, 2).reshape(b, hk, m, d)
    vb = v_pages[tab].transpose(1, 2).reshape(b, hk, m, dv)
    if pos_pages is None:
        sp = torch.arange(m, device=q.device).expand(b, m)
    else:
        sp = pos_pages.long()[tab].reshape(b, m)
    q_pos = (n - 1)[:, None]
    mask = (sp >= 0) & (sp <= q_pos)
    if window is not None:
        mask &= (q_pos - sp) < window
    qg = q.reshape(b, hk, g, 1, d).float()
    s = torch.matmul(qg, kb.float()[:, :, None].transpose(-1, -2)) * sm_scale
    o, _ = _softmax_av(s, mask[:, None, None, None, :], vb[:, :, None])
    return o.reshape(b, h, 1, dv).to(q.dtype)


def paged_decode_split_ref(q, k_pages, v_pages, *, block_table, kv_len,
                           pos_pages, split, sm_scale=None):
    """The split-KV form of :func:`paged_decode_ref` that
    ``csrc/paged_decode.cu`` computes: each sequence's ``nsp * page``
    logical slots are cut into ranges of ``split`` slots; each range gives
    f32 partials over its visible slots (m = max score, l = sum of
    exp(s - m), acc = sum of exp(s - m) v, p kept in f32), a range that
    starts past q_pos while the cache is unwrapped (q_pos < nsp * page), or
    holds no visible slot, is empty (m = -inf, l = 0); a masked slot adds
    nothing, whatever its k and v hold; the partials merge as
    sum exp(m_s - M) acc_s / sum exp(m_s - M) l_s, and a query that sees no
    slot gives exactly 0."""
    b, h, _, d = q.shape
    _, hk, page, _ = k_pages.shape
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    tab = block_table.reshape(b, -1).long()
    cap = tab.shape[1] * page
    nsplit = -(-cap // split)
    kb = k_pages[tab].transpose(1, 2).reshape(b, hk, cap, d).float()
    vb = v_pages[tab].transpose(1, 2).reshape(b, hk, cap, d).float()
    sp = pos_pages.long()[tab].reshape(b, cap)
    q_pos = torch.as_tensor(kv_len, device=q.device).reshape(b, 1).long() - 1
    mask = (sp >= 0) & (sp <= q_pos)
    start = torch.arange(nsplit, device=q.device) * split
    live = (q_pos >= cap) | (start[None, :] <= q_pos)         # (b, nsplit)
    mask = torch.nn.functional.pad(mask, (0, nsplit * split - cap))
    mask = mask.reshape(b, nsplit, split) & live[:, :, None]
    return _split_merge(q.reshape(b, hk, h // hk, d), kb, vb, mask, split,
                        sm_scale, q.dtype)


def flash_delta_ref(do, o):
    """delta = rowsum(do * o) in f32: (B, H, Sq, D) x2 -> (B, H, Sq)."""
    return (do.float() * o.float()).sum(-1)


def flash_bwd_ref(q, k, v, do, lse, delta, *, causal=True, window=None,
                  sm_scale=None, prefix_len=0):
    """dq, dk, dv of causal (or full) attention, optionally under a sliding
    ``window`` (q_pos - k_pos < window) and a prefix-LM prefix (keys below
    ``prefix_len`` visible to every query), from the forward's lse and
    :func:`flash_delta_ref`'s delta, all in f32 as the TPU backward kernel
    computes them: ``p = exp(s - lse)`` on visible keys (0 elsewhere, so a
    row that sees no key, lse = -inf, contributes nothing),
    ``ds = p * (do v^T - delta) * sm_scale``. Returns dq (B, H, Sq, D) in
    q's dtype, dk (B, Hk, Skv, D) and dv (B, Hk, Skv, Dv) f32 summed over
    each kv head's query-head group (do is (B, H, Sq, Dv), as o)."""
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    dv_dim = v.shape[-1]
    g = h // hk
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    qf = q.float().reshape(b, hk, g, sq, d)
    dof = do.float().reshape(b, hk, g, sq, dv_dim)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    mask = _mask(sq, skv, causal=causal, window=window, prefix_len=prefix_len,
                 device=q.device)
    p = torch.where(mask, torch.exp(s - lse.reshape(b, hk, g, sq, 1)), 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta.reshape(b, hk, g, sq, 1)) * sm_scale
    dq = torch.matmul(ds, kf).reshape(b, h, sq, d)
    dk = torch.matmul(ds.transpose(-1, -2), qf).sum(2)
    dv = torch.matmul(p.transpose(-1, -2), dof).sum(2)
    return dq.to(q.dtype), dk, dv


def ring_fwd_ref(q, k, v, q_start=0, k_start=0, *, causal=True, window=None,
                 sm_scale=None, prefix_len=0):
    """One ring step: q (B, H, Sq, D) at absolute positions ``q_start + i``
    against one kv chunk k (B, Hk, Skv, D), v (B, Hk, Skv, Dv) at
    ``k_start + j`` -> (o (B, H, Sq, Dv) in q's dtype, normalised by the
    chunk's own softmax sum, and lse (B, H, Sq) f32). Masks as in the JAX
    ``_mask_block``: causal, ``window`` (q_pos - k_pos < window) and
    ``prefix_len`` (keys below it always visible). A row that sees no key of
    the chunk gives o = 0, lse = -inf (the merge's identity). As the TPU
    step kernel, p stays f32 in the product with v."""
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hk
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    qg = q.reshape(b, hk, g, sq, d).float()
    s = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2)) * sm_scale
    mask = _mask(sq, skv, causal=causal, window=window, prefix_len=prefix_len,
                 device=q.device, q_start=q_start, k_start=k_start)
    o, lse = _softmax_av(s, mask, v.float()[:, :, None])
    return o.reshape(b, h, sq, dv).to(q.dtype), lse.reshape(b, h, sq)


def ring_step_ref(q, k, v, *, q_start=None, k_start=None, causal=True,
                  window=None, sm_scale=None, prefix_len=0):
    """The o of :func:`ring_fwd_ref` (counterpart of the JAX
    ``ring.py::ring_step_ref``; offsets default to 0)."""
    return ring_fwd_ref(q, k, v, 0 if q_start is None else q_start,
                        0 if k_start is None else k_start, causal=causal,
                        window=window, sm_scale=sm_scale,
                        prefix_len=prefix_len)[0]


def _ring_p_ds(q, k, v, do, lse, delta, q_start, k_start, *, causal,
               window, sm_scale, prefix_len):
    """The f32 terms of a ring step's backward: (qf, kf, dof (grouped as
    (B, Hk, G, ...)), p, ds)."""
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    dv_dim = v.shape[-1]
    g = h // hk
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    qf = q.float().reshape(b, hk, g, sq, d)
    dof = do.float().reshape(b, hk, g, sq, dv_dim)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    mask = _mask(sq, skv, causal=causal, window=window, prefix_len=prefix_len,
                 device=q.device, q_start=q_start, k_start=k_start)
    lse = lse.reshape(b, hk, g, sq, 1)
    live = mask & (lse != float("-inf"))
    p = torch.where(live, torch.exp(torch.where(live, s - lse, 0.0)), 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta.reshape(b, hk, g, sq, 1)) * sm_scale
    return qf, kf, dof, p, ds


def ring_bwd_ref(q, k, v, do, lse, delta, q_start=0, k_start=0, *,
                 causal=True, window=None, sm_scale=None, prefix_len=0):
    """The backward of one ring step at its offsets, in f32 as the TPU
    kernel computes it: ``p = exp(s - lse)`` on visible keys from the step's
    own lse (0 elsewhere and on rows with lse = -inf, never NaN),
    ``ds = p * (do v^T - delta) * sm_scale`` with ``delta`` the caller's
    (``rowsum(do * o) - g_lse``). Returns dq (B, H, Sq, D) in q's dtype and
    dk, dv (B, Hk, Skv, D) f32 summed over each kv head's query-head
    group."""
    qf, kf, dof, p, ds = _ring_p_ds(
        q, k, v, do, lse, delta, q_start, k_start, causal=causal,
        window=window, sm_scale=sm_scale, prefix_len=prefix_len)
    dq = torch.matmul(ds, kf).reshape(q.shape)
    dk = torch.matmul(ds.transpose(-1, -2), qf).sum(2)
    dv = torch.matmul(p.transpose(-1, -2), dof).sum(2)
    return dq.to(q.dtype), dk, dv


def _hi_lo(x):
    """x as the sum of two bf16 roundings, in f32: hi = bf16(x) and lo =
    bf16(x - hi)."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def ring_bwd_tc_ref(q, k, v, do, lse, delta, q_start=0, k_start=0, *,
                    causal=True, window=None, sm_scale=None, prefix_len=0):
    """:func:`ring_bwd_ref` with the roundings of the tensor-core backward
    (``ring_flash_bwd_tc``), whose products take bf16 operands: dq = ds k
    with ds rounded once to bf16; dk = ds^T q and dv = p^T do with ds and p
    as hi/lo bf16 planes. Products of bf16 values are exact in f32, so this
    is the kernel's arithmetic up to the order of its f32 sums. Not the CPU
    path of ``ring_flash_bwd``: a model of the card's, for tests."""
    qf, kf, dof, p, ds = _ring_p_ds(
        q, k, v, do, lse, delta, q_start, k_start, causal=causal,
        window=window, sm_scale=sm_scale, prefix_len=prefix_len)
    dq = torch.matmul(ds.to(torch.bfloat16).float(), kf).reshape(q.shape)
    dk = torch.matmul(_hi_lo(ds).transpose(-1, -2), qf).sum(2)
    dv = torch.matmul(_hi_lo(p).transpose(-1, -2), dof).sum(2)
    return dq.to(q.dtype), dk, dv
