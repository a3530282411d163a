"""Blocked online-softmax attention in the kernel language (the
counterpart of ``repro.kernels.flash_attention.kernel``).

Each builder is one source over blocks that expands to the ``torch`` and
``loops`` backends and, on ``cuda``, runs on the hand-written Hopper
kernel its wrapper launches (``ops.py`` binds each spec):

* ``flash_fwd_builder``     prefill forward + lse (``csrc/flash_fwd.cu``)
* ``flash_delta_builder``   rowsum(do * o) (``csrc/flash_delta.cu``)
* ``flash_bwd_builder``     dq, dk, dv (``csrc/flash_bwd.cu``)
* ``flash_decode_builder``  one token against a contiguous or rotated
  cache (``csrc/flash_decode.cu``)
* ``paged_decode_builder``  one token through a block table over page
  pools (``csrc/paged_decode.cu``)
* ``ring_flash_fwd_builder`` / ``ring_flash_bwd_builder``  one ring step
  at absolute offsets read from (1, 1) int32 inputs, and its backward
  (``csrc/ring_flash.cu``)

The bodies are the JAX package's, written in torch: ``lax.iota`` is
``torch.arange``, ``dot_general`` a matmul in f32, and the masks
(:func:`_mask_block`) and block skips (:func:`_run_cond`) keep JAX's
boolean logic. Grid ids are 0-dim tensors under the torch expansion's
vmap and Python ints under loops, so every predicate is written with
``&``/``|`` and selects, never a Python ``if``.

Two specs differ from the JAX ones where the kernels do: the backwards
(``flash_bwd_builder``, ``ring_flash_bwd_builder``) sum dk and dv over
each kv head's group of query heads, as ``flash_bwd`` returns them, so
their grid is (b, hk, g, nq, nk) with the group index a reduce axis that
dk and dv accumulate over (JAX emits them per query head and sums on the
host); and the kernels' own tiles are template constants, so ``block_q``,
``block_kv`` and the rest tile only the torch and loops expansions.
"""

from __future__ import annotations

import torch

from ...core.lang import Scratch, ShardAxis, Spec, Tile, as_dtype

__all__ = ["flash_fwd_builder", "flash_delta_builder", "flash_bwd_builder",
           "flash_decode_builder", "paged_decode_builder",
           "ring_flash_fwd_builder", "ring_flash_bwd_builder"]

_NEG_INF = float("-inf")
_F32 = torch.float32


# ---------------------------------------------------------------------------
# shared masks and block skips (JAX's _mask_block and _run_cond)
# ---------------------------------------------------------------------------

def _mask_block(q_pos, k_pos, *, causal, window, prefix_len):
    mask = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    if window is not None:
        mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
    if prefix_len:
        mask = mask | torch.broadcast_to(k_pos[None, :] < prefix_len,
                                         mask.shape)
    return mask


def _run_cond(qi, ki, *, causal, window, prefix_len, block_q, block_kv,
              q_offset):
    """Whole-block skip: strictly above the diagonal (causal) or out of the
    window; prefix keys are always visible."""
    run = True
    if causal:
        run = run & ((ki * block_kv) <= (qi * block_q + q_offset + block_q
                                          - 1))
    if window is not None:
        run = run & ((qi * block_q + q_offset)
                     - (ki * block_kv + block_kv - 1) < window)
    if prefix_len:
        run = run | ((ki * block_kv) < prefix_len)
    return run


def _dot_t(a, b):
    """a @ b^T in f32 (``dot_general`` over the last axes)."""
    return torch.matmul(a, b.transpose(-1, -2))


def _online_softmax_step(m_scr, l_scr, acc_scr, s, mask, v, *, guard_exp):
    """One kv block of the online softmax: rescale the running (m, l, acc)
    by the new block's scores ``s`` (masked to -inf) and values ``v``.
    ``guard_exp`` keeps the exp argument finite on masked entries (the
    ring step's form)."""
    m_prev = m_scr[:, :1]
    l_prev = l_scr[:, :1]
    m_cur = torch.maximum(m_prev, s.amax(-1, keepdim=True))
    # correction for fully-masked history (m_prev == -inf): acc is 0
    corr = torch.where(m_prev == _NEG_INF, 0.0, torch.exp(m_prev - m_cur))
    if guard_exp:
        p = torch.exp(torch.where(mask, s - m_cur, 0.0))
    else:
        p = torch.exp(s - m_cur)
    p = torch.where(mask, p, 0.0)                 # kills -inf - -inf NaNs
    acc_scr[...] = acc_scr[...] * corr + torch.matmul(p, v)
    l_scr[:, :1] = l_prev * corr + p.sum(-1, keepdim=True)
    m_scr[:, :1] = m_cur


def _init_softmax(m_scr, l_scr, acc_scr):
    m_scr[...] = torch.full(m_scr.shape, _NEG_INF, dtype=_F32,
                            device=m_scr.device)
    l_scr[...] = torch.zeros(l_scr.shape, dtype=_F32, device=l_scr.device)
    acc_scr[...] = torch.zeros(acc_scr.shape, dtype=_F32,
                               device=acc_scr.device)


def _finish(l_scr, acc_scr, m_scr, o_ref, lse_ref=None):
    l = l_scr[:, :1]
    o_ref[0, 0] = (acc_scr[...] / torch.where(l == 0.0, 1.0, l)).to(
        o_ref.dtype)
    if lse_ref is not None:
        # log-sum-exp per query row (-inf for a row that saw no key)
        lse_ref[0, 0] = m_scr[:, 0] + torch.log(
            torch.where(l[:, 0] == 0.0, 1.0, l[:, 0]))


# ---------------------------------------------------------------------------
# prefill forward
# ---------------------------------------------------------------------------

def flash_fwd_builder(D):
    """q: (b, h, sq, d); k: (b, hk, skv, d); v: (b, hk, skv, dv) ->
    o: (b, h, sq, dv), lse: (b, h, sq) f32.

    Grid (b, h, nq, nk) with nk the sequential reduce axis; m/l/acc running
    state in scratch, init under ``is_first``, flushed under ``is_last``;
    fully-masked (q, kv)-blocks are ``cell_when``-skipped."""
    b, h, hk = D.b, D.h, D.hk
    sq, skv, d, dv = D.sq, D.skv, D.d, D.dv
    bq, bkv = D.block_q, D.block_kv
    causal, window, prefix = D.causal, D.window, D.prefix_len
    sm_scale = D.sm_scale
    g = h // hk
    q_offset = skv - sq  # queries aligned to the end of the kv stream
    dtype = as_dtype(D.dtype)

    def body(ctx, q_ref, k_ref, v_ref, o_ref, lse_ref):
        m_scr, l_scr, acc_scr = ctx.scratch
        qi = ctx.outer_id(2)
        ki = ctx.reduce_id(0)

        @ctx.when(ctx.is_first)
        def _init():
            _init_softmax(m_scr, l_scr, acc_scr)

        run = _run_cond(qi, ki, causal=causal, window=window,
                        prefix_len=prefix, block_q=bq, block_kv=bkv,
                        q_offset=q_offset)

        @ctx.cell_when(run)
        def _step():
            q_pos = qi * bq + ctx.lane_ids(bq) + q_offset
            k_pos = ki * bkv + ctx.lane_ids(bkv)
            q = q_ref[0, 0].to(_F32)                      # (bq, d)
            k = k_ref[0, 0].to(_F32)                      # (bkv, d)
            s = _dot_t(q, k) * sm_scale
            mask = _mask_block(q_pos, k_pos, causal=causal, window=window,
                               prefix_len=prefix)
            s = torch.where(mask, s, _NEG_INF)
            _online_softmax_step(m_scr, l_scr, acc_scr, s, mask,
                                 v_ref[0, 0].to(_F32), guard_exp=False)

        @ctx.when(ctx.is_last)
        def _fin():
            _finish(l_scr, acc_scr, m_scr, o_ref, lse_ref)

    return Spec(
        "flash_attention_fwd",
        grid=(b, h, sq // bq, skv // bkv),
        reduce_axes=(3,),
        scratch=[Scratch((bq, 128), _F32),   # m (lane-replicated col 0)
                 Scratch((bq, 128), _F32),   # l
                 Scratch((bq, dv), _F32)],   # acc
        inputs=[
            Tile("q", (b, h, sq, d), dtype, block=(1, 1, bq, d),
                 index=lambda b_, h_, qi, ki: (b_, h_, qi, 0)),
            Tile("k", (b, hk, skv, d), dtype, block=(1, 1, bkv, d),
                 index=lambda b_, h_, qi, ki: (b_, h_ // g, ki, 0)),
            Tile("v", (b, hk, skv, dv), dtype, block=(1, 1, bkv, dv),
                 index=lambda b_, h_, qi, ki: (b_, h_ // g, ki, 0)),
        ],
        outputs=[
            Tile("o", (b, h, sq, dv), dtype, block=(1, 1, bq, dv),
                 index=lambda b_, h_, qi, ki: (b_, h_, qi, 0)),
            Tile("lse", (b, h, sq), _F32, block=(1, 1, bq),
                 index=lambda b_, h_, qi, ki: (b_, h_, qi)),
        ],
        body=body)


# ---------------------------------------------------------------------------
# backward: delta, then one fused dq/dk/dv pass
# ---------------------------------------------------------------------------

def flash_delta_builder(D):
    """do, o: (b, h, sq, dv) -> delta: (b, h, sq) f32, rowwise sum(do * o):
    the product and the row sum in one grid cell."""
    b, h, sq, dv = D.b, D.h, D.sq, D.dv
    bq = D.block_q
    dtype = as_dtype(D.dtype)

    def body(ctx, do_ref, o_ref, delta_ref):
        delta_ref[0, 0] = (do_ref[0, 0].to(_F32) * o_ref[0, 0].to(_F32)
                           ).sum(-1)

    return Spec(
        "flash_delta",
        grid=(b, h, sq // bq),
        inputs=[
            Tile("do", (b, h, sq, dv), dtype, block=(1, 1, bq, dv),
                 index=lambda b_, h_, qi: (b_, h_, qi, 0)),
            Tile("o", (b, h, sq, dv), dtype, block=(1, 1, bq, dv),
                 index=lambda b_, h_, qi: (b_, h_, qi, 0)),
        ],
        outputs=[
            Tile("delta", (b, h, sq), _F32, block=(1, 1, bq),
                 index=lambda b_, h_, qi: (b_, h_, qi)),
        ],
        body=body)


def _bwd_spec(name, D, *, offsets):
    """The fused backward over grid (b, hk, g, nq, nk), all three block
    axes sequential: ``dq`` accumulates over the kv blocks in scratch
    (init at ``reduce_first(2)``, flushed at ``reduce_last(2)``); ``dk``
    and ``dv`` accumulate over the query heads of their group AND the
    query blocks directly in their revisited output blocks (init where
    both ``reduce_first(0)`` and ``reduce_first(1)`` hold). ``p`` is
    recomputed once per (query head, q block, kv block) tile from lse.
    ``offsets``: the ring step's form, absolute positions from the
    (1, 1) ``q_start``/``k_start`` inputs and the exp argument kept finite
    on masked entries; else queries sit at the end of the kv stream."""
    b, h, hk = D.b, D.h, D.hk
    sq, skv, d, dv = D.sq, D.skv, D.d, D.dv
    bq, bkv = D.block_q, D.block_kv
    causal, window, prefix = D.causal, D.window, D.prefix_len
    sm_scale = D.sm_scale
    g = h // hk
    nq, nk = sq // bq, skv // bkv
    dtype = as_dtype(D.dtype)

    def body(ctx, q_ref, k_ref, v_ref, do_ref, lse_ref, delta_ref, *rest):
        if offsets:
            qs_ref, ks_ref, dq_ref, dk_ref, dv_ref = rest
            q0, k0 = qs_ref[0, 0], ks_ref[0, 0]
        else:
            dq_ref, dk_ref, dv_ref = rest
            q0, k0 = skv - sq, 0
        dq_scr, = ctx.scratch
        qi = ctx.reduce_id(1)
        ki = ctx.reduce_id(2)

        @ctx.when(ctx.reduce_first(2))       # ki == 0: a fresh query row
        def _init_dq():
            dq_scr[...] = torch.zeros(dq_scr.shape, dtype=_F32,
                                      device=dq_scr.device)

        @ctx.when(ctx.reduce_first(0))       # the group's first head ...
        def _first_head():
            @ctx.when(ctx.reduce_first(1))   # ... at qi == 0: first visit
            def _init_dkv():                 # of the dk/dv blocks
                dk_ref[0, 0] = torch.zeros((bkv, d), dtype=_F32,
                                           device=dk_ref.device)
                dv_ref[0, 0] = torch.zeros((bkv, dv), dtype=_F32,
                                           device=dv_ref.device)

        if offsets:
            # the block skip of _run_cond, at dynamic absolute offsets
            run = True
            if causal:
                run = run & ((k0 + ki * bkv) <= (q0 + qi * bq + bq - 1))
            if window is not None:
                run = run & (((q0 + qi * bq) - (k0 + ki * bkv + bkv - 1))
                             < window)
            if prefix:
                run = run | ((k0 + ki * bkv) < prefix)
        else:
            run = _run_cond(qi, ki, causal=causal, window=window,
                            prefix_len=prefix, block_q=bq, block_kv=bkv,
                            q_offset=q0)

        @ctx.cell_when(run)
        def _step():
            q = q_ref[0, 0].to(_F32)
            k = k_ref[0, 0].to(_F32)
            v = v_ref[0, 0].to(_F32)
            do = do_ref[0, 0].to(_F32)
            lse = lse_ref[0, 0]
            delta = delta_ref[0, 0]
            q_pos = q0 + qi * bq + ctx.lane_ids(bq)
            k_pos = k0 + ki * bkv + ctx.lane_ids(bkv)
            mask = _mask_block(q_pos, k_pos, causal=causal, window=window,
                               prefix_len=prefix)
            s = _dot_t(q, k) * sm_scale
            if offsets:
                # fully-masked rows carry lse = -inf: keep the argument
                # finite so p is an exact 0, not a masked NaN
                p = torch.exp(torch.where(mask, s - lse[:, None], 0.0))
            else:
                p = torch.exp(s - lse[:, None])
            p = torch.where(mask, p, 0.0)                     # (bq, bkv)
            dv_ref[0, 0] = dv_ref[0, 0] + torch.matmul(p.transpose(0, 1),
                                                       do)    # p^T @ do
            dp = _dot_t(do, v)
            ds = p * (dp - delta[:, None]) * sm_scale         # (bq, bkv)
            dk_ref[0, 0] = dk_ref[0, 0] + torch.matmul(ds.transpose(0, 1),
                                                       q)     # ds^T @ q
            dq_scr[...] += torch.matmul(ds, k)                # ds @ k

        @ctx.when(ctx.reduce_last(2))        # ki == nk-1: flush the row
        def _flush_dq():
            dq_ref[0, 0] = dq_scr[...].to(dq_ref.dtype)

    def qmap(b_, kh, gi, qi, ki):
        return (b_, kh * g + gi, qi, 0)

    def rowmap(b_, kh, gi, qi, ki):
        return (b_, kh * g + gi, qi)

    def kvmap(b_, kh, gi, qi, ki):
        return (b_, kh, ki, 0)

    inputs = [
        Tile("q", (b, h, sq, d), dtype, block=(1, 1, bq, d), index=qmap),
        Tile("k", (b, hk, skv, d), dtype, block=(1, 1, bkv, d), index=kvmap),
        Tile("v", (b, hk, skv, dv), dtype, block=(1, 1, bkv, dv),
             index=kvmap),
        Tile("do", (b, h, sq, dv), dtype, block=(1, 1, bq, dv), index=qmap),
        Tile("lse", (b, h, sq), _F32, block=(1, 1, bq), index=rowmap),
        Tile("delta", (b, h, sq), _F32, block=(1, 1, bq), index=rowmap),
    ]
    shard = None
    if offsets:
        inputs += [Tile("q_start", (1, 1), torch.int32),
                   Tile("k_start", (1, 1), torch.int32)]
        # the kv axis lives across the ring's shards; dk/dv are the
        # chunks other shards own (their partials ride the ring home)
        shard = ShardAxis(mesh_axis=D.mesh_axis, axis=4, extent=D.ring_steps,
                          collective="ppermute", rotate=("k", "v"),
                          sharded_outputs=("dk", "dv"))
    return Spec(
        name,
        grid=(b, hk, g, nq, nk),
        reduce_axes=(2, 3, 4),
        scratch=[Scratch((bq, d), _F32)],
        inputs=inputs,
        outputs=[
            Tile("dq", (b, h, sq, d), dtype, block=(1, 1, bq, d), index=qmap,
                 reduce=(4,)),
            Tile("dk", (b, hk, skv, d), _F32, block=(1, 1, bkv, d),
                 index=kvmap, reduce=(2, 3)),
            Tile("dv", (b, hk, skv, dv), _F32, block=(1, 1, bkv, dv),
                 index=kvmap, reduce=(2, 3)),
        ],
        body=body,
        shard=shard)


def flash_bwd_builder(D):
    """q, k, v, do, lse, delta -> dq (b, h, sq, d) in q's dtype and dk
    (b, hk, skv, d), dv (b, hk, skv, dv) f32, summed over each kv head's
    query-head group (``flash_bwd``'s outputs). See :func:`_bwd_spec`."""
    return _bwd_spec("flash_attention_bwd", D, offsets=False)


# ---------------------------------------------------------------------------
# single-token decode
# ---------------------------------------------------------------------------

def _decode_body(ctx, scr, q_ref, k_ref, v_ref, sp, q_pos, run, window,
                 sm_scale, o_ref):
    m_scr, l_scr, acc_scr = scr

    @ctx.when(ctx.is_first)
    def _init():
        _init_softmax(m_scr, l_scr, acc_scr)

    @ctx.cell_when(run)
    def _step():
        q = q_ref[0, 0].to(_F32)                      # (1, d)
        k = k_ref[0, 0].to(_F32)                      # (bkv, d)
        s = _dot_t(q, k) * sm_scale
        mask = ((sp >= 0) & (sp <= q_pos))[None, :]   # (1, bkv)
        if window is not None:
            mask = mask & ((q_pos - sp) < window)[None, :]
        s = torch.where(mask, s, _NEG_INF)
        _online_softmax_step(m_scr, l_scr, acc_scr, s, mask,
                             v_ref[0, 0].to(_F32), guard_exp=False)

    @ctx.when(ctx.is_last)
    def _fin():
        _finish(l_scr, acc_scr, m_scr, o_ref)


def flash_decode_builder(D):
    """q: (b, h, 1, d) vs cache k: (b, hk, skv, d), v: (b, hk, skv, dv),
    kv_len: (1, 1) i32, slot_pos: (1, skv) i32 -> o: (b, h, 1, dv).

    The forward's online softmax over kv blocks for one query row at
    position ``kv_len - 1``; ``slot_pos`` gives each slot's absolute
    position (-1 empty), so a rotated rolling cache masks correctly. The
    whole-block skip holds while the cache has not wrapped."""
    b, h, hk = D.b, D.h, D.hk
    skv, d, dv = D.skv, D.d, D.dv
    bkv = D.block_kv
    window = D.window
    sm_scale = D.sm_scale
    g = h // hk
    dtype = as_dtype(D.dtype)

    def body(ctx, q_ref, k_ref, v_ref, len_ref, sp_ref, o_ref):
        ki = ctx.reduce_id(0)
        q_pos = len_ref[0, 0] - 1            # query at the end of the stream
        run = (ki * bkv) <= q_pos
        if window is not None:
            run = run & ((q_pos - (ki * bkv + bkv - 1)) < window)
        # a wrapped rotated cache: every block may hold live tokens
        run = run | (q_pos >= skv)
        _decode_body(ctx, ctx.scratch, q_ref, k_ref, v_ref, sp_ref[0], q_pos,
                     run, window, sm_scale, o_ref)

    return Spec(
        "flash_decode",
        grid=(b, h, skv // bkv),
        reduce_axes=(2,),
        scratch=[Scratch((1, 128), _F32),   # m
                 Scratch((1, 128), _F32),   # l
                 Scratch((1, dv), _F32)],   # acc
        inputs=[
            Tile("q", (b, h, 1, d), dtype, block=(1, 1, 1, d),
                 index=lambda b_, h_, ki: (b_, h_, 0, 0)),
            Tile("k", (b, hk, skv, d), dtype, block=(1, 1, bkv, d),
                 index=lambda b_, h_, ki: (b_, h_ // g, ki, 0)),
            Tile("v", (b, hk, skv, dv), dtype, block=(1, 1, bkv, dv),
                 index=lambda b_, h_, ki: (b_, h_ // g, ki, 0)),
            Tile("kv_len", (1, 1), torch.int32),   # whole-array
            Tile("slot_pos", (1, skv), torch.int32,
                 block=(1, bkv), index=lambda b_, h_, ki: (0, ki)),
        ],
        outputs=[
            Tile("o", (b, h, 1, dv), dtype, block=(1, 1, 1, dv),
                 index=lambda b_, h_, ki: (b_, h_, 0, 0)),
        ],
        body=body)


def paged_decode_builder(D):
    """q: (b, h, 1, d) vs page pools k: (P, hk, page, d), v: (P, hk, page,
    dv), block_table: (b, NP) i32, kv_len: (b, 1) i32, pos_pages:
    (P, page) i32 -> o: (b, h, 1, dv).

    The k, v and pos_pages index maps read the block table at run time
    (``Tile(index_tile=("block_table", 0))``): logical page j of sequence
    b is pool page ``block_table[b, j]``; ``kv_len`` is per sequence and
    ``pos_pages`` the pool slots' absolute positions (-1 empty), as
    ``flash_decode``'s ``slot_pos``."""
    b, h, hk = D.b, D.h, D.hk
    d, dv = D.d, D.dv
    npages, page, nsp = D.npages, D.page, D.nseq_pages
    window = D.window
    sm_scale = D.sm_scale
    g = h // hk
    cap = nsp * page                       # per-sequence slot capacity
    dtype = as_dtype(D.dtype)

    def body(ctx, q_ref, k_ref, v_ref, tab_ref, len_ref, sp_ref, o_ref):
        j = ctx.reduce_id(0)
        q_pos = len_ref[0, 0] - 1            # this sequence's query position
        run = (j * page) <= q_pos
        if window is not None:
            run = run & ((q_pos - (j * page + page - 1)) < window)
        run = run | (q_pos >= cap)
        _decode_body(ctx, ctx.scratch, q_ref, k_ref, v_ref, sp_ref[0], q_pos,
                     run, window, sm_scale, o_ref)

    return Spec(
        "flash_decode_paged",
        grid=(b, h, nsp),
        reduce_axes=(2,),
        scratch=[Scratch((1, 128), _F32),   # m
                 Scratch((1, 128), _F32),   # l
                 Scratch((1, dv), _F32)],   # acc
        inputs=[
            Tile("q", (b, h, 1, d), dtype, block=(1, 1, 1, d),
                 index=lambda b_, h_, j: (b_, h_, 0, 0)),
            # the pool page axis is read from the table per cell (the
            # static map's 0 there is an ignored placeholder)
            Tile("k", (npages, hk, page, d), dtype, block=(1, 1, page, d),
                 index=lambda b_, h_, j: (0, h_ // g, 0, 0),
                 index_tile=("block_table", 0)),
            Tile("v", (npages, hk, page, dv), dtype, block=(1, 1, page, dv),
                 index=lambda b_, h_, j: (0, h_ // g, 0, 0),
                 index_tile=("block_table", 0)),
            Tile("block_table", (b, nsp), torch.int32, block=(1, 1),
                 index=lambda b_, h_, j: (b_, j)),
            Tile("kv_len", (b, 1), torch.int32, block=(1, 1),
                 index=lambda b_, h_, j: (b_, 0)),
            Tile("pos_pages", (npages, page), torch.int32, block=(1, page),
                 index=lambda b_, h_, j: (0, 0),
                 index_tile=("block_table", 0)),
        ],
        outputs=[
            Tile("o", (b, h, 1, dv), dtype, block=(1, 1, 1, dv),
                 index=lambda b_, h_, j: (b_, h_, 0, 0)),
        ],
        body=body)


# ---------------------------------------------------------------------------
# ring attention: one ring step, offsets as (1, 1) inputs
# ---------------------------------------------------------------------------

def ring_flash_fwd_builder(D):
    """One ring step: the forward's online softmax with the end-of-stream
    alignment replaced by the absolute offsets ``q_start`` (the shard's
    first query) and ``k_start`` (the resident kv chunk's first key), read
    from (1, 1) int32 inputs, so one kernel serves every (shard, step).
    o is normalised by the chunk's own l; a row that sees no key gives
    o = 0 and lse = -inf (the merge's identity). The spec declares its
    mesh binding (grid axis 3 across ``ring_steps`` shards of
    ``mesh_axis``, k/v rotating on a ppermute ring); the expansions run
    one step, and the schedule across devices waits for the port's
    mesh."""
    b, h, hk = D.b, D.h, D.hk
    sq, skv, d, dv = D.sq, D.skv, D.d, D.dv
    bq, bkv = D.block_q, D.block_kv
    causal, window, prefix = D.causal, D.window, D.prefix_len
    sm_scale = D.sm_scale
    g = h // hk
    dtype = as_dtype(D.dtype)

    def body(ctx, q_ref, k_ref, v_ref, qs_ref, ks_ref, o_ref, lse_ref):
        m_scr, l_scr, acc_scr = ctx.scratch
        qi = ctx.outer_id(2)
        ki = ctx.reduce_id(0)

        @ctx.when(ctx.is_first)
        def _init():
            _init_softmax(m_scr, l_scr, acc_scr)

        q0 = qs_ref[0, 0]
        k0 = ks_ref[0, 0]
        run = True
        if causal:
            run = run & ((k0 + ki * bkv) <= (q0 + qi * bq + bq - 1))
        if window is not None:
            run = run & (((q0 + qi * bq) - (k0 + ki * bkv + bkv - 1))
                         < window)
        if prefix:
            run = run | ((k0 + ki * bkv) < prefix)

        @ctx.cell_when(run)
        def _step():
            q_pos = q0 + qi * bq + ctx.lane_ids(bq)
            k_pos = k0 + ki * bkv + ctx.lane_ids(bkv)
            q = q_ref[0, 0].to(_F32)
            k = k_ref[0, 0].to(_F32)
            s = _dot_t(q, k) * sm_scale
            mask = _mask_block(q_pos, k_pos, causal=causal, window=window,
                               prefix_len=prefix)
            s = torch.where(mask, s, _NEG_INF)
            _online_softmax_step(m_scr, l_scr, acc_scr, s, mask,
                                 v_ref[0, 0].to(_F32), guard_exp=True)

        @ctx.when(ctx.is_last)
        def _fin():
            _finish(l_scr, acc_scr, m_scr, o_ref, lse_ref)

    return Spec(
        "ring_flash_fwd",
        grid=(b, h, sq // bq, skv // bkv),
        reduce_axes=(3,),
        scratch=[Scratch((bq, 128), _F32),   # m
                 Scratch((bq, 128), _F32),   # l
                 Scratch((bq, dv), _F32)],   # acc
        inputs=[
            Tile("q", (b, h, sq, d), dtype, block=(1, 1, bq, d),
                 index=lambda b_, h_, qi, ki: (b_, h_, qi, 0)),
            Tile("k", (b, hk, skv, d), dtype, block=(1, 1, bkv, d),
                 index=lambda b_, h_, qi, ki: (b_, h_ // g, ki, 0)),
            Tile("v", (b, hk, skv, dv), dtype, block=(1, 1, bkv, dv),
                 index=lambda b_, h_, qi, ki: (b_, h_ // g, ki, 0)),
            Tile("q_start", (1, 1), torch.int32),     # whole-array
            Tile("k_start", (1, 1), torch.int32),     # whole-array
        ],
        outputs=[
            Tile("o", (b, h, sq, dv), dtype, block=(1, 1, bq, dv),
                 index=lambda b_, h_, qi, ki: (b_, h_, qi, 0)),
            Tile("lse", (b, h, sq), _F32, block=(1, 1, bq),
                 index=lambda b_, h_, qi, ki: (b_, h_, qi)),
        ],
        body=body,
        shard=ShardAxis(mesh_axis=D.mesh_axis, axis=3, extent=D.ring_steps,
                        collective="ppermute", rotate=("k", "v")))


def ring_flash_bwd_builder(D):
    """The backward of one ring step at its offsets, from the step's own
    lse and ``delta = rowsum(do * o) - g_lse``: dq in q's dtype and dk,
    dv f32 summed over each kv head's group (``ring_flash_bwd``'s
    outputs); see :func:`_bwd_spec`. The mesh binding declares dk/dv as
    the chunks other shards own (``sharded_outputs``)."""
    return _bwd_spec("ring_flash_bwd", D, offsets=True)
