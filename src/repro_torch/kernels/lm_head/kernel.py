"""Fused LM-head kernels in the kernel language (the counterpart of
``repro.kernels.lm_head.kernel``): x (R, d) @ w (d, V) fused with the row
statistics the LM wants, an online softmax over vocab blocks, so the
(R, V) logits never exist beyond a block.

``lm_head_builder``: grid (rows, nv, nk), ``reduce_axes=(1, 2)`` (the
vocab blocks outer, the d blocks inner). A logits block accumulates over
the d sweep in f32 scratch; once complete (``reduce_last(1)``) it feeds
each row's running max, rescaled sum of exponentials and gold-token
logit, carried across the vocab sweep in scratch. ``emit_logits=1``
(decode, ``csrc/lm_head.cu``): logits ``Tile(reduce=(2,))`` plus row max
and first-occurrence argmax ``Tile(reduce=(1, 2))``; ``emit_logits=0``
(training, ``csrc/lm_head_ce.cu``): lse and gold only.

``lm_head_bwd_builder`` (``csrc/lm_head_ce.cu``'s backward): dl =
g (softmax - onehot) recomputed blockwise from the saved lse, grid
(nr, nv) with both axes sequential: dx accumulates over the vocab blocks,
dw over the row blocks.

Columns at or past ``vocab`` (the padding to a multiple) are excluded
from max, argmax and gold, and the emitted logits carry -1e30 there. The
kernels' own tiles are template constants: ``block_r``, ``block_v`` and
``block_k`` tile only the torch and loops expansions.
"""

from __future__ import annotations

import torch

from ...core.lang import Scratch, Spec, Tile, as_dtype

__all__ = ["lm_head_builder", "lm_head_bwd_builder"]

_NEG_INF = float("-inf")
_PAD_LOGIT = -1e30
_F32 = torch.float32


def _vocab_positions(ctx, vi, bv):
    """(1, bv) absolute vocab positions of block ``vi``."""
    return vi * bv + ctx.lane_ids(bv)[None, :]


def lm_head_builder(D):
    """x: (R, d) @ w: (d, V) -> the fused outputs (see the module doc).

    Defines: R, d, V (padded vocab), vocab (true size), block_r, block_v,
    block_k, emit_logits, dtype."""
    R, d, V, vocab = D.R, D.d, D.V, D.vocab
    br, bv, bk = D.block_r, D.block_v, D.block_k
    emit = bool(D.emit_logits)
    dtype = as_dtype(D.dtype)
    nv, nk = V // bv, d // bk

    def body(ctx, *refs):
        if emit:
            x_ref, w_ref, logits_ref, m_ref, arg_ref = refs
            acc, m_scr, amax_scr = ctx.scratch
        else:
            x_ref, w_ref, lab_ref, lse_ref, gold_ref = refs
            acc, m_scr, l_scr, gold_scr = ctx.scratch
        vi = ctx.reduce_id(0)

        @ctx.when(ctx.is_first)                 # vi == 0 & ki == 0: a row
        def _init_row_state():
            m_scr[...] = torch.full(m_scr.shape, _NEG_INF, dtype=_F32,
                                    device=m_scr.device)
            if emit:
                amax_scr[...] = torch.zeros(amax_scr.shape, dtype=torch.int32,
                                            device=amax_scr.device)
            else:
                l_scr[...] = torch.zeros(l_scr.shape, dtype=_F32,
                                         device=l_scr.device)
                gold_scr[...] = torch.zeros(gold_scr.shape, dtype=_F32,
                                            device=gold_scr.device)

        @ctx.when(ctx.reduce_first(1))          # ki == 0: a vocab block
        def _init_acc():
            acc[...] = torch.zeros(acc.shape, dtype=_F32, device=acc.device)

        acc[...] += torch.matmul(x_ref[...].to(_F32), w_ref[...].to(_F32))

        @ctx.when(ctx.reduce_last(1))           # ki == nk-1: block complete
        def _fold_block():
            s = acc[...]                                    # (br, bv) f32
            v_pos = _vocab_positions(ctx, vi, bv)           # (1, bv)
            valid = v_pos < vocab                           # (1, bv)
            s_m = torch.where(valid, s, _NEG_INF)           # padding out
            bm = s_m.amax(-1, keepdim=True)                 # (br, 1)
            m_prev = m_scr[:, :1]
            m_cur = torch.maximum(m_prev, bm)
            if emit:
                logits_ref[...] = (s + torch.where(valid, 0.0, _PAD_LOGIT)
                                   ).to(logits_ref.dtype)
                # first-occurrence argmax: the first max within the block;
                # across blocks only a strictly larger max displaces it
                in_arg = torch.argmax(s_m, dim=-1).to(torch.int32)  # (br,)
                better = bm > m_prev                        # (br, 1)
                amax_scr[:, :1] = torch.where(
                    better, vi * bv + in_arg[:, None], amax_scr[:, :1])
                m_scr[:, :1] = m_cur
            else:
                # the online-softmax rescale over vocab blocks
                corr = torch.where(m_prev == _NEG_INF, 0.0,
                                   torch.exp(m_prev - m_cur))
                p = torch.where(valid & (m_cur > _NEG_INF),
                                torch.exp(s - m_cur), 0.0)
                l_scr[:, :1] = l_scr[:, :1] * corr + p.sum(-1, keepdim=True)
                m_scr[:, :1] = m_cur
                # gold token: each row's label lands in one vocab block
                hit = (lab_ref[...] == v_pos) & valid       # (br, bv)
                gold_scr[:, :1] += torch.where(hit, s, 0.0).sum(
                    -1, keepdim=True)

        @ctx.when(ctx.is_last)                  # vocab sweep done: flush
        def _flush():
            if emit:
                m_ref[...] = m_scr[:, :1]
                arg_ref[...] = amax_scr[:, :1]
            else:
                l = l_scr[:, :1]
                lse_ref[...] = m_scr[:, :1] + torch.log(
                    torch.where(l == 0.0, 1.0, l))
                gold_ref[...] = gold_scr[:, :1]

    inputs = [
        Tile("x", (R, d), dtype, block=(br, bk),
             index=lambda ri, vi, ki: (ri, ki)),
        Tile("w", (d, V), dtype, block=(bk, bv),
             index=lambda ri, vi, ki: (ki, vi)),
    ]
    row_tile = dict(block=(br, 1), index=lambda ri, vi, ki: (ri, 0))
    if emit:
        outputs = [
            Tile("logits", (R, V), _F32, block=(br, bv),
                 index=lambda ri, vi, ki: (ri, vi), reduce=(2,)),
            Tile("m", (R, 1), _F32, reduce=(1, 2), **row_tile),
            Tile("arg", (R, 1), torch.int32, reduce=(1, 2), **row_tile),
        ]
        scratch = [Scratch((br, bv), _F32),         # logits accumulator
                   Scratch((br, 128), _F32),        # running max (col 0)
                   Scratch((br, 128), torch.int32)]  # running argmax
    else:
        inputs.append(Tile("labels", (R, 1), torch.int32, **row_tile))
        outputs = [
            Tile("lse", (R, 1), _F32, reduce=(1, 2), **row_tile),
            Tile("gold", (R, 1), _F32, reduce=(1, 2), **row_tile),
        ]
        scratch = [Scratch((br, bv), _F32),         # logits accumulator
                   Scratch((br, 128), _F32),        # running max
                   Scratch((br, 128), _F32),        # running sum of exp
                   Scratch((br, 128), _F32)]        # gold-token logit
    return Spec(
        "lm_head_logits" if emit else "lm_head_ce",
        grid=(R // br, nv, nk),
        reduce_axes=(1, 2),
        scratch=scratch,
        inputs=inputs,
        outputs=outputs,
        body=body)


def lm_head_bwd_builder(D):
    """CE backward: x, w, labels, lse, g -> dx (R, d) f32, dw (d, V) f32.

    ``dl = g (exp(s - lse) - onehot(labels))`` on the true vocab,
    recomputed blockwise (no logits residual). Grid (nr, nv), both axes
    sequential: dx accumulates over the inner vocab sweep, dw over the
    outer row sweep (init under ``reduce_first(0)``). The d axis is whole
    in each block."""
    R, d, V, vocab = D.R, D.d, D.V, D.vocab
    br, bv = D.block_r, D.block_v
    dtype = as_dtype(D.dtype)

    def body(ctx, x_ref, w_ref, lab_ref, lse_ref, g_ref, dx_ref, dw_ref):
        vi = ctx.reduce_id(1)

        @ctx.when(ctx.reduce_first(1))       # vi == 0: a fresh row block
        def _init_dx():
            dx_ref[...] = torch.zeros((br, d), dtype=_F32,
                                      device=dx_ref.device)

        @ctx.when(ctx.reduce_first(0))       # ri == 0: first visit of this
        def _init_dw():                      # dw block
            dw_ref[...] = torch.zeros((d, bv), dtype=_F32,
                                      device=dw_ref.device)

        x = x_ref[...].to(_F32)                             # (br, d)
        w = w_ref[...].to(_F32)                             # (d, bv)
        s = torch.matmul(x, w)
        v_pos = _vocab_positions(ctx, vi, bv)               # (1, bv)
        valid = v_pos < vocab
        p = torch.where(valid, torch.exp(s - lse_ref[...]), 0.0)
        hit = (lab_ref[...] == v_pos) & valid               # (br, bv)
        dl = (p - torch.where(hit, 1.0, 0.0)) * g_ref[...]  # (br, bv)
        dx_ref[...] = dx_ref[...] + torch.matmul(dl, w.transpose(0, 1))
        dw_ref[...] = dw_ref[...] + torch.matmul(x.transpose(0, 1), dl)

    row_tile = dict(block=(br, 1), index=lambda ri, vi: (ri, 0))
    return Spec(
        "lm_head_ce_bwd",
        grid=(R // br, V // bv),
        reduce_axes=(0, 1),
        inputs=[
            Tile("x", (R, d), dtype, block=(br, d),
                 index=lambda ri, vi: (ri, 0)),
            Tile("w", (d, V), dtype, block=(d, bv),
                 index=lambda ri, vi: (0, vi)),
            Tile("labels", (R, 1), torch.int32, **row_tile),
            Tile("lse", (R, 1), _F32, **row_tile),
            Tile("g", (R, 1), _F32, **row_tile),
        ],
        outputs=[
            Tile("dx", (R, d), _F32, block=(br, d),
                 index=lambda ri, vi: (ri, 0), reduce=(1,)),
            Tile("dw", (d, V), _F32, block=(d, bv),
                 index=lambda ri, vi: (0, vi), reduce=(0,)),
        ],
        body=body)
