"""Chunked selective scan in the kernel language (the counterpart of
``repro.kernels.ssm_scan.kernel``).

Channels (d_inner) are the block's lanes and time is walked in order in
chunks, the (d_block, N) state carried in scratch across the chunk grid
(the trailing reduce axis): nothing (Bt, L, Dm, N)-shaped is kept. Each
chunk's y is a streamed output (``Tile(stream=True)``): every grid cell
writes its own block. On ``cuda`` the spec runs on ``csrc/ssm_scan.cu``
(``ops.py`` binds it), whose channel blocks and runs are template
constants, so ``chunk`` and ``d_block`` tile only the torch and loops
expansions. The spec's dtypes are the kernel's: ``delta`` is f32 beside
x, B and C in x's dtype (the JAX spec takes delta in x's dtype).
"""

from __future__ import annotations

import torch

from ...core.lang import Scratch, Spec, Tile, as_dtype

__all__ = ["ssm_scan_builder"]

_F32 = torch.float32


def ssm_scan_builder(D):
    """x: (bt, L, dm); delta: (bt, L, dm) f32; A: (dm, n) f32; B, C:
    (bt, L, n); Dskip: (1, dm) f32; h0: (bt, dm, n) f32 -> y: (bt, L, dm)
    streamed a chunk a cell, hT: (bt, dm, n) f32.

    Grid (bt, dm / d_block, L / chunk): the chunk axis is the sequential
    reduce axis, so the state scratch carries across time; the d blocks
    are independent."""
    bt, L, dm, n = D.bt, D.L, D.dm, D.n
    chunk, dblk = D.chunk, D.d_block
    dtype = as_dtype(D.dtype)

    def body(ctx, x_ref, dt_ref, a_ref, b_ref, c_ref, d_ref, h0_ref,
             y_ref, hT_ref):
        h_scr, = ctx.scratch

        @ctx.when(ctx.is_first)
        def _init():
            h_scr[...] = h0_ref[0]

        A = a_ref[...]                      # (dblk, n)
        Dskip = d_ref[...]                  # (1, dblk)
        x = x_ref[0]                        # (chunk, dblk)
        dt = dt_ref[0]                      # (chunk, dblk)
        Bm = b_ref[0]                       # (chunk, n)
        Cm = c_ref[0]                       # (chunk, n)
        h = h_scr[...]
        ys = []
        for t in range(chunk):              # JAX's fori_loop over the chunk
            dt_t = dt[t][:, None].to(_F32)                     # (dblk, 1)
            x_t = x[t][:, None].to(_F32)
            dA = torch.exp(dt_t * A)                           # (dblk, n)
            dBx = dt_t * Bm[t][None, :].to(_F32) * x_t         # (dblk, n)
            h = dA * h + dBx
            ys.append((h * Cm[t][None, :].to(_F32)).sum(dim=1)
                      + Dskip[0] * x[t].to(_F32))
        h_scr[...] = h
        y_ref[0] = torch.stack(ys).to(y_ref.dtype)   # streamed: this chunk

        @ctx.when(ctx.is_last)
        def _fin():
            hT_ref[0] = h_scr[...]

    return Spec(
        "ssm_scan",
        grid=(bt, dm // dblk, L // chunk),
        reduce_axes=(2,),
        scratch=[Scratch((dblk, n), _F32)],
        inputs=[
            Tile("x", (bt, L, dm), dtype, block=(1, chunk, dblk),
                 index=lambda b, di, ci: (b, ci, di)),
            Tile("delta", (bt, L, dm), _F32, block=(1, chunk, dblk),
                 index=lambda b, di, ci: (b, ci, di)),
            Tile("A", (dm, n), _F32, block=(dblk, n),
                 index=lambda b, di, ci: (di, 0)),
            Tile("B", (bt, L, n), dtype, block=(1, chunk, n),
                 index=lambda b, di, ci: (b, ci, 0)),
            Tile("C", (bt, L, n), dtype, block=(1, chunk, n),
                 index=lambda b, di, ci: (b, ci, 0)),
            Tile("Dskip", (1, dm), _F32, block=(1, dblk),
                 index=lambda b, di, ci: (0, di)),
            Tile("h0", (bt, dm, n), _F32, block=(1, dblk, n),
                 index=lambda b, di, ci: (b, di, 0)),
        ],
        outputs=[
            Tile("y", (bt, L, dm), dtype, block=(1, chunk, dblk),
                 index=lambda b, di, ci: (b, ci, di), stream=True),
            Tile("hT", (bt, dm, n), _F32, block=(1, dblk, n),
                 index=lambda b, di, ci: (b, di, 0)),
        ],
        body=body)
