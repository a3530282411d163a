"""Blocked matmul in the kernel language: the reduce-axis showcase (the
counterpart of ``repro.kernels.matmul.kernel``).

The K dimension is a sequential reduce axis: grid cells ``(i, j, kk)`` with
the same ``(i, j)`` are visited in ``kk`` order and share one f32 scratch
accumulator (``ctx.scratch``), initialised under ``ctx.when(ctx.is_first)``
and flushed to the output block under ``ctx.when(ctx.is_last)``. On the
``cuda`` backend the spec runs on ``csrc/matmul.cu`` (``ops.py`` binds it).
"""

from __future__ import annotations

import torch

from ...core.lang import Scratch, Spec, Tile

__all__ = ["matmul_builder"]


def matmul_builder(D):
    """Defines: M, K, N, bm, bk, bn, dtype, out_dtype (default dtype)."""
    def body(ctx, a, b, c):
        acc, = ctx.scratch

        @ctx.when(ctx.is_first)
        def _init():
            # zeros from shape/dtype: first-visit scratch is undefined
            acc[...] = torch.zeros(acc.shape, dtype=acc.dtype,
                                   device=acc.device)

        acc[...] += torch.matmul(a[...].float(), b[...].float())

        @ctx.when(ctx.is_last)
        def _flush():
            c[...] = acc[...].to(c.dtype)

    M, K, N = D.M, D.K, D.N
    bm, bk, bn = D.bm, D.bk, D.bn
    out_dtype = getattr(D, "out_dtype", D.dtype)
    return Spec(
        "matmul", grid=(M // bm, N // bn, K // bk),
        reduce_axes=(2,),
        scratch=[Scratch((bm, bn), torch.float32)],
        inputs=[Tile("a", (M, K), D.dtype, block=(bm, bk), index=lambda i, j, kk: (i, kk)),
                Tile("b", (K, N), D.dtype, block=(bk, bn), index=lambda i, j, kk: (kk, j))],
        outputs=[Tile("c", (M, N), out_dtype, block=(bm, bn), index=lambda i, j, kk: (i, j))],
        body=body)
