"""Fused RMSNorm in the kernel language (the counterpart of
``repro.kernels.rmsnorm.kernel``): rows stay in one block per grid cell,
so the sum of squares is within the block (no reduce axis). On the
``cuda`` backend the spec runs on ``csrc/rmsnorm.cu`` (``ops.py`` binds
it).
"""

from __future__ import annotations

import torch

from ...core.lang import Spec, Tile

__all__ = ["rmsnorm_builder"]


def rmsnorm_builder(D):
    """Defines: rows, d, block_rows, eps, dtype, wdtype."""
    def body(ctx, x, w, o):
        xf = x[...].float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        o[...] = (xf * torch.rsqrt(var + D.eps) * w[...]).to(o.dtype)

    rows, d, br = D.rows, D.d, D.block_rows
    return Spec(
        "rmsnorm", grid=(rows // br,),
        inputs=[Tile("x", (rows, d), D.dtype, block=(br, d), index=lambda i: (i, 0)),
                Tile("w", (d,), D.wdtype)],           # whole-array tile
        outputs=[Tile("o", (rows, d), D.dtype, block=(br, d), index=lambda i: (i, 0))],
        body=body)
