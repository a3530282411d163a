"""Plain PyTorch selective scan: the function the ``ssm_scan`` kernel
computes (counterpart of ``repro.kernels.ssm_scan.ref`` and of the chunked
scan ``repro.layers.mamba._chunked_scan_jnp``)."""

from __future__ import annotations

import torch

__all__ = ["selective_scan_ref"]

CHUNK = 128    # time steps whose (Bt, c, Dm, N) terms are formed at once


def selective_scan_ref(x, delta, A, B, C, D, *, h0=None):
    """x, delta (Bt, L, Dm); A (Dm, N) f32; B, C (Bt, L, N); D (Dm,) f32;
    h0 (Bt, Dm, N) f32 or None (zeros).

        h_t = exp(delta_t * A) * h_{t-1} + delta_t * B_t * x_t
        y_t = C_t . h_t + D * x_t

    Returns (y (Bt, L, Dm) in x's dtype, hT (Bt, Dm, N) f32). All of it is
    f32, as in the TPU kernel (the JAX oracle forms delta * B * x in the
    inputs' dtype, which differs only when all three are bf16). Time runs
    in chunks of ``CHUNK`` steps: each chunk's decay and input terms are
    formed at once, the state is carried through the chunk in order and
    across chunks, so nothing (Bt, L, Dm, N)-shaped is kept (only one
    chunk)."""
    bt, L, dm = x.shape
    n = A.shape[1]
    h = (torch.zeros((bt, dm, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t0 in range(0, L, CHUNK):
        sl = slice(t0, min(t0 + CHUNK, L))
        xc, dc, bc, cc = x[:, sl], delta[:, sl], B[:, sl], C[:, sl]
        dc = dc.float()
        dA = torch.exp(dc[..., None] * A)                       # (Bt,c,Dm,N)
        dBx = dc[..., None] * bc[:, :, None, :].float() * xc[..., None].float()
        hs = []
        for t in range(xc.shape[1]):
            h = dA[:, t] * h + dBx[:, t]
            hs.append(h)
        hs = torch.stack(hs, dim=1)
        y = torch.einsum("bldn,bln->bld", hs, cc.float()) + D * xc.float()
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1), h
