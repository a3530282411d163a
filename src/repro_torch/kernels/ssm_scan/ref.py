"""Plain PyTorch selective scan: the function the ``ssm_scan`` kernel
computes (counterpart of ``repro.kernels.ssm_scan.ref`` and of the chunked
scan ``repro.layers.mamba._chunked_scan_jnp``)."""

from __future__ import annotations

import torch

__all__ = ["selective_scan_ref", "selective_scan_tiled_ref"]

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


RUN, RUNS = 16, 8  # csrc/ssm_scan.cu: R steps a thread's run, P runs a tile


def selective_scan_tiled_ref(x, delta, A, B, C, D, *, h0=None):
    """The association order of the ``csrc/ssm_scan.cu`` kernel, in plain
    PyTorch: :func:`selective_scan_ref`'s function, with time cut into
    tiles of ``RUNS`` runs of ``RUN`` steps (steps past L are the identity,
    delta = 0). Each run composes its steps' maps h -> a h + b in order
    from zero, keeping at each step the state reached so far, g_t, and the
    product of the a so far, P_t; the first run's map is then applied to
    the state carried into the tile, and an inclusive scan over the tile's
    runs composes the runs by doubling strides (1, 2, 4), (a1, b1) then
    (a2, b2) = (a1 a2, a2 b1 + b2), which gives the state h_in entering
    each run. y_t = D x_t + sum_i C_t (g_t + P_t h_in). Returns (y in x's
    dtype, hT f32)."""
    bt, L, dm = x.shape
    n = A.shape[1]
    tile = RUN * RUNS
    pad = -L % tile
    f32 = torch.float32
    xs = torch.nn.functional.pad(x.to(f32), (0, 0, 0, pad))
    ds = torch.nn.functional.pad(delta.to(f32), (0, 0, 0, pad))
    bs = torch.nn.functional.pad(B.to(f32), (0, 0, 0, pad))
    cs = torch.nn.functional.pad(C.to(f32), (0, 0, 0, pad))
    h = (torch.zeros((bt, dm, n), dtype=f32, device=x.device) if h0 is None
         else h0.to(f32))
    run = torch.arange(RUNS, device=x.device)[None, :, None, None]
    ys = []
    for t0 in range(0, L + pad, tile):
        sl = slice(t0, t0 + tile)
        dt = ds[:, sl].reshape(bt, RUNS, RUN, dm, 1)
        a = torch.exp(dt * A)                               # (bt,P,R,dm,n)
        b = (dt * xs[:, sl].reshape(bt, RUNS, RUN, dm, 1)
             * bs[:, sl].reshape(bt, RUNS, RUN, 1, n))
        ar = torch.ones((bt, RUNS, dm, n), dtype=f32, device=x.device)
        br = torch.zeros_like(ar)
        gs, ps = [], []
        for r in range(RUN):
            br = a[:, :, r] * br + b[:, :, r]
            ar = ar * a[:, :, r]
            gs.append(br)
            ps.append(ar)
        br = torch.cat([ar[:, :1] * h[:, None] + br[:, :1], br[:, 1:]], dim=1)
        off = 1
        while off < RUNS:
            ap = torch.roll(ar, off, dims=1)
            bp = torch.roll(br, off, dims=1)
            later = run >= off
            ar, br = (torch.where(later, ar * ap, ar),
                      torch.where(later, ar * bp + br, br))
            off *= 2
        hin = torch.cat([h[:, None], br[:, :-1]], dim=1)   # (bt,P,dm,n)
        h = br[:, -1]
        cc = cs[:, sl].reshape(bt, RUNS, RUN, 1, n)
        g, pr = torch.stack(gs, dim=2), torch.stack(ps, dim=2)
        y = (cc * (g + pr * hin[:, :, None])).sum(-1).reshape(bt, tile, dm)
        ys.append(y + D * xs[:, sl])
    return torch.cat(ys, dim=1)[:, :L].to(x.dtype), h
