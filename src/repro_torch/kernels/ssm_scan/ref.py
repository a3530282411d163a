"""Plain PyTorch selective scan: the function the ``ssm_scan`` kernel
computes (counterpart of ``repro.kernels.ssm_scan.ref`` and of the chunked
scan ``repro.layers.mamba._chunked_scan_jnp``)."""

from __future__ import annotations

import torch

__all__ = ["selective_scan_ref", "selective_scan_assoc",
           "selective_scan_tiled_ref"]

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
        # unbind, not dA[:, t]: autograd then stacks the steps' gradients
        # once, where indexing fills a zero (Bt, c, Dm, N) tensor a step
        for a, b in zip(dA.unbind(1), dBx.unbind(1)):
            h = a * h + b
            hs.append(h)
        hs = torch.stack(hs, dim=1)
        y = torch.einsum("bldn,bln->bld", hs, cc.float()) + D * xc.float()
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1), h


def _scan_states(a, b):
    """Every state of h_t = a_t h_{t-1} + b_t from h_0 = 0 along axis 1:
    the inclusive scan of the maps h -> a h + b under the combine
    (a1, b1) then (a2, b2) = (a1 a2, a2 b1 + b2), by the work-efficient
    odd/even recursion of ``jax.lax.associative_scan``: combine each even
    element with the odd one after it, scan those pairs (half as many),
    then fill in the even positions from the scanned odd ones. Only the b
    half of each scanned pair is needed, so the scanned a is never formed;
    each level allocates its output once and writes odd and even
    positions into it (no concatenation)."""
    n = b.shape[1]
    if n < 2:
        return b
    a_odd = a[:, 1::2]
    pair_b = a_odd * b[:, 0:-1:2] + b[:, 1::2]
    pair_a = a[:, 0:-1:2] * a_odd if n >= 4 else None
    odd = _scan_states(pair_a, pair_b)          # the states at 1, 3, 5, ...
    out = torch.empty_like(b)
    out[:, 0] = b[:, 0]
    out[:, 1::2] = odd
    a_even, b_even = a[:, 2::2], b[:, 2::2]
    out[:, 2::2] = a_even * odd[:, :a_even.shape[1]] + b_even
    return out


def selective_scan_assoc(x, delta, A, B, C, D, *, h0=None):
    """:func:`selective_scan_ref`'s function in the parallel associative
    form (the JAX package's ``selective_scan_assoc``, which its op's
    backward differentiates): the decays exp(delta A) and inputs
    delta B x as (Bt, L, Dm, N) f32 terms, h0 folded into the first input
    term, every state at once by :func:`_scan_states`, then y = C . h +
    D x. Returns (y in x's dtype, hT (Bt, Dm, N) f32). Autograd through
    it keeps a few (Bt, L, Dm, N)-shaped tensors, over log2 L levels."""
    dt = delta.float()[..., None]
    dA = torch.exp(dt * A)                                  # (Bt,L,Dm,N)
    dBx = dt * B[:, :, None, :].float() * x[..., None].float()
    if h0 is not None:
        dBx = torch.cat([(dBx[:, :1] + dA[:, :1] * h0.float()[:, None]),
                         dBx[:, 1:]], dim=1)
    hs = _scan_states(dA, dBx)
    y = torch.einsum("bldn,bln->bld", hs, C.float()) + D * x.float()
    return y.to(x.dtype), hs[:, -1]


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
