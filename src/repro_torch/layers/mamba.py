"""Mamba layers: mamba1 (falcon-mamba) and mamba2 / SSD (zamba2): init,
full-sequence forward through the ``ssm_scan`` kernel, and the one-step
state update of decode (the counterpart of ``repro.layers.mamba``).

mamba2's forward takes the route the JAX layer's Pallas branch takes: its
per-head dt, A and D repeated over each head's channels, so that the
per-channel selective scan computes exactly the SSD recurrence (one group
of B and C). ``ssd_ref`` and ``ssd_chunked`` are the plain SSD form (the
JAX layer's ``jnp`` branch), kept for the tests; nothing on the card's
path runs them.

Parameters of ``n`` stacked layers carry a leading ``(n, ...)`` axis (the
JAX package's scanned stacks); the forward and decode take one layer's
slice. Decode updates its cache IN PLACE (JAX returns a new one).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_state

from .common import dense_init, silu, softplus

__all__ = ["mamba1_init", "mamba1_forward", "mamba1_cache_init",
           "mamba1_decode", "mamba2_init", "mamba2_forward",
           "mamba2_cache_init", "mamba2_decode", "ssd_ref", "ssd_chunked"]


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B, L, C); w: (K, C) f32; b: (C,) f32.
    The sum starts from zeros in x's dtype and promotes to f32 at the first
    tap, as the JAX layer's does."""
    k = w.shape[0]
    L = x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    y = torch.zeros_like(x)
    for j in range(k):
        y = y + w[j] * pad[:, j:j + L]
    return y + b


def _rms_nw(x, eps=1e-6):
    """Weightless RMS normalization (falcon-mamba's dt/B/C norm)."""
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)).to(
        x.dtype)


def mamba1_init(gen, cfg, dtype, device, *, n=None):
    """Parameters with the JAX package's names and shapes; ``n`` stacks
    that many layers on a leading axis."""
    d, di = cfg.d_model, cfg.resolved_d_inner
    ns, kc, r = cfg.ssm_state, cfg.ssm_conv, cfg.resolved_dt_rank
    lead = () if n is None else (n,)
    f32 = torch.float32
    # dt bias so softplus(bias) spans [1e-3, 1e-1] (the mamba convention)
    u = torch.rand((*lead, di), generator=gen, device=device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    a_log = torch.log(torch.arange(1, ns + 1, dtype=f32, device=device))
    return {
        "in_x": dense_init(gen, (d, di), dtype, device, n=n),
        "in_z": dense_init(gen, (d, di), dtype, device, n=n),
        "conv_w": dense_init(gen, (kc, di), f32, device, n=n,
                             scale=kc ** -0.5),
        "conv_b": torch.zeros((*lead, di), dtype=f32, device=device),
        "x_proj": dense_init(gen, (di, r + 2 * ns), dtype, device, n=n),
        "dt_w": dense_init(gen, (r, di), f32, device, n=n, scale=r ** -0.5),
        "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),
        "A_log": a_log.expand(*lead, di, ns).contiguous(),
        "D": torch.ones((*lead, di), dtype=f32, device=device),
        "out_proj": dense_init(gen, (di, d), dtype, device, n=n),
    }


def _mamba1_dtbc(params, xi, cfg):
    """(dt f32, B, C in xi's dtype), each contiguous: the projections of
    the conv output that drive the scan."""
    n, r = cfg.ssm_state, cfg.resolved_dt_rank
    dbc = xi @ params["x_proj"]
    dt_r, Bm, Cm = dbc[..., :r], dbc[..., r:r + n], dbc[..., r + n:]
    if cfg.ssm_bcdt_norm:
        dt_r, Bm, Cm = _rms_nw(dt_r), _rms_nw(Bm), _rms_nw(Cm)
    # dt_w is f32: the product runs in f32, as JAX promotes it
    dt = softplus(dt_r.float() @ params["dt_w"] + params["dt_bias"])
    return dt, Bm.contiguous(), Cm.contiguous()


def mamba1_forward(params, x, cfg):
    """x: (B, L, d_model) -> (B, L, d_model), the scan on ``ssm_scan`` (the
    JAX layer's pallas branch)."""
    xi = x @ params["in_x"]
    z = x @ params["in_z"]
    xi = silu(_causal_conv(xi, params["conv_w"], params["conv_b"]).to(
        xi.dtype))
    dt, Bm, Cm = _mamba1_dtbc(params, xi, cfg)
    A = -torch.exp(params["A_log"])
    y = ssm_scan(xi, dt, A, Bm, Cm, params["D"])
    y = y * silu(z)
    return (y @ params["out_proj"]).to(x.dtype)


def mamba1_cache_init(cfg, batch, dtype, device):
    di, n, kc = cfg.resolved_d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "conv": torch.zeros((batch, kc - 1, di), dtype=dtype, device=device),
        "h": torch.zeros((batch, di, n), dtype=torch.float32, device=device),
    }


def mamba1_decode(params, x, cache, cfg):
    """x: (B, 1, d_model): one step of the conv window and the SSM state,
    both updated in ``cache`` in place. Returns (y, cache)."""
    xi = x @ params["in_x"]                                   # (B, 1, di)
    z = x @ params["in_z"]
    win = torch.cat([cache["conv"], xi.to(cache["conv"].dtype)], dim=1)
    conv = ((win * params["conv_w"]).sum(dim=1, keepdim=True)
            + params["conv_b"])
    xi = silu(conv.to(xi.dtype))
    dt, Bm, Cm = _mamba1_dtbc(params, xi, cfg)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt[:, 0, :, None] * A)                     # (B, di, N)
    dBx = (dt[:, 0, :, None] * Bm[:, 0, None, :]
           * xi[:, 0, :, None]).float()
    h = dA * cache["h"] + dBx
    y = (h * Cm[:, 0, None, :]).sum(-1) + params["D"] * xi[:, 0].float()
    y = y[:, None].to(x.dtype) * silu(z)
    cache["conv"].copy_(win[:, 1:])
    cache["h"].copy_(h)
    return y @ params["out_proj"], cache


# ---------------------------------------------------------------------------
# mamba2 (SSD): zamba2's backbone; one group of B and C, a scalar A a head
# ---------------------------------------------------------------------------

def mamba2_init(gen, cfg, dtype, device, *, n=None):
    """Parameters with the JAX package's names and shapes; ``n`` stacks
    that many layers on a leading axis, the three large projections drawn
    a layer at a time."""
    d, di = cfg.d_model, cfg.resolved_d_inner
    ns, kc, p = cfg.ssm_state, cfg.ssm_conv, cfg.ssm_head_dim
    h = di // p
    conv_dim = di + 2 * ns
    lead = () if n is None else (n,)
    f32 = torch.float32
    u = torch.rand((*lead, h), generator=gen, device=device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    a0 = 1.0 + torch.rand((*lead, h), generator=gen, device=device) * 15.0
    big = dict(n=n, per_layer=True)
    return {
        "in_z": dense_init(gen, (d, di), dtype, device, **big),
        "in_xbc": dense_init(gen, (d, conv_dim), dtype, device, **big),
        "in_dt": dense_init(gen, (d, h), dtype, device, n=n),
        "conv_w": dense_init(gen, (kc, conv_dim), f32, device, n=n,
                             scale=kc ** -0.5),
        "conv_b": torch.zeros((*lead, conv_dim), dtype=f32, device=device),
        "A_log": torch.log(a0),
        "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),
        "D": torch.ones((*lead, h), dtype=f32, device=device),
        "norm_w": torch.ones((*lead, di), dtype=f32, device=device),
        "out_proj": dense_init(gen, (di, d), dtype, device, **big),
    }


def _ssd_chunk(S, xc, dtc, A, bc, cc):
    """One SSD chunk. S: (B, H, P, N) carry; xc: (B, c, H, P); dtc:
    (B, c, H); bc, cc: (B, c, N). Returns (S', y (B, c, H, P)), in f32."""
    a = dtc * A                                               # (B, c, H)
    cs = torch.cumsum(a, dim=1)                               # inclusive
    # intra-chunk: G[b, i, j, h] = exp(cs_i - cs_j) dt_j (C_i . B_j), j <= i
    scores = torch.einsum("bin,bjn->bij", cc.float(), bc.float())
    decay = torch.exp(cs[:, :, None, :] - cs[:, None, :, :])  # (B, i, j, H)
    c_len = xc.shape[1]
    tri = torch.tril(torch.ones((c_len, c_len), dtype=torch.bool,
                                device=xc.device))
    G = torch.where(tri[None, :, :, None],
                    scores[..., None] * decay * dtc[:, None, :, :],
                    torch.zeros((), dtype=torch.float32, device=xc.device))
    y_intra = torch.einsum("bijh,bjhp->bihp", G, xc.float())
    # inter-chunk: exp(cs_i) C_i . S
    y_inter = torch.exp(cs)[..., None] * torch.einsum(
        "bin,bhpn->bihp", cc.float(), S)
    w = torch.exp(cs[:, -1:, :] - cs) * dtc                   # (B, c, H)
    S_new = (torch.exp(cs[:, -1])[:, :, None, None] * S
             + torch.einsum("bjh,bjn,bjhp->bhpn", w, bc.float(), xc.float()))
    return S_new, y_intra + y_inter


def ssd_ref(x, dt, A, Bm, Cm):
    """Sequential SSD oracle. x (B, L, H, P); dt (B, L, H); A (H,); Bm, Cm
    (B, L, N) -> y (B, L, H, P) f32."""
    b, L, h, p = x.shape
    n = Bm.shape[-1]
    S = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    x, dt, Bm, Cm = x.float(), dt.float(), Bm.float(), Cm.float()
    ys = []
    for t in range(L):
        dA = torch.exp(dt[:, t] * A)                          # (B, H)
        S = (dA[:, :, None, None] * S + dt[:, t, :, None, None]
             * torch.einsum("bn,bhp->bhpn", Bm[:, t], x[:, t]))
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], S))
    return torch.stack(ys, dim=1)


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk=128, h0=None):
    """The chunked SSD form: (y (B, L, H, P) f32, final state (B, H, P, N)
    f32) from ``h0`` (zeros when None). The chunk shrinks until it divides
    L, as the JAX function's does."""
    b, L, h, p = x.shape
    n = Bm.shape[-1]
    chunk = min(chunk, L)
    while L % chunk:
        chunk -= 1
    S = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    x, dt = x.float(), dt.float()
    ys = []
    for t0 in range(0, L, chunk):
        sl = slice(t0, t0 + chunk)
        S, y = _ssd_chunk(S, x[:, sl], dt[:, sl], A, Bm[:, sl], Cm[:, sl])
        ys.append(y)
    return torch.cat(ys, dim=1), S


def _mamba2_scan(params, x, cfg):
    """The mamba2 mixer over a full sequence: (out (B, L, d_model), final
    state (B, H, P, N) f32, the pre-conv xBC (B, L, di + 2N)). The scan is
    ``ssm_scan_state`` (the kernel on the card) with the per-head dt and A
    repeated over each head's P channels and D's skip in the kernel; its
    final state (B, di, N) viewed as (B, H, P, N) is the SSD state,
    channel h P + p."""
    b, L, _ = x.shape
    di, n, p = cfg.resolved_d_inner, cfg.ssm_state, cfg.ssm_head_dim
    z = x @ params["in_z"]
    xbc_raw = x @ params["in_xbc"]
    dt = (x @ params["in_dt"]).float()                        # (B, L, H)
    xbc = silu(_causal_conv(xbc_raw, params["conv_w"], params["conv_b"]).to(
        xbc_raw.dtype))
    xi = xbc[..., :di].contiguous()
    Bm = xbc[..., di:di + n].contiguous()
    Cm = xbc[..., di + n:].contiguous()
    dt = softplus(dt + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    dt_ch = dt.repeat_interleave(p, dim=-1)                   # (B, L, di)
    A_ch = A.repeat_interleave(p)[:, None].expand(di, n).contiguous()
    y, hT = ssm_scan_state(xi, dt_ch, A_ch, Bm, Cm,
                           params["D"].repeat_interleave(p))
    y = y.to(x.dtype) * silu(z)
    # gated RMSNorm: y * silu(z) in x's dtype, statistics in f32
    yf = y.float()
    y = (yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + cfg.norm_eps)
         * params["norm_w"]).to(x.dtype)
    out = (y @ params["out_proj"]).to(x.dtype)
    return out, hT.view(b, di // p, p, n), xbc_raw


def mamba2_forward(params, x, cfg):
    """x (B, L, d_model) -> out (B, L, d_model)."""
    return _mamba2_scan(params, x, cfg)[0]


def mamba2_cache_init(cfg, batch, dtype, device):
    di, n, kc, p = (cfg.resolved_d_inner, cfg.ssm_state, cfg.ssm_conv,
                    cfg.ssm_head_dim)
    return {
        "conv": torch.zeros((batch, kc - 1, di + 2 * n), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, di // p, p, n), dtype=torch.float32,
                         device=device),
    }


def mamba2_decode(params, x, cache, cfg):
    """x: (B, 1, d_model): one step of the conv window and the SSD state,
    both updated in ``cache`` in place. Returns (y, cache)."""
    b = x.shape[0]
    di, n, p = cfg.resolved_d_inner, cfg.ssm_state, cfg.ssm_head_dim
    h = di // p
    z = x @ params["in_z"]
    xbc = x @ params["in_xbc"]
    dt = (x @ params["in_dt"]).float()
    win = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)
    conv = ((win * params["conv_w"]).sum(dim=1, keepdim=True)
            + params["conv_b"])
    xbc = silu(conv.to(xbc.dtype))
    xi = xbc[..., :di]
    Bm = xbc[:, 0, di:di + n].float()
    Cm = xbc[:, 0, di + n:].float()
    dt = softplus(dt + params["dt_bias"])[:, 0]               # (B, H)
    A = -torch.exp(params["A_log"])
    xh = xi.reshape(b, h, p).float()
    dA = torch.exp(dt * A)
    S = (dA[:, :, None, None] * cache["h"] + dt[:, :, None, None]
         * torch.einsum("bn,bhp->bhpn", Bm, xh))
    y = torch.einsum("bn,bhpn->bhp", Cm, S) + params["D"][:, None] * xh
    y = y.reshape(b, 1, di).to(x.dtype) * silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + cfg.norm_eps)
         * params["norm_w"]).to(x.dtype)
    cache["conv"].copy_(win[:, 1:])
    cache["h"].copy_(S)
    return y @ params["out_proj"], cache
