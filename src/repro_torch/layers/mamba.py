"""mamba1 layers (falcon-mamba): init, full-sequence forward through the
``ssm_scan`` kernel, and the one-step state update of decode. The mamba1
half of ``repro.layers.mamba``; mamba2 (SSD) comes in a later slice.

Parameters of ``n`` stacked layers carry a leading ``(n, ...)`` axis (the
JAX package's scanned stacks); the forward and decode take one layer's
slice. Decode updates its cache IN PLACE (JAX returns a new one).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.ssm_scan import ssm_scan

from .common import dense_init, silu, softplus

__all__ = ["mamba1_init", "mamba1_forward", "mamba1_cache_init",
           "mamba1_decode"]


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
