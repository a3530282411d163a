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

Under tensor parallelism the mixers follow their leaves' splits
(``model_split``): mamba1 runs its d_inner shard (x_proj row-parallel, its
outputs summed before falcon's dt/B/C norm), mamba2 its heads, with the
conv output of its di + 2N column shard gathered (:class:`_M2Plan`) and
the gated norm's statistics summed over "model"; ``out_proj`` is
row-parallel in both.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_state

from repro_torch.parallel.context import (cache_split, copy_to_model,
                                          gather_over_model, local_shape,
                                          model_split, model_sum,
                                          partial_product, reduce_over_model,
                                          row_parallel, shard_activation)

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


def _dt_bias(gen, shape, device):
    """dt bias so softplus(bias) spans [1e-3, 1e-1] (the mamba convention).
    On meta tensors the shape alone (meta arithmetic imports
    ``torch._dynamo``: seconds a process, ``parallel.steps.params_shape``)."""
    u = torch.rand(shape, generator=gen, device=device)
    if u.is_meta:
        return u
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return dt0 + torch.log(-torch.expm1(-dt0))


def mamba1_init(gen, cfg, dtype, device, *, n=None):
    """Parameters with the JAX package's names and shapes; ``n`` stacks
    that many layers on a leading axis."""
    d, di = cfg.d_model, cfg.resolved_d_inner
    ns, kc, r = cfg.ssm_state, cfg.ssm_conv, cfg.resolved_dt_rank
    lead = () if n is None else (n,)
    f32 = torch.float32
    dt_bias = _dt_bias(gen, (*lead, di), device)
    if dt_bias.is_meta:
        a_log = torch.empty((*lead, di, ns), dtype=f32, device=device)
    else:
        a_log = torch.log(torch.arange(1, ns + 1, dtype=f32, device=device))
        a_log = a_log.expand(*lead, di, ns).contiguous()
    return {
        "in_x": dense_init(gen, (d, di), dtype, device, n=n),
        "in_z": dense_init(gen, (d, di), dtype, device, n=n),
        "conv_w": dense_init(gen, (kc, di), f32, device, n=n,
                             scale=kc ** -0.5),
        "conv_b": torch.zeros((*lead, di), dtype=f32, device=device),
        "x_proj": dense_init(gen, (di, r + 2 * ns), dtype, device, n=n),
        "dt_w": dense_init(gen, (r, di), f32, device, n=n, scale=r ** -0.5),
        "dt_bias": dt_bias,
        "A_log": a_log,
        "D": torch.ones((*lead, di), dtype=f32, device=device),
        "out_proj": dense_init(gen, (di, d), dtype, device, n=n),
    }


def _mamba1_tp(params, cfg):
    """True when the mixer runs on this rank's d_inner shard: every d_inner
    leaf split over "model" as ``out_proj``'s rows (``model_split``), else
    False (all replicated)."""
    d, di = cfg.d_model, cfg.resolved_d_inner
    n, r, kc = cfg.ssm_state, cfg.resolved_dt_rank, cfg.ssm_conv
    shapes = {"in_x": (d, di), "in_z": (d, di), "conv_w": (kc, di),
              "conv_b": (di,), "x_proj": (di, r + 2 * n), "dt_w": (r, di),
              "dt_bias": (di,), "A_log": (di, n), "D": (di,),
              "out_proj": (di, d)}
    ranges = {k: model_split(k, v, params[k]) for k, v in shapes.items()}
    got = {None if sp is None else (sp.lo, sp.hi) for sp in ranges.values()}
    if len(got) != 1:
        raise ValueError(f"mamba1: the d_inner leaves are split unlike "
                         f"out_proj's rows: {ranges}")
    return None not in got


def _mamba1_dtbc(params, xi, cfg, tp=False):
    """(dt f32, B, C in xi's dtype), each contiguous: the projections of
    the conv output that drive the scan. ``tp``: xi is this rank's d_inner
    shard, so the x_proj outputs are partial sums, added over "model"
    before falcon's norm; dt/B/C then enter this rank's channels."""
    n, r = cfg.ssm_state, cfg.resolved_dt_rank
    if tp:
        dbc = reduce_over_model(partial_product(xi, params["x_proj"])).to(
            xi.dtype)
    else:
        dbc = xi @ params["x_proj"]
    dt_r, Bm, Cm = dbc[..., :r], dbc[..., r:r + n], dbc[..., r + n:]
    if cfg.ssm_bcdt_norm:
        dt_r, Bm, Cm = _rms_nw(dt_r), _rms_nw(Bm), _rms_nw(Cm)
    if tp:
        dt_r, Bm, Cm = (copy_to_model(t) for t in (dt_r, Bm, Cm))
    # dt_w is f32: the product runs in f32, as JAX promotes it
    dt = softplus(dt_r.float() @ params["dt_w"] + params["dt_bias"])
    return dt, Bm.contiguous(), Cm.contiguous()


def _mamba1_scan(params, x, cfg, *, state=False):
    """The mamba1 mixer over a full sequence: (out (B, L, d_model), the
    final state (B, di', N) f32 and the pre-conv x (B, L, di') when
    ``state``, else None for both), the scan on ``ssm_scan`` (the JAX
    layer's pallas branch) or the state-returning ``ssm_scan_state``.
    Under tensor parallelism on this rank's d_inner shard (di'), the
    output summed over "model"."""
    tp = _mamba1_tp(params, cfg)
    xin = shard_activation(x, "act_btd") if tp else x
    xi = xin @ params["in_x"]
    z = xin @ params["in_z"]
    raw = xi
    xi = silu(_causal_conv(xi, params["conv_w"], params["conv_b"]).to(
        xi.dtype))
    dt, Bm, Cm = _mamba1_dtbc(params, xi, cfg, tp)
    A = -torch.exp(params["A_log"])
    hT = None
    if state:
        y, hT = ssm_scan_state(xi, dt, A, Bm, Cm, params["D"])
    else:
        y = ssm_scan(xi, dt, A, Bm, Cm, params["D"])
    y = y * silu(z)
    out = row_parallel(y, params["out_proj"]) if tp else y @ params[
        "out_proj"]
    return out, hT, (raw if state else None)


def mamba1_forward(params, x, cfg):
    """x: (B, L, d_model) -> (B, L, d_model), the scan on ``ssm_scan`` (the
    JAX layer's pallas branch)."""
    return _mamba1_scan(params, x, cfg)[0].to(x.dtype)


def _cache(shapes, device):
    """Zero cache leaves {key: (full shape, dtype)}, each this rank's shard
    under the ambient cache layout (``cache_split``)."""
    return {k: torch.zeros(local_shape(shape, cache_split(k, shape)),
                           dtype=dt, device=device)
            for k, (shape, dt) in shapes.items()}


def mamba1_cache_init(cfg, batch, dtype, device):
    di, n, kc = cfg.resolved_d_inner, cfg.ssm_state, cfg.ssm_conv
    return _cache({"conv": ((batch, kc - 1, di), dtype),
                   "h": ((batch, di, n), torch.float32)}, device)


def mamba1_decode(params, x, cache, cfg):
    """x: (B, 1, d_model): one step of the conv window and the SSM state,
    both updated in ``cache`` in place (this rank's d_inner shard of them
    under tensor parallelism). Returns (y, cache)."""
    tp = _mamba1_tp(params, cfg)
    xi = x @ params["in_x"]                                   # (B, 1, di)
    z = x @ params["in_z"]
    win = torch.cat([cache["conv"], xi.to(cache["conv"].dtype)], dim=1)
    conv = ((win * params["conv_w"]).sum(dim=1, keepdim=True)
            + params["conv_b"])
    xi = silu(conv.to(xi.dtype))
    dt, Bm, Cm = _mamba1_dtbc(params, xi, cfg, tp)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt[:, 0, :, None] * A)                     # (B, di, N)
    dBx = (dt[:, 0, :, None] * Bm[:, 0, None, :]
           * xi[:, 0, :, None]).float()
    h = dA * cache["h"] + dBx
    y = (h * Cm[:, 0, None, :]).sum(-1) + params["D"] * xi[:, 0].float()
    y = y[:, None].to(x.dtype) * silu(z)
    cache["conv"].copy_(win[:, 1:])
    cache["h"].copy_(h)
    out = row_parallel(y, params["out_proj"]) if tp else y @ params[
        "out_proj"]
    return out, cache


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
    dt_bias = _dt_bias(gen, (*lead, h), device)
    a0 = torch.rand((*lead, h), generator=gen, device=device)
    a_log = a0 if a0.is_meta else torch.log(1.0 + a0 * 15.0)
    big = dict(n=n, per_layer=True)
    return {
        "in_z": dense_init(gen, (d, di), dtype, device, **big),
        "in_xbc": dense_init(gen, (d, conv_dim), dtype, device, **big),
        "in_dt": dense_init(gen, (d, h), dtype, device, n=n),
        "conv_w": dense_init(gen, (kc, conv_dim), f32, device, n=n,
                             scale=kc ** -0.5),
        "conv_b": torch.zeros((*lead, conv_dim), dtype=f32, device=device),
        "A_log": a_log,
        "dt_bias": dt_bias,
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


class _M2Plan:
    """This rank's part of a mamba2 mixer under the ambient rules, read off
    its leaves' splits (``model_split``): the d_inner channels [c0, c1)
    (``out_proj``'s rows; ``in_z`` and ``norm_w`` split alike) of the heads
    [c0 / P, c1 / P) (``in_dt``, ``A_log``, ``dt_bias``, ``D``), and the
    conv columns it holds (``in_xbc``, ``conv_w``, ``conv_b``: a split of
    the di + 2N columns x | B | C, which need not line up with the heads:
    the conv output is gathered and each rank takes its heads' x and all
    of B and C)."""

    def __init__(self, params, cfg):
        d, di, n = cfg.d_model, cfg.resolved_d_inner, cfg.ssm_state
        p, kc = cfg.ssm_head_dim, cfg.ssm_conv
        h, cd = di // p, di + 2 * n

        def rng(name, shape):
            sp = model_split(name, shape, params[name])
            return None if sp is None else (sp.lo, sp.hi)

        chans = {rng("out_proj", (di, d)), rng("in_z", (d, di)),
                 rng("norm_w", (di,))}
        heads = {rng(k, s) for k, s in (("in_dt", (d, h)), ("A_log", (h,)),
                                        ("dt_bias", (h,)), ("D", (h,)))}
        conv = {rng(k, s) for k, s in (("in_xbc", (d, cd)),
                                       ("conv_w", (kc, cd)),
                                       ("conv_b", (cd,)))}
        hl = {None if r is None else (r[0] * p, r[1] * p) for r in heads}
        if len(chans) != 1 or len(conv) != 1 or hl != chans:
            raise ValueError(f"mamba2: the d_inner leaves {chans}, the head "
                             f"leaves {heads} and the conv leaves {conv} "
                             "are not split alike")
        (c,), (cv,) = chans, conv
        self.tp = c is not None
        self.chans = c if c is not None else (0, di)
        self.conv = cv
        self.di, self.n = di, n

    def xbc(self, conv_out):
        """(x of this rank's channels, B, C) from this rank's conv output
        columns: gathered over "model" where the conv columns are split."""
        full = (gather_over_model(conv_out, -1) if self.conv is not None
                else conv_out)
        di, n = self.di, self.n
        c0, c1 = self.chans
        return (full[..., c0:c1].contiguous(), full[..., di:di + n],
                full[..., di + n:])

    def gated_norm(self, y, z, norm_w, eps, dtype):
        """mamba2's gated RMSNorm: y * silu(z) in ``dtype``, statistics in
        f32 over the GLOBAL d_inner (the sum of squares summed over "model"
        where the channels are split)."""
        y = y.to(dtype) * silu(z)
        yf = y.float()
        if self.tp:
            ms = model_sum((yf * yf).sum(-1, keepdim=True)) / self.di
        else:
            ms = (yf * yf).mean(-1, keepdim=True)
        return (yf * torch.rsqrt(ms + eps) * norm_w).to(dtype)

    def out(self, y, w):
        return row_parallel(y, w) if self.tp else y @ w


def _mamba2_scan(params, x, cfg):
    """The mamba2 mixer over a full sequence: (out (B, L, d_model), final
    state (B, H', P, N) f32, the pre-conv xBC (B, L, .) of the conv columns
    this rank holds). The scan is ``ssm_scan_state`` (the kernel on the
    card) with the per-head dt and A repeated over each head's P channels
    and D's skip in the kernel; its final state (B, di, N) viewed as
    (B, H, P, N) is the SSD state, channel h P + p. Under tensor
    parallelism on this rank's heads (:class:`_M2Plan`)."""
    b, L, _ = x.shape
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    plan = _M2Plan(params, cfg)
    xc = shard_activation(x, "act_btd") if plan.tp else x
    z = xc @ params["in_z"]
    xbc_raw = (xc if plan.conv is not None else x) @ params["in_xbc"]
    dt = (xc @ params["in_dt"]).float()                       # (B, L, H')
    xbc = silu(_causal_conv(xbc_raw, params["conv_w"], params["conv_b"]).to(
        xbc_raw.dtype))
    if plan.tp and plan.conv is None:
        xbc = copy_to_model(xbc)
    xi, Bm, Cm = plan.xbc(xbc)
    Bm, Cm = Bm.contiguous(), Cm.contiguous()
    di = xi.shape[-1]
    dt = softplus(dt + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    dt_ch = dt.repeat_interleave(p, dim=-1)                   # (B, L, di)
    A_ch = A.repeat_interleave(p)[:, None].expand(di, n).contiguous()
    y, hT = ssm_scan_state(xi, dt_ch, A_ch, Bm, Cm,
                           params["D"].repeat_interleave(p))
    y = plan.gated_norm(y, z, params["norm_w"], cfg.norm_eps, x.dtype)
    out = plan.out(y, params["out_proj"]).to(x.dtype)
    return out, hT.view(b, di // p, p, n), xbc_raw


def mamba2_forward(params, x, cfg):
    """x (B, L, d_model) -> out (B, L, d_model)."""
    return _mamba2_scan(params, x, cfg)[0]


def mamba2_cache_init(cfg, batch, dtype, device):
    di, n, kc, p = (cfg.resolved_d_inner, cfg.ssm_state, cfg.ssm_conv,
                    cfg.ssm_head_dim)
    return _cache({"conv": ((batch, kc - 1, di + 2 * n), dtype),
                   "h": ((batch, di // p, p, n), torch.float32)}, device)


def mamba2_decode(params, x, cache, cfg):
    """x: (B, 1, d_model): one step of the conv window and the SSD state,
    both updated in ``cache`` in place (under tensor parallelism the conv
    window of this rank's conv columns and the state of its heads).
    Returns (y, cache)."""
    b = x.shape[0]
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    plan = _M2Plan(params, cfg)
    z = x @ params["in_z"]
    xbc = x @ params["in_xbc"]
    dt = (x @ params["in_dt"]).float()
    win = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)
    conv = ((win * params["conv_w"]).sum(dim=1, keepdim=True)
            + params["conv_b"])
    xi, Bm, Cm = plan.xbc(silu(conv.to(xbc.dtype)))
    Bm, Cm = Bm[:, 0].float(), Cm[:, 0].float()
    di = xi.shape[-1]
    h = di // p
    dt = softplus(dt + params["dt_bias"])[:, 0]               # (B, H)
    A = -torch.exp(params["A_log"])
    xh = xi.reshape(b, h, p).float()
    dA = torch.exp(dt * A)
    S = (dA[:, :, None, None] * cache["h"] + dt[:, :, None, None]
         * torch.einsum("bn,bhp->bhpn", Bm, xh))
    y = torch.einsum("bn,bhpn->bhp", Cm, S) + params["D"][:, None] * xh
    y = plan.gated_norm(y.reshape(b, 1, di), z, params["norm_w"],
                        cfg.norm_eps, x.dtype)
    cache["conv"].copy_(win[:, 1:])
    cache["h"].copy_(S)
    return plan.out(y, params["out_proj"]), cache
