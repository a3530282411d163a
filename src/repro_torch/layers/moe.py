"""Mixture-of-Experts with grouped GShard-style capacity dispatch: the
counterpart of ``repro.layers.moe``.

Tokens are dispatched within groups of about ``cfg.moe_group_size`` tokens,
each expert taking at most ``_capacity`` of a group's (token, choice) pairs,
priority by token id; a choice past its expert's capacity is dropped (it
adds nothing, and the surviving gates are not renormalised). Two
realisations of the same function:

  "einsum"  the GShard/Switch one-hot dispatch and combine tensors
            (G, T, E, C), contracted by ``torch.einsum``;
  "gather"  slot tables of E*C entries (token, gate, valid), a gather of
            the experts' inputs and an ``index_add_`` of their outputs.

The expert products are batched ``torch.einsum`` calls: the JAX package
leaves them to XLA outside any Pallas kernel, so they run on cuBLAS here.
The router runs in f32 and returns the load-balance and z losses. One-hot
tensors are comparisons against ``arange`` (``F.one_hot`` on a CUDA tensor
reads the indices' range back to the host, a sync per call).
"""

from __future__ import annotations

import torch

from repro_torch.parallel.context import data_mean

from .common import dense_init, silu

__all__ = ["moe_init", "moe_forward"]


def moe_init(gen, cfg, dtype, device, *, n=None):
    """Parameters of ``n`` stacked MoE layers: ``router`` f32 (d, E), the
    experts' ``w_gate``/``w_up`` (E, d, dff) and ``w_down`` (E, dff, d),
    and ``shared`` (dense SwiGLU of dff * n_shared_experts) when the config
    has shared experts. The expert leaves are drawn a layer at a time
    (:func:`dense_init`'s ``per_layer``), so a deep stack never holds its
    whole f32 draw at once."""
    d = cfg.d_model
    dff = cfg.moe_d_ff or cfg.d_ff
    e = cfg.n_experts
    params = {
        "router": dense_init(gen, (d, e), torch.float32, device, n=n),
        "w_gate": dense_init(gen, (e, d, dff), dtype, device, n=n,
                             per_layer=True),
        "w_up": dense_init(gen, (e, d, dff), dtype, device, n=n,
                           per_layer=True),
        "w_down": dense_init(gen, (e, dff, d), dtype, device, n=n,
                             per_layer=True),
    }
    if cfg.n_shared_experts:
        sdff = dff * cfg.n_shared_experts
        params["shared"] = {
            "w_gate": dense_init(gen, (d, sdff), dtype, device, n=n),
            "w_up": dense_init(gen, (d, sdff), dtype, device, n=n),
            "w_down": dense_init(gen, (sdff, d), dtype, device, n=n),
        }
    return params


def _capacity(tokens_per_group: int, cfg) -> int:
    c = int(tokens_per_group * cfg.n_experts_per_tok * cfg.capacity_factor
            / cfg.n_experts)
    return max(4, -(-c // 4) * 4)


def _router(params, x, cfg):
    """x: (G, T, d) -> gates (G, T, k) f32, idx (G, T, k) int64, aux
    losses. Top-k by a stable descending sort, so equal probabilities keep
    the lower expert first, as ``jax.lax.top_k`` does."""
    logits = x.float() @ params["router"]                       # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    k, e = cfg.n_experts_per_tok, cfg.n_experts
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = srt[..., :k], order[..., :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # batch means: under data parallelism over the global batch, as one
    # device takes them (the lb loss is a product of two such means)
    me = data_mean(probs.mean(dim=(0, 1)))                       # (E,)
    top1 = data_mean(_one_hot(idx[..., 0], e).float().mean(dim=(0, 1)))
    lb_loss = e * torch.sum(me * top1)
    z_loss = data_mean(torch.mean(torch.logsumexp(logits, dim=-1) ** 2))
    return gate, idx, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss}


def _one_hot(idx, e):
    """(..., E) bool: idx's one-hot over E experts."""
    return idx[..., None] == torch.arange(e, device=idx.device)


def _experts(params, ein):
    """The experts' SwiGLU on their slots: ein (G, E, C, d) -> (G, E, C, d)."""
    h = silu(torch.einsum("gecd,edf->gecf", ein, params["w_gate"])) * \
        torch.einsum("gecd,edf->gecf", ein, params["w_up"])
    return torch.einsum("gecf,efd->gecd", h, params["w_down"])


def _dispatch_einsum(params, x, gate, idx, cfg):
    g, t, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    c = _capacity(t, cfg)
    dtype = x.dtype
    # position of each (token, choice) within its expert, choice-major per
    # token, priority by token id; counted in int32 (x's dtype cannot count
    # past 256 exactly in bf16)
    flat = _one_hot(idx, e).to(torch.int32).reshape(g, t * k, e)
    pos = torch.cumsum(flat, dim=1, dtype=torch.int32) * flat - 1
    keep = (pos >= 0) & (pos < c)
    posc = torch.clamp(pos, 0, c - 1)
    # the one-hot (G, T*k, E, C) built in x's dtype, never as int64
    slots = torch.arange(c, device=x.device, dtype=torch.int32)
    disp = ((posc[..., None] == slots) & keep[..., None]).to(dtype)
    disp = disp.reshape(g, t, k, e, c)
    combine = torch.einsum("gtkec,gtk->gtec", disp, gate.to(dtype))
    dispatch = disp.sum(dim=2)                                   # (G,T,E,C)
    ein = torch.einsum("gtec,gtd->gecd", dispatch, x)
    out = _experts(params, ein)
    return torch.einsum("gtec,gecd->gtd", combine, out)


def _dispatch_gather(params, x, gate, idx, cfg):
    """Index-based dispatch: (token, gate, valid) scattered into slot tables
    of E*C + 1 entries per group, the last catching every dropped choice
    (JAX drops them with ``mode="drop"``); the experts' inputs gathered,
    their gated outputs added back with ``index_add_``."""
    g, t, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    c = _capacity(t, cfg)
    dev = x.device
    flat_e = idx.reshape(g, t * k)                                # (G, T*k)
    flat_g = gate.reshape(g, t * k)
    token_of = (torch.arange(t * k, device=dev) // k).expand(g, t * k)
    onehot = _one_hot(flat_e, e).to(torch.int32)
    pos = torch.gather(torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1,
                       2, flat_e[..., None])[..., 0]
    slot = torch.where(pos < c, flat_e * c + pos, e * c)         # e*c: dropped
    n = e * c + 1
    slot_token = torch.zeros((g, n), dtype=torch.long, device=dev).scatter(
        1, slot, token_of)[:, :-1]
    slot_gate = torch.zeros((g, n), dtype=torch.float32, device=dev).scatter(
        1, slot, flat_g)[:, :-1]
    slot_valid = torch.zeros((g, n), dtype=x.dtype, device=dev).scatter(
        1, slot, torch.ones_like(flat_g, dtype=x.dtype))[:, :-1]
    ein = torch.gather(x, 1, slot_token[..., None].expand(g, e * c, d))
    ein = (ein * slot_valid[..., None]).reshape(g, e, c, d)
    out = _experts(params, ein).reshape(g, e * c, d)
    out = out * (slot_gate[..., None].to(out.dtype) * slot_valid[..., None])
    rows = (slot_token + t * torch.arange(g, device=dev)[:, None]).reshape(-1)
    y = torch.zeros((g * t, d), dtype=x.dtype, device=dev)
    return y.index_add_(0, rows, out.reshape(g * e * c, d)).reshape(g, t, d)


def moe_forward(params, x, cfg, *, dispatch="einsum"):
    """x: (B, S, d) -> (y, aux). Tokens are dispatched within groups of
    ``min(cfg.moe_group_size, S)`` tokens, lowered until it divides S."""
    b, s, d = x.shape
    gs = min(cfg.moe_group_size, s)
    while s % gs:
        gs -= 1
    xg = x.reshape(b * (s // gs), gs, d)
    gate, idx, aux = _router(params, xg, cfg)
    if dispatch == "gather":
        y = _dispatch_gather(params, xg, gate, idx, cfg)
    elif dispatch == "einsum":
        y = _dispatch_einsum(params, xg, gate, idx, cfg)
    else:
        raise ValueError(f"moe dispatch must be einsum|gather, got "
                         f"{dispatch!r}")
    y = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        sh = params["shared"]
        hs = silu(x @ sh["w_gate"]) * (x @ sh["w_up"])
        y = y + hs @ sh["w_down"]
    return y, aux
