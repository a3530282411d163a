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

from repro_torch.parallel.context import (copy_to_model, data_mean,
                                          model_split, partial_product,
                                          shard_activation, widen)

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


def _experts(params, ein, partial=False):
    """The experts' SwiGLU on their slots: ein (G, E, C, d) -> (G, E, C, d).
    ``partial``: each expert's ffn dim is split (TP-MoE), so the output is
    this rank's partial sum, kept in f32 where ``widen`` says."""
    h = silu(torch.einsum("gecd,edf->gecf", ein, params["w_gate"])) * \
        torch.einsum("gecd,edf->gecf", ein, params["w_up"])
    w = params["w_down"]
    if partial:
        h, w = widen(h, w)
    return torch.einsum("gecf,efd->gecd", h, w)


def _dispatch_einsum(params, x, gate, idx, cfg, experts=None, mode=None):
    """The one-hot dispatch, the experts [e0, e1) = ``experts`` (this
    rank's, whose weights ``params`` holds; all by default) run on their
    slots. ``mode`` ("ep" or "ffn", :func:`_expert_plan`): the output is
    this rank's partial sum, kept in f32 where ``widen`` says."""
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
    e0, e1 = experts or (0, e)
    disp = disp[:, :, :, e0:e1]
    combine = torch.einsum("gtkec,gtk->gtec", disp, gate.to(dtype))
    dispatch = disp.sum(dim=2)                                   # (G,T,E,C)
    ein = torch.einsum("gtec,gtd->gecd", dispatch, x)
    out = _experts(params, ein, partial=mode == "ffn")
    if mode is not None:
        combine, out = widen(combine, out)
    return torch.einsum("gtec,gecd->gtd", combine, out.to(combine.dtype))


def _dispatch_gather(params, x, gate, idx, cfg, experts=None, mode=None):
    """Index-based dispatch: (token, gate, valid) scattered into slot tables
    of E*C + 1 entries per group, the last catching every dropped choice
    (JAX drops them with ``mode="drop"``); the inputs of the experts
    [e0, e1) = ``experts`` (their slots of the tables) gathered, their gated
    outputs added back with ``index_add_`` (``mode`` as
    :func:`_dispatch_einsum`'s)."""
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
    e0, e1 = experts or (0, e)
    e = e1 - e0
    slot_token = slot_token[:, e0 * c:e1 * c]
    slot_gate = slot_gate[:, e0 * c:e1 * c]
    slot_valid = slot_valid[:, e0 * c:e1 * c]
    ein = torch.gather(x, 1, slot_token[..., None].expand(g, e * c, d))
    ein = (ein * slot_valid[..., None]).reshape(g, e, c, d)
    out = _experts(params, ein, partial=mode == "ffn").reshape(g, e * c, d)
    if mode is not None:
        (out,) = widen(out)
    out = out * (slot_gate[..., None].to(out.dtype) * slot_valid[..., None])
    rows = (slot_token + t * torch.arange(g, device=dev)[:, None]).reshape(-1)
    y = torch.zeros((g * t, d), dtype=out.dtype, device=dev)
    return y.index_add_(0, rows, out.reshape(g * e * c, d)).reshape(g, t, d)


def _expert_plan(params, cfg):
    """(experts [e0, e1) this rank runs, the split: "ep", "ffn" or None):
    the experts' splits under the ambient rules (``model_split``): EP (the
    experts split: this rank's E / n), TP-MoE (the ffn dim split: every
    expert on this rank's ffn shard), or replicated. Split, the routed
    output is a partial sum over "model"."""
    e, d = cfg.n_experts, cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    splits = {model_split("w_gate", (e, d, f), params["w_gate"]),
              model_split("w_up", (e, d, f), params["w_up"])}
    down = model_split("w_down", (e, f, d), params["w_down"])
    (up,) = splits
    if up is None:
        return (0, e), None
    if up.dim == 0:
        return (up.lo, up.hi), "ep"
    if down is None or down.dim != 1 or (down.lo, down.hi) != (up.lo, up.hi):
        raise ValueError("moe: w_gate/w_up's ffn shard and w_down's rows "
                         "differ")
    return (0, e), "ffn"


def moe_forward(params, x, cfg, *, dispatch="einsum"):
    """x: (B, S, d) -> (y, aux). Tokens are dispatched within groups of
    ``min(cfg.moe_group_size, S)`` tokens, lowered until it divides S.

    Under tensor parallelism the router runs replicated (the same gates,
    drops and ``aux`` on every rank, never summed over "model"); each rank
    runs its experts (EP) or every expert on its ffn shard (TP-MoE), and
    the shared experts on their ffn shard; the partial outputs are summed
    in one all-reduce."""
    b, s, d = x.shape
    gs = min(cfg.moe_group_size, s)
    while s % gs:
        gs -= 1
    experts, mode = _expert_plan(params, cfg)
    routed_partial = mode is not None
    xc = shard_activation(x, "act_btd")
    xg = x.reshape(b * (s // gs), gs, d)
    gate, idx, aux = _router(params, xg, cfg)
    if routed_partial:
        gate = copy_to_model(gate)
    xr = (xc if routed_partial else x).reshape(b * (s // gs), gs, d)
    if dispatch == "gather":
        y = _dispatch_gather(params, xr, gate, idx, cfg, experts, mode)
    elif dispatch == "einsum":
        y = _dispatch_einsum(params, xr, gate, idx, cfg, experts, mode)
    else:
        raise ValueError(f"moe dispatch must be einsum|gather, got "
                         f"{dispatch!r}")
    y = y.reshape(b, s, d)
    partial, whole = [y] if routed_partial else [], [] if routed_partial \
        else [y]
    if cfg.n_shared_experts:
        sh = params["shared"]
        sdff = (cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts
        split = model_split("w_down", (sdff, d), sh["w_down"])
        xs = xc if split is not None else x
        hs = silu(xs @ sh["w_gate"]) * (xs @ sh["w_up"])
        if split is not None:
            partial.append(partial_product(hs, sh["w_down"]))
        else:
            whole.append(hs @ sh["w_down"])
    y = None
    if partial:
        # the routed and the shared experts' partials in one all-reduce, in
        # f32 where widened, rounded once
        y = shard_activation(sum(partial[1:], partial[0]), "act_btd",
                             partial=True).to(x.dtype)
    for w in whole:
        y = w if y is None else y + w
    return y, aux
