"""SwiGLU MLP (the projections are ``torch.matmul``, as JAX left them to
XLA). Under tensor parallelism ``w_gate``/``w_up`` are column shards and
``w_down`` a row shard of the full weights where their spec splits the ffn
dim (``model_split``): the input is marked for the backward's sum and the
output summed over "model" (``row_parallel``); replicated, the MLP runs
replicated."""

from __future__ import annotations

from repro_torch.parallel.context import (model_split, row_parallel,
                                          shard_activation)

from .common import dense_init, silu

__all__ = ["mlp_init", "mlp_forward"]


def mlp_init(gen, d_model: int, d_ff: int, dtype, device, *, n=None):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype, device, n=n),
        "w_up": dense_init(gen, (d_model, d_ff), dtype, device, n=n),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, device, n=n),
    }


def mlp_forward(params, x, d_ff):
    """x (..., d) -> (..., d); ``d_ff`` the whole ffn width (the split of
    ``w_down``'s rows is read against it)."""
    w = params["w_down"]
    if model_split("w_down", (d_ff, x.shape[-1]), w) is None:
        return (silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ w
    x = shard_activation(x, "act_btd")
    h = silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return row_parallel(h, w)
