"""SwiGLU MLP (the projections are ``torch.matmul``, as JAX left them to
XLA). Under tensor parallelism ``w_gate``/``w_up`` are column shards and
``w_down`` a row shard of the full weights: the input is marked for the
backward's sum and the output summed over "model" (``shard_activation``)."""

from __future__ import annotations

from repro_torch.parallel.context import shard_activation

from .common import dense_init, silu

__all__ = ["mlp_init", "mlp_forward"]


def mlp_init(gen, d_model: int, d_ff: int, dtype, device, *, n=None):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype, device, n=n),
        "w_up": dense_init(gen, (d_model, d_ff), dtype, device, n=n),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, device, n=n),
    }


def mlp_forward(params, x):
    x = shard_activation(x, "act_btd")
    h = silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return shard_activation(h @ params["w_down"], "act_btd", partial=True)
