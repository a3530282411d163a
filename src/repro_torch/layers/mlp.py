"""SwiGLU MLP (the projections are ``torch.matmul``, as JAX left them to
XLA)."""

from __future__ import annotations

from .common import dense_init, silu

__all__ = ["mlp_init", "mlp_forward"]


def mlp_init(gen, d_model: int, d_ff: int, dtype, device, *, n=None):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype, device, n=n),
        "w_up": dense_init(gen, (d_model, d_ff), dtype, device, n=n),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, device, n=n),
    }


def mlp_forward(params, x):
    h = silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]
