"""Rotary (split-half rotation, f32 math) and sinusoidal position
embeddings."""

from __future__ import annotations

import torch

__all__ = ["rope_freqs", "apply_rope", "sinusoidal_embedding"]


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (B, H, S, D) with even D; positions: (S,), (B, 1, 1) or a scalar,
    broadcast against (B, H, S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    pos = torch.as_tensor(positions, device=x.device).to(torch.float32)
    angles = pos[..., None] * freqs                           # (..., S, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -log(10000) rounded to f32, as JAX's ``-jnp.log(10000.0)``
_NEG_LOG_1E4 = -float(torch.log(torch.tensor(10000.0)))


def sinusoidal_embedding(positions, d_model: int):
    """(S,) positions -> (S, d_model) f32: sin over the first half of the
    features, cos over the second (the classic transformer sinusoids).
    Computed on the positions' device from no host tensor, so a decode step
    at a device position can be captured into a CUDA graph."""
    pos = torch.as_tensor(positions).to(torch.float32)[..., None]
    half = d_model // 2
    freqs = torch.exp(_NEG_LOG_1E4 * torch.arange(
        half, dtype=torch.float32, device=pos.device) / half)
    ang = pos * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
