"""Shared layer utilities: init, RMSNorm, SiLU, softplus.

``rmsnorm`` is the kernel wrapper itself, which launches the CUDA C++ kernel
for a CUDA tensor and takes the plain version for a CPU tensor; there is no
backend switch as in ``repro.layers.common``.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels.rmsnorm import rmsnorm

__all__ = ["dense_init", "keeping", "rmsnorm", "silu", "softplus"]

_KEEP = contextvars.ContextVar("repro_torch_dense_init_keep", default=None)


@contextlib.contextmanager
def keeping(fn):
    """Within: every tensor :func:`dense_init` makes is passed to ``fn`` as
    soon as it is drawn, and ``fn``'s result is what the init keeps (a
    rank's shard of the leaf: ``LM.init(placements=)``)."""
    tok = _KEEP.set(fn)
    try:
        yield
    finally:
        _KEEP.reset(tok)


def _kept(t):
    fn = _KEEP.get()
    return t if fn is None else fn(t)


def dense_init(gen, shape, dtype, device, *, n=None, scale=None,
               per_layer=False):
    """Truncated-normal (+-3 std) fan-in init, drawn from the explicit
    ``torch.Generator`` ``gen`` (on ``device``). ``n`` stacks that many
    layers on a leading axis; the fan-in is the per-layer ``shape[0]``.
    ``per_layer`` draws the ``n`` layers one at a time into a stack
    allocated in ``dtype`` (other values than one draw of the whole stack):
    the f32 temporaries are then one layer's, not the stack's."""
    full = tuple(shape) if n is None else (n, *shape)
    if torch.device(device).type == "meta":
        # shapes only (parallel.steps.params_shape): no draw, and no meta
        # arithmetic, which imports torch._dynamo
        return _kept(torch.empty(full, dtype=dtype, device=device))
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    if per_layer and n is not None:
        out = torch.empty((n, *shape), dtype=dtype, device=device)
        t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
        for i in range(n):
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
            out[i].copy_(t.mul_(std))
        del t
        return _kept(out)
    t = torch.empty(full, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return _kept((t * std).to(dtype))


def silu(x):
    return x * torch.sigmoid(x)


def softplus(x):
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it (no threshold)."""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0)
