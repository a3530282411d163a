"""AdamW with global-norm clipping and a warmup-cosine schedule over
tensor trees (the counterpart of ``repro.optim.adamw``).

The arithmetic is the JAX package's: the learning rate at ``step + 1``,
bias corrections in f32, one global norm over all leaves for the clip,
weight decay on every leaf, f32 moments, and the update computed in f32
and cast back to each parameter's dtype. Unlike JAX, ``update`` writes the
new parameters, moments and step count into their own storage (in place)
instead of returning new trees, which saves a copy of each at full size
and lets a CUDA graph replay the update (``parallel.build_train_step``):
the state's ``"step"`` stays one 0-dim int32 device tensor, and the
learning rate, bias corrections and clip are derived from it on the
device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["AdamW", "WarmupCosine", "global_norm"]


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@dataclasses.dataclass(frozen=True)
class WarmupCosine:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    final_frac: float = 0.1

    def __call__(self, step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = self.peak_lr * step / max(self.warmup_steps, 1)
        denom = max(self.total_steps - self.warmup_steps, 1)
        t = torch.clamp((step - self.warmup_steps) / denom, 0.0, 1.0)
        cos = self.final_frac + (1 - self.final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < self.warmup_steps, warm, self.peak_lr * cos)


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: WarmupCosine = WarmupCosine()
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        dev = leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, grads, state, params, *, gnorm=None):
        """One step; params, m, v and the step count are updated IN PLACE.
        Returns (params, state, {"grad_norm", "lr"}) like the JAX
        optimizer, ``params`` and ``state`` the objects passed in.
        ``gnorm``: the global gradient norm when ``grads`` are shards of
        it (the sharded train step computes it over the mesh; the
        arithmetic of every leaf's update is the same), else the norm of
        ``grads``. ``params`` may be a list of tensors (or views of them)
        in the moments' leaf order."""
        step = state["step"]
        step.add_(1)
        if gnorm is None:
            gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        lr = self.schedule(step)
        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state["m"]), leaves(state["v"])):
            g = g.float() * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) \
                + self.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
        return params, state, {"grad_norm": gnorm, "lr": lr}
