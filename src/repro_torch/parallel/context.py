"""Ambient parallelism rules (counterpart of ``repro.parallel.context``).

Models call ``shard_activation(x, kind)``; with no rules in effect this
is a no-op, as in JAX. Under ``use_rules(rules)`` JAX emits a sharding
constraint and leaves the collectives to GSPMD. The port has no GSPMD:
each rank computes on its local shards, and ``shard_activation`` marks
the points where a collective is due. The layers call it there and nowhere
else:

- ``shard_activation(y, "act_btd", partial=True)`` on the output of a
  row-parallel product (``wo``, ``w_down``) or of the vocab-sharded
  embedding lookup: each rank holds a partial sum, and the result is the
  sum over the "model" axis (the backward passes the replicated gradient
  through);
- ``shard_activation(h, "act_btd")`` on a replicated activation about to
  enter column-parallel products (``wq``/``wk``/``wv``, ``w_gate``/
  ``w_up``, the vocab-sharded head): the forward passes it through, the
  backward sums the ranks' partial gradients over "model".

Both are the identity unless the rules declare tensor parallelism
(``Rules(tensor_parallel=True)``, set by ``parallel.make_shardings`` when
the "model" axis has more than one rank). The kinds and
:meth:`Rules.spec` are JAX's table:

  "act_btd"  (batch, seq, d_model)       -> (batch_axes, seq_axes, None)
  "act_btf"  (batch, seq, features)      -> (batch_axes, None, "model")
  "act_bhsd" (batch, heads, seq, hd)     -> (batch_axes, "model", None, None)
  "act_bd"   (batch, d)                  -> (batch_axes, None)
  "act_btv"  (batch, seq, vocab)         -> (batch_axes, None, "model")

Data parallelism needs no marker in the layers: the batch's leading dim
is each rank's slice. Where a loss reads a mean over the GLOBAL batch
(the CE's token mean, MoE's router statistics), :func:`data_sum` and
:func:`data_mean` reduce over the data axes. Their backward is the local
Jacobian (identity for the sum, 1/n for the mean), so every rank holds the
global loss and the sum of the ranks' gradients is its gradient.

``Rules(mesh=..., ring_axis=...)`` sends full-sequence attention down the
ring schedule over ``ring_axis`` instead (parameters replicated).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import torch

from . import comm
from .rules import mesh_shape, spec

__all__ = ["shard_activation", "use_rules", "current_rules", "Rules",
           "local_cfg", "tensor_parallel", "data_sum", "data_mean"]


class Rules:
    def __init__(self, *, batch_axes=("pod", "data"), model_axis="model",
                 seq_axes=None, mesh=None, ring_axis=None,
                 tensor_parallel=False):
        self.batch_axes = batch_axes
        self.model_axis = model_axis
        self.seq_axes = seq_axes
        self.mesh = mesh
        # sequence-parallel attention: when set, q/k/v shard their SEQUENCE
        # dim over this mesh axis and attention runs the ring schedule
        # (kernels.flash_attention.ring)
        self.ring_axis = ring_axis
        # the layers run on their "model" shards with collectives where
        # shard_activation marks them
        self.tensor_parallel = bool(tensor_parallel)

    def spec(self, kind: str):
        """JAX's activation spec of ``kind`` as a tuple (None: no rule)."""
        b, m, s = self.batch_axes, self.model_axis, self.seq_axes
        table = {
            "act_btd": (b, s, None),
            "act_btf": (b, None, m),
            "act_bhsd": ((b, None, self.ring_axis, None) if self.ring_axis
                         else (b, m, None, None)),
            "act_bd": (b, None),
            "act_btv": (b, None, m),
        }
        return spec(*table[kind]) if kind in table else None

    def size(self, axis) -> int:
        """Ranks on ``axis`` (1 without a mesh or without that axis)."""
        if self.mesh is None:
            return 1
        return int(mesh_shape(self.mesh).get(axis, 1))

    def group(self, axis):
        return self.mesh.get_group(axis)

    def coordinate(self, axis) -> int:
        """This rank's index on ``axis``."""
        if self.size(axis) == 1:
            return 0
        return self.mesh.get_local_rank(axis)

    @property
    def data_axes(self) -> tuple:
        """The batch axes the mesh has, each with more than one rank."""
        return tuple(a for a in self.batch_axes if self.size(a) > 1)

    @property
    def data_size(self) -> int:
        n = 1
        for a in self.data_axes:
            n *= self.size(a)
        return n

    def data_index(self) -> int:
        """This rank's slot along the batch axes (row-major over them)."""
        i = 0
        for a in self.data_axes:
            i = i * self.size(a) + self.coordinate(a)
        return i


_rules: contextvars.ContextVar[Optional[Rules]] = contextvars.ContextVar(
    "repro_torch_parallel_rules", default=None)


def current_rules() -> Optional[Rules]:
    return _rules.get()


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    tok = _rules.set(rules)
    try:
        yield
    finally:
        _rules.reset(tok)


def tensor_parallel():
    """(group, size, rank) of the "model" axis when the ambient rules run
    the layers tensor-parallel, else None."""
    r = _rules.get()
    if r is None or not r.tensor_parallel or r.size(r.model_axis) == 1:
        return None
    ax = r.model_axis
    return r.group(ax), r.size(ax), r.coordinate(ax)


def local_cfg(cfg):
    """``cfg`` with this rank's head counts under tensor parallelism (the
    layers read them from the config), else ``cfg`` itself."""
    tp = tensor_parallel()
    if tp is None:
        return cfg
    n = tp[1]
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // n,
                               n_kv_heads=cfg.n_kv_heads // n,
                               head_dim=cfg.resolved_head_dim)


def _model_sum(x, group):
    """``x`` summed over the "model" group; a bf16 or f16 ``x`` is summed in
    f32 and rounded once (not at each addition)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return comm.all_reduce(x.float(), "sum", group).to(x.dtype)
    return comm.all_reduce(x, "sum", group)


class _ReduceFromModel(torch.autograd.Function):
    """Sum of the ranks' partial results; the gradient passes through."""

    @staticmethod
    def forward(ctx, x, group):
        return _model_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    """The identity; the backward sums the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_sum(g, ctx.group), None


def shard_activation(x, kind: str, *, partial: bool = False):
    """Mark ``x`` as taking ``kind``'s layout from here on; a collective
    where tensor parallelism needs one (see the module docstring)."""
    tp = tensor_parallel()
    if tp is None or kind != "act_btd":
        return x
    if partial:
        return _ReduceFromModel.apply(x, tp[0])
    return _CopyToModel.apply(x, tp[0])


class _DataSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        for g in groups:
            x = comm.all_reduce(x, "sum", g)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def data_sum(x):
    """``x`` summed over the ambient rules' data axes (``x`` itself without
    data parallelism); the backward is the identity, so the ranks'
    gradients sum to the gradient of the global sum."""
    r = _rules.get()
    if r is None or r.mesh is None or not r.data_axes:
        return x
    return _DataSum.apply(x, [r.group(a) for a in r.data_axes])


def data_mean(x):
    """``x`` averaged over the data axes (the mean of equal-sized rank
    batches' means is the global batch mean)."""
    r = _rules.get()
    if r is None or r.mesh is None or not r.data_axes:
        return x
    return data_sum(x) / r.data_size
