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

Where a layer computes it reads each parameter leaf's spec,
:func:`model_split` (the rule tables' spec, the one its ``Placement``
holds: a column shard, a row shard, or replicated), and follows it; it
never infers a layout from the program kind. A replicated leaf computes
replicated, with no collective. Every replicated value holds its whole
gradient on every rank, so where one enters rank-specific work (this
rank's heads, experts or channels) the layers mark it with
:func:`copy_to_model`, and a replicated product's output used so is marked
itself. The other collective points:

- :func:`gather_over_model`: where a shard does not line up with the work
  that follows (k/v split mid-head: RoPE pairs dims i and i + hd/2; query
  heads that do not divide the axis; mamba2's conv output, split across
  x, B and C), the rank gathers the activation it needs; the backward sums
  the ranks' gradients and keeps the rank's slice;
- :func:`model_sum`: the global sum of a statistic over a split dim (the
  gated RMSNorm's sum of squares), used by each rank for its shard;
- :func:`reduce_over_model`: partial sums used as a replicated value
  (mamba1's x_proj outputs before falcon's dt/B/C norm);
- :func:`merge_over_model`: the exact lse merge of a sequence-sharded
  decode cache's partials (``ring_merge``).

A cache rests in the layout of the rules' ``cache`` specs (one layer's,
from ``parallel.steps.cache_pspecs``); :func:`cache_split` reads it.

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
import copy
import contextvars
import dataclasses
from typing import Optional

import torch

from . import comm
from .rules import leaf_spec, mesh_shape, spec

__all__ = ["shard_activation", "use_rules", "current_rules", "Rules",
           "tensor_parallel", "data_sum", "data_mean", "Split",
           "model_split", "cache_split", "local_shape", "copy_to_model",
           "reduce_over_model", "gather_over_model", "model_sum",
           "merge_over_model", "row_parallel", "partial_product",
           "widen"]


class Rules:
    def __init__(self, *, batch_axes=("pod", "data"), model_axis="model",
                 seq_axes=None, mesh=None, ring_axis=None,
                 tensor_parallel=False, cache=None):
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
        # {cache leaf key: its one-layer spec} of the caches the steps make
        # and read under these rules (``parallel.steps.cache_pspecs``'
        # layout of one layer): the layers place their cache writes and
        # reads by it (``cache_split``)
        self.cache = dict(cache or {})

    def with_cache(self, cache):
        """These rules with another cache layout (see ``cache``)."""
        out = copy.copy(self)
        out.cache = dict(cache)
        return out

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


@dataclasses.dataclass(frozen=True)
class Split:
    """How a tensor is split over "model": dim ``dim`` of ``size`` in ``n``
    equal slices, this rank holding slice ``r``, elements [lo, hi)."""
    dim: int
    size: int
    n: int
    r: int

    @property
    def width(self) -> int:
        return self.size // self.n

    @property
    def lo(self) -> int:
        return self.r * self.width

    @property
    def hi(self) -> int:
        return self.lo + self.width


def _split_of(spec, shape, name):
    tp = tensor_parallel()
    if tp is None:
        return None
    r = _rules.get()
    dims = [i for i, e in enumerate(spec) if e is not None
            and r.model_axis in (e if isinstance(e, tuple) else (e,))]
    if not dims:
        return None
    if len(dims) > 1:
        raise ValueError(f"{name}: spec {spec} splits more than one dim over "
                         f"{r.model_axis!r}")
    return Split(dims[0], int(shape[dims[0]]), tp[1], tp[2])


def model_split(name, full_shape, local=None):
    """How the parameter leaf ``name`` of (one layer's) ``full_shape`` is
    split over "model" under the ambient rules: its spec from the rule
    tables (``rules.leaf_spec``, the spec its :class:`Placement` holds) as a
    :class:`Split`, or None where it is replicated or the rules run no
    tensor parallelism. Given the ``local`` tensor, its shape is checked
    against the split."""
    tp = tensor_parallel()
    if tp is None:
        return None
    sp = _split_of(leaf_spec(name, tuple(full_shape), tp[1],
                             _rules.get().model_axis), full_shape, name)
    if local is not None:
        want = list(full_shape)
        if sp is not None:
            want[sp.dim] = sp.width
        if list(local.shape[-len(want):]) != want:
            raise ValueError(f"{name}: local shape {tuple(local.shape)} is "
                             f"not the shard {tuple(want)} of "
                             f"{tuple(full_shape)} its spec makes")
    return sp


def cache_split(key, shape, *, local=False):
    """How the cache leaf ``key`` (one layer's, unstacked, of ``shape``)
    rests over "model": the ambient rules' cache spec for it
    (``Rules.cache``, set by the step builders from ``cache_pspecs``) as a
    :class:`Split`, or None (replicated, or no cache layout in effect).
    ``local=True``: ``shape`` is this rank's shard (the full size of the
    split dim is n times its)."""
    r = _rules.get()
    if r is None or not r.cache or key not in r.cache:
        return None
    sp = _split_of(r.cache[key], shape, key)
    if sp is not None and local:
        sp = dataclasses.replace(sp, size=sp.size * sp.n)
    return sp


def local_shape(full_shape, split):
    """``full_shape`` with ``split``'s dim cut to this rank's slice."""
    shape = list(full_shape)
    if split is not None:
        shape[split.dim] = split.width
    return tuple(shape)


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


_LOW = (torch.bfloat16, torch.float16)


def _keep_f32(*ts) -> bool:
    """True where a rank's partial sum of ``ts`` is kept in f32: tensor
    parallelism on, low-precision operands, no gradient asked (a backward
    keeps the operands' dtype: an f32 copy of every weight would be kept
    for it)."""
    return (tensor_parallel() is not None and ts[0].dtype in _LOW
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in ts)))


def widen(*ts):
    """``ts`` as f32 where a rank's partial sum of them is kept in f32
    (:func:`row_parallel`'s rule), else as they are."""
    if not _keep_f32(*ts):
        return ts
    return tuple(t.float() for t in ts)


def partial_product(a, w):
    """``a @ w`` where it is this rank's partial sum of a product whose
    contracted dim is split over "model": in f32 where :func:`widen` keeps
    partials so (on the card the product's f32 accumulation as it is,
    ``bmm(out_dtype=)``, with no f32 copy of ``w``), else ``a @ w``."""
    if not _keep_f32(a, w):
        return a @ w
    if a.is_cuda and a.dtype == w.dtype:
        return torch.bmm(a.reshape(1, -1, a.shape[-1]), w[None],
                         out_dtype=torch.float32).reshape(*a.shape[:-1],
                                                          w.shape[-1])
    return a.float() @ w.float()


def row_parallel(a, w):
    """``a @ w`` of a row-parallel product (``a``'s last dim and ``w``'s
    rows this rank's shard), summed over "model": each rank's partial in
    f32 where the operands are bf16/f16 (:func:`partial_product`), the sum
    rounded once to their dtype, as one rank rounds its whole product
    once. Without tensor parallelism, ``a @ w``."""
    if tensor_parallel() is None:
        return a @ w
    return shard_activation(partial_product(a, w), "act_btd",
                            partial=True).to(a.dtype)


def copy_to_model(x):
    """The identity whose backward sums the ranks' gradients over "model":
    where a replicated value enters rank-specific work (a column shard's
    product, this rank's heads or experts) its gradient is each rank's
    part. The identity without tensor parallelism."""
    tp = tensor_parallel()
    return x if tp is None else _CopyToModel.apply(x, tp[0])


def reduce_over_model(x):
    """The sum over "model" of the ranks' partial results, used as a
    replicated value (its gradient passes through)."""
    tp = tensor_parallel()
    return x if tp is None else _ReduceFromModel.apply(x, tp[0])


class _GatherModel(torch.autograd.Function):
    """The ranks' slices concatenated along ``dim``; the backward sums the
    ranks' gradients and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return comm.all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return comm.reduce_scatter(g.contiguous(), ctx.dim, ctx.group), \
            None, None


def gather_over_model(x, dim):
    """The whole of an activation each rank holds a ``dim`` slice of (in
    rank order): where a shard does not line up with the work that follows,
    the rank gathers the activation it needs instead of another parameter
    layout. The backward sums the ranks' gradients and keeps this rank's
    slice. ``x`` itself without tensor parallelism."""
    tp = tensor_parallel()
    if tp is None:
        return x
    return _GatherModel.apply(x, dim % x.dim(), tp[0])


class _SumOverModel(torch.autograd.Function):
    """The ranks' partial sums added, where each rank uses the total for its
    own shard: the backward sums the ranks' gradients too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _model_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _model_sum(g, ctx.group), None


def model_sum(x):
    """The global sum of a statistic each rank sums over its shard (the
    sum of squares of a norm over a dim split over "model"), used by each
    rank for its own shard: forward and backward are sums over "model"."""
    tp = tensor_parallel()
    return x if tp is None else _SumOverModel.apply(x, tp[0])


def merge_over_model(o, lse):
    """The exact softmax merge over "model" of each rank's attention partial
    (o, lse) over its slice of the keys (a sequence-sharded decode cache):
    every rank's partial is gathered and folded in rank order by
    ``ring_merge`` (a slice with no visible key, lse = -inf, weighs 0), so
    every rank holds the same merged o. Forward only (decode)."""
    from repro_torch.kernels.flash_attention.ring import ring_merge

    tp = tensor_parallel()
    if tp is None:
        return o
    group, n, _ = tp
    os_ = comm.all_gather(o.unsqueeze(0), 0, group)
    ls = comm.all_gather(lse.float().reshape(1, *o.shape[:-1]), 0, group)
    out = (os_[0], ls[0])
    for i in range(1, n):
        out = ring_merge(out, (os_[i], ls[i]))
    return out[0]


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
