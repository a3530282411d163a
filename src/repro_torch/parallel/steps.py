"""Distributed step builders (counterpart of ``repro.parallel.steps``):
the shardings of parameters, optimizer state, batches and caches, and the
train, prefill and serve steps over a mesh.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with JAX's axis names
("data", "model", optionally "pod") over the ranks of a process group the
caller has started (``launch.mesh``). The specs are JAX's, from
``parallel.rules`` (a spec: a tuple of axis names or None per dim). Each
rank holds its LOCAL shard of every leaf: :class:`Placement` slices a full
tensor to it and gathers the shards back (``parallel.comm``), and the
layers compute on the shards with the collectives ``shard_activation``
marks (``parallel.context``). Tensor parallelism covers every program
kind: each layer reads its leaves' specs and follows them, and the caches
rest in :func:`cache_pspecs`' layouts (``Rules.cache``). Data parallelism
over ("pod", "data") takes every config: each rank runs its slice of the
batch, the loss is the global batch's, and the gradients are summed over
the data axes before AdamW. ``zero1`` keeps each rank's ``zero1_specs`` slice of the
moments and gathers the updated parameters; ``fsdp`` keeps the parameters
themselves sliced at rest, gathers them at the step's start and slices
their reduced gradients (JAX's ZeRO-3 computes the same; its peak memory
differs: the port holds a whole gathered copy for the step).

Without a mesh, or on a mesh of one rank, the steps are the one-device
ones: where JAX jits a train or serve step with its state donated, the
port runs it as one CUDA graph on the card (:class:`TrainGraphStep`,
:class:`GraphStep`): the first call runs eagerly, the second captures one
step and replays it, and every later call replays it; a step serves one
(params, optimizer state) or (params, cache) pair. On the CPU a step is
run eagerly. A step on a mesh of more than one rank runs eagerly on every
device (:class:`ShardedStep`: a gloo collective cannot be captured into a
CUDA graph), and records that in its ``stats``. The prefill (its prompt
length varies; JAX jits it per length), the engine's admission scatter
and sampling stay eager.
"""

from __future__ import annotations

import copy
import functools
import math
import time

import torch

from repro_torch.kernels import add_launches, launch_state, launches_since
from repro_torch.tree import leaves, tree_map, unflatten

from . import comm
from . import rules as R
from .context import Rules, use_rules

__all__ = ["axis_names", "make_shardings", "cache_pspecs", "batch_pspecs",
           "paged_cache_pspecs", "layer_cache_specs", "paged_layer_specs",
           "reshard_cache", "build_train_step", "build_prefill_step",
           "build_serve_step", "build_paged_serve_step", "GraphStep",
           "TrainGraphStep", "ShardedStep", "Placement", "shard_tree",
           "gather_tree", "shard_batch", "capture", "cache_overflow",
           "train_step", "params_shape"]


def _names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_names(mesh):
    """(batch axes, model axis) of ``mesh``: the batch axes are its "pod"
    and "data" axes, in order."""
    batch_axes = tuple(n for n in _names(mesh) if n in ("pod", "data"))
    return batch_axes, "model"


def _multi_rank(mesh) -> bool:
    return mesh is not None and math.prod(R.mesh_shape(mesh).values()) > 1


def params_shape(model):
    """The parameter tree as meta tensors (shapes and dtypes, no memory):
    the counterpart of ``jax.eval_shape(model.init)``."""
    meta = copy.copy(model)
    meta.device = torch.device("meta")
    return meta.init(torch.Generator())


class Placement:
    """One leaf's spec on a mesh: :meth:`local` slices a full tensor to
    this rank's shard, :meth:`gather` rebuilds the full tensor from the
    ranks' shards (exact; every rank of the mesh calls it)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    def _dims(self):
        """(dim, axes) of the sharded dims."""
        out = []
        for i, e in enumerate(self.spec):
            if e is not None:
                out.append((i, e if isinstance(e, tuple) else (e,)))
        return out

    def _slot(self, axes):
        sizes = R.mesh_shape(self.mesh)
        k, i = 1, 0
        for a in axes:
            n = sizes[a]
            c = self.mesh.get_local_rank(a) if n > 1 else 0
            k, i = k * n, i * n + c
        return k, i

    def local(self, full):
        """This rank's shard of ``full`` (a contiguous copy: it keeps no
        view of the full tensor's memory)."""
        t = full
        for dim, axes in self._dims():
            k, i = self._slot(axes)
            if t.shape[dim] % k:
                raise ValueError(f"Placement: dim {dim} of {tuple(t.shape)} "
                                 f"does not divide {k} shards ({axes})")
            c = t.shape[dim] // k
            t = t.narrow(dim, i * c, c)
        return t.clone(memory_format=torch.contiguous_format)

    def gather(self, local):
        """The full tensor of the ranks' shards (innermost axis first)."""
        t = local
        sizes = R.mesh_shape(self.mesh)
        for dim, axes in reversed(self._dims()):
            for a in reversed(axes):
                if sizes[a] > 1:
                    t = comm.all_gather(t, dim, self.mesh.get_group(a))
        return t

    def __repr__(self):
        return f"Placement({self.spec})"


def _placements(mesh, specs, tree):
    """A tree of :class:`Placement` shaped like ``tree`` (its leaves'
    specs in leaf order)."""
    it = iter(R.spec_leaves(specs))
    return tree_map(lambda _: Placement(mesh, next(it)), tree)


def shard_tree(tree, placements):
    """Every leaf of a full ``tree`` sliced to this rank's shard."""
    return tree_map(lambda t, p: p.local(t), tree, placements)


def gather_tree(tree, placements):
    """Every leaf of a tree of shards gathered into the full tensor."""
    return tree_map(lambda t, p: p.gather(t), tree, placements)


def shard_batch(batch, rules):
    """This rank's rows of a global ``batch`` (its leading dim sliced over
    the data axes of ``rules``)."""
    n, i = rules.data_size, rules.data_index()
    if n == 1:
        return batch

    def rows(t):
        if t.shape[0] % n:
            raise ValueError(f"batch of {t.shape[0]} rows does not split "
                             f"over {n} data ranks")
        c = t.shape[0] // n
        return t[i * c:(i + 1) * c]
    return {k: rows(v) for k, v in batch.items()}


def _vocab_refusal(model, n):
    """The one edge tensor parallelism refuses: a vocab split whose last
    shard holds no true column (none of the ten configs on the production
    or local meshes)."""
    if model.vpad % n == 0 and model.cfg.vocab_size <= (n - 1) * (
            model.vpad // n):
        return f"no true vocab column on the last of {n} vocab shards"
    return None


def make_shardings(model, mesh, *, fsdp=False, ring=False):
    """Returns (placements, pspecs, rules, params_shape) for ``model`` on
    ``mesh``: a tree of :class:`Placement` and one of specs for the
    parameters, the :class:`Rules` the steps run under, and the parameter
    tree as meta tensors.

    ``fsdp=True`` additionally shards each param's largest replicated dim
    over the data axis (``zero1_specs``). ``ring=True`` declares
    sequence-parallel ring attention over the "model" axis: attention
    runs the ring schedule when the sequence divides the axis, and the
    parameters stay replicated over "model" (their "model" entries are
    dropped; the ring takes the axis for the sequence). Otherwise a
    "model" axis of more than one rank runs the layers tensor-parallel
    (every program kind: each layer follows its leaves' specs), with the
    caches in JAX's "prefill" layout (``Rules.cache``; the serve steps set
    their own). A vocab split whose last shard holds no true column raises
    ``NotImplementedError``."""
    batch_axes, model_axis = axis_names(mesh)
    names = _names(mesh)
    shape = params_shape(model)
    pspecs = R.param_specs(shape, model.cfg, mesh, model_axis=model_axis)
    if fsdp and "data" in names:
        pspecs = R.zero1_specs(pspecs, shape, mesh, data_axis="data")
    msize = R.mesh_shape(mesh).get(model_axis, 1)
    ring_axis = model_axis if ring and msize > 1 else None
    if ring_axis is not None:
        it = iter(R.spec_leaves(pspecs))
        pspecs = R.spec_map(lambda _n, _l: tuple(
            None if e == model_axis else e for e in next(it)), shape)
    tp = msize > 1 and ring_axis is None
    if tp:
        why = _vocab_refusal(model, msize)
        if why is not None:
            raise NotImplementedError(
                f"tensor parallelism over a model axis of {msize}: "
                f"{model.cfg.name} has {why}")
    bsize = math.prod(R.mesh_shape(mesh)[a] for a in batch_axes)
    rules = Rules(batch_axes=batch_axes, model_axis=model_axis, mesh=mesh,
                  ring_axis=ring_axis, tensor_parallel=tp,
                  cache=layer_cache_specs(model, mesh, bsize, 0,
                                          kind="prefill"))
    return _placements(mesh, pspecs, shape), pspecs, rules, shape


# ---------------------------------------------------------------------------
# cache partition specs (per stack kind; base ranks are kind-specific)
# ---------------------------------------------------------------------------

def _cache_parts(model, mesh, batch, max_len, kind):
    """(attention specs, mamba specs) of one layer's cache (see
    :func:`cache_pspecs`)."""
    cfg = model.cfg
    batch_axes, m = axis_names(mesh)
    sizes = R.mesh_shape(mesh)
    bsize = math.prod(sizes[a] for a in batch_axes)
    b_ax = batch_axes if batch % bsize == 0 else None
    seq_ax = None if b_ax is not None else batch_axes

    def div(dim, axis):
        if axis is None:
            return None
        axes = axis if isinstance(axis, tuple) else (axis,)
        return axis if dim % math.prod(sizes[a] for a in axes) == 0 else None

    hk, hd = max(cfg.n_kv_heads, 1), cfg.resolved_head_dim
    win = min(max_len, cfg.window) if cfg.window else max_len
    msize = sizes[m]

    def attn_spec():
        if cfg.attn_type == "mla":
            lora = cfg.kv_lora_rank
            return {"ckv": R.spec(b_ax, div(max_len, seq_ax), div(lora, m)),
                    "krope": R.spec(b_ax, div(max_len, seq_ax), None),
                    "pos": ()}
        hd_ax = None
        if hk % msize == 0:
            head_ax, kseq_ax = m, div(win, seq_ax)
        elif kind == "decode":
            head_ax = None
            kseq_ax = _join(div(win, seq_ax),
                            m if win % msize == 0 else None)
        else:
            head_ax = None
            kseq_ax = div(win, seq_ax)
            hd_ax = m if hd % msize == 0 else None
        d = {"k": R.spec(b_ax, head_ax, kseq_ax, hd_ax),
             "v": R.spec(b_ax, head_ax, kseq_ax, hd_ax), "pos": ()}
        if cfg.window:
            d["slot_pos"] = R.spec(kseq_ax)
        return d

    def mamba_spec():
        if cfg.ssm_type == "mamba1":
            di = cfg.resolved_d_inner
            return {"conv": R.spec(b_ax, None, div(di, m)),
                    "h": R.spec(b_ax, div(di, m), None)}
        di, n, p = cfg.resolved_d_inner, cfg.ssm_state, cfg.ssm_head_dim
        return {"conv": R.spec(b_ax, None, div(di + 2 * n, m)),
                "h": R.spec(b_ax, div(di // p, m), None, None)}

    return attn_spec(), (mamba_spec() if cfg.ssm_type else {})


def layer_cache_specs(model, mesh, batch: int, max_len: int,
                      kind: str = "decode"):
    """{cache leaf key: its one-layer spec} of :func:`cache_pspecs`' layout
    (what ``Rules.cache`` holds for the layers)."""
    attn, mamba = _cache_parts(model, mesh, batch, max_len, kind)
    out = {k: v for k, v in attn.items() if k != "pos"}
    out.update(mamba)
    return out


def cache_pspecs(model, mesh, batch: int, max_len: int,
                 kind: str = "decode"):
    """JAX's static-cache specs, in JAX's cache structure (a per-stack
    "pos" entry included). kind="decode": layouts for per-token reads (the
    cache sequence sharded over "model" when the kv heads do not divide
    it); kind="prefill": the freshly computed k/v's natural layout (head
    dim sharded). A batch that does not divide the batch axes shards the
    sequence over them instead."""
    attn, mamba = _cache_parts(model, mesh, batch, max_len, kind)

    def prefixed(tree, n_extra):
        return {k: (prefixed(v, n_extra) if isinstance(v, dict)
                    else (None,) * n_extra + tuple(v))
                for k, v in tree.items()}

    stacks = []
    for spec in model.program:
        if spec.kind == "zamba_group":
            stacks.append({"mamba": prefixed(mamba, 2),
                           "attn": prefixed(attn, 1)})
        elif spec.kind in ("mamba1", "mamba2"):
            stacks.append(prefixed(mamba, 1))
        else:
            stacks.append(prefixed(attn, 1))
    return {"pos": (), "stacks": stacks}


def reshard_cache(cache, src, dst, mesh):
    """``cache`` (this rank's shards laid out by the spec tree ``src``)
    moved into the layout of ``dst`` (both :func:`cache_pspecs` trees):
    each leaf whose spec changes is gathered whole and sliced to this
    rank's shard of ``dst``. JAX's serve step takes the prefill's cache in
    the decode layout; this is that move, once, after the prefill."""
    def move(t, a, b):
        if isinstance(t, dict):
            return {k: move(v, a[k], b[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [move(v, x, y) for v, x, y in zip(t, a, b)]
        if tuple(a) == tuple(b):
            return t
        return Placement(mesh, b).local(Placement(mesh, a).gather(t))

    return {"pos": cache["pos"],
            "stacks": move(cache["stacks"], src["stacks"], dst["stacks"])}


def _join(a, b):
    """Two axis selections for one dim as one spec entry."""
    if a is None:
        return b
    if b is None:
        return a
    at = a if isinstance(a, tuple) else (a,)
    bt = b if isinstance(b, tuple) else (b,)
    return at + bt


def batch_pspecs(batch_shapes, mesh):
    """Every batch leaf's leading dim over the batch axes."""
    batch_axes, _ = axis_names(mesh)
    return R.batch_specs(batch_shapes, batch_axes=batch_axes)


def paged_cache_pspecs(model, mesh, batch: int):
    """Specs of a paged decode cache: kv heads over "model" when they
    divide it, else replicated pools; tables, lengths and the position map
    replicated (host-managed control state)."""
    del batch
    pool = {k: (None,) + v for k, v in paged_layer_specs(model, mesh).items()
            if k in ("kp", "vp")}
    return {"table": (), "len": (), "pos_pages": (),
            "stacks": [dict(pool) for _ in model.program]}


def paged_layer_specs(model, mesh):
    """One layer's pool specs (kp, vp (P, Hk, page, hd)) and those of the
    contiguous prefill cache the engine scatters into them (k, v: the same
    kv heads): ``Rules.cache`` for the engine."""
    _, m = axis_names(mesh)
    hk = max(model.cfg.n_kv_heads, 1)
    head_ax = m if hk % R.mesh_shape(mesh)[m] == 0 else None
    spec = (None, head_ax, None, None)
    return {"kp": spec, "vp": spec, "k": spec, "v": spec}


def capture(fn):
    """Capture ``fn()`` into a CUDA graph: (replay, fn's outputs). The
    capture runs fn's Python and enqueues its launches into the graph
    without running them; ``replay()`` runs them, writing the same output
    tensors."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph.replay, out


def cache_overflow(pos: int, cap: int) -> ValueError:
    """The error of a decode step at position ``pos`` of a positional
    cache that holds ``cap`` tokens: raised by the model's eager step and,
    from its host count, by a compiled step before the replay."""
    return ValueError(
        f"kv cache overflow: decode at position {pos} but the cache holds "
        f"{cap} tokens; grow max_len at prefill/init_cache (the write would "
        "overwrite the last slot and attend corrupted history)")


class _Compiled:
    """What a compiled step shares: it serves the pair of state objects of
    its first call (by identity: its graph holds their leaves' addresses),
    captures one step through :func:`capture` with the kernels' launch
    counts taken back (the capture launches nothing), and at each replay
    adds them again (``counts``: what one replay adds), so the counts stay
    eager code's. ``captures`` counts the captures (0 or 1), ``capture_s``
    is the capture's host time. A failed capture or replay raises; nothing
    falls back to eager code."""

    def __init__(self, what, pair_names):
        self._what = what
        self._pair_names = pair_names
        self._pair = None
        self._replay = self._out = self.counts = None
        self.captures = 0
        self.capture_s = 0.0

    def _first_call(self, a, b) -> bool:
        """True at the first call (which records the pair); raises for a
        pair other than the first call's."""
        if self._pair is None:
            self._pair = (a, b)
            return True
        if self._pair[0] is not a or self._pair[1] is not b:
            raise ValueError(
                f"{self._what}: built for the {self._pair_names} of its "
                "first call (its graph holds their addresses); build a new "
                "step for another pair")
        return False

    def _capture(self, fn):
        t0 = time.perf_counter()
        before = launch_state()
        self._replay, self._out = capture(fn)
        self.counts = launches_since(before)
        add_launches(self.counts, -1)        # the capture launched nothing
        self.captures += 1
        self.capture_s = time.perf_counter() - t0

    def _replayed(self):
        self._replay()
        add_launches(self.counts)
        return self._out


class GraphStep(_Compiled):
    """A decode step ``step(params, cache, tokens)`` -> ``fn(params,
    tokens, cache)``'s outputs, where ``fn`` is a model's decode method
    (it updates the cache in place and returns it), run on the card as one
    CUDA graph.

    - The first call runs ``fn`` eagerly. Its outputs are real (a decode
      step writes the cache, so a warm-up cannot be thrown away), and it
      does the one-time work a capture may not: the kernels' builds,
      cuBLAS's handle, each kernel's attribute calls.
    - The second call captures one step over a static (B, 1) int64 token
      buffer and replays it; later calls copy their tokens into the buffer
      and replay. A graph holds the addresses of every leaf of the params
      and the cache, so a step serves the one (params, cache) pair of its
      first call: another params or cache object (by identity, not by
      leaf) raises. The pair's leaves must stay where they are (written in
      place only).
    - The outputs of a replay (next tokens, logits) live in the graph's
      memory and are overwritten by the next replay: read them first.
    - ``capacity(cache)`` (None: unbounded) is the cache's token capacity:
      the position is read once at capture and counted on the host after
      it, and a replay that would pass the capacity raises the eager
      step's :func:`cache_overflow` instead.
    - The kernels' launch counts are taken back after the capture and
      added again at each replay (:class:`_Compiled`)."""

    def __init__(self, fn, *, batch, device, capacity=None):
        super().__init__("serve step", "params and cache")
        self._fn = fn
        self._batch = batch
        self._device = device
        self._capacity = capacity
        self._tok = self._cap = self._at = None

    def __call__(self, params, cache, tokens):
        if tuple(tokens.shape) != (self._batch, 1):
            raise ValueError(f"serve step: tokens must be ({self._batch}, 1),"
                             f" got {tuple(tokens.shape)}")
        with torch.no_grad():
            if self._first_call(params, cache):
                return self._fn(params, tokens.to(self._device), cache)
            if self._replay is None:
                self._cap = (None if self._capacity is None
                             else self._capacity(cache))
                if self._cap is not None:
                    self._at = int(cache["pos"])  # the one read of it
                self._tok = torch.zeros((self._batch, 1), dtype=torch.long,
                                        device=self._device)
                self._capture(lambda: self._fn(params, self._tok, cache))
            if self._cap is not None:
                if self._at >= self._cap:
                    raise cache_overflow(self._at, self._cap)
                self._at += 1
            self._tok.copy_(tokens)
            return self._replayed()


class TrainGraphStep(_Compiled):
    """A train step ``step(params, opt_state, batch)`` -> ``fn(params,
    opt_state, batch)``'s (params, opt_state, loss, metrics), where ``fn``
    is :func:`train_step` (it updates the parameters and the optimizer
    state in place and returns them), run on the card as one CUDA graph.

    - The first call runs ``fn`` eagerly on a side stream (PyTorch's rule
      for the warm-up before a backward is captured); the current stream
      waits for it. It is a real step, and it does the one-time work a
      capture may not: the kernels' builds, cuBLAS's handles, each
      kernel's attribute calls.
    - The second call returns the allocator's cached blocks to the device
      (the graph's private pool takes a second copy of the step's working
      memory beside the eager step's freed blocks), captures one step over
      static batch buffers, one for each leaf of the batch ("tokens", and
      "prefix_embeddings" where the model has a frontend) with the leaf's
      shape and dtype, and replays it; later calls copy their batch in and
      replay. A batch of other keys or shapes raises.
    - A graph holds the addresses of every leaf of the params and the
      optimizer state, so a step serves the one (params, opt_state) pair
      of its first call: another object (by identity) raises. The pair's
      leaves must stay where they are: a restore copies into them in place.
    - The loss, the metrics and the gradients of a replay live in the
      graph's memory and are overwritten by the next replay: read them
      first.
    - The kernels' launch counts are added again at each replay
      (:class:`_Compiled`); a rematerialised layer's kernels count twice."""

    def __init__(self, fn, *, device):
        super().__init__("train step", "params and optimizer state")
        self._fn = fn
        self._device = device
        self._batch = None

    def __call__(self, params, opt_state, batch):
        if self._first_call(params, opt_state):
            side = torch.cuda.Stream(self._device)
            side.wait_stream(torch.cuda.current_stream(self._device))
            with torch.cuda.stream(side):
                out = self._fn(params, opt_state, batch)
            torch.cuda.current_stream(self._device).wait_stream(side)
            return out
        if self._batch is None:
            self._batch = {k: torch.empty(v.shape, dtype=v.dtype,
                                          device=self._device)
                           for k, v in batch.items()}
        shapes = {k: tuple(v.shape) for k, v in batch.items()}
        want = {k: tuple(v.shape) for k, v in self._batch.items()}
        if shapes != want:
            raise ValueError(f"train step: batch {shapes}, but the step was "
                             f"captured for {want}")
        for k, v in batch.items():
            self._batch[k].copy_(v)
        if self._replay is None:
            torch.cuda.empty_cache()
            self._capture(lambda: self._fn(params, opt_state, self._batch))
        return self._replayed()


def _micro_batches(batch, k):
    """``batch`` split into ``k`` micro-batches along the batch axis, as
    JAX's scan reads them (views)."""
    b = batch["tokens"].shape[0]
    if b % k:
        raise ValueError(f"train step: batch {b} does not split into "
                         f"accum_steps={k} micro-batches")
    split = {key: v.reshape(k, b // k, *v.shape[1:])
             for key, v in batch.items()}
    return [{key: v[i] for key, v in split.items()} for i in range(k)]


def _loss_and_grads(model, params, batch, accum_steps):
    """(loss, metrics, grads in ``leaves(params)`` order) of one step, with
    JAX's micro-batch accumulation when ``accum_steps`` > 1. Gradients are
    taken with grad mode on whatever the caller's."""
    with torch.enable_grad():
        if accum_steps == 1:
            loss, metrics = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves(params))
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves(params)]
            loss = 0.0
            for mb in _micro_batches(batch, accum_steps):
                total, _ = model.loss(params, mb)
                for acc, g in zip(grads, torch.autograd.grad(
                        total, leaves(params))):
                    acc.add_(g)
                loss = loss + total.detach()
            for acc in grads:
                acc.div_(accum_steps)
            loss = loss / accum_steps
            metrics = {"ce": loss, "moe_lb": 0.0, "moe_z": 0.0}
    return loss, metrics, list(grads)


def _detached(metrics, opt_metrics):
    return {k: v.detach() if torch.is_tensor(v) else v
            for k, v in dict(metrics, **opt_metrics).items()}


def train_step(model, optimizer, params, opt_state, batch, *,
               accum_steps=1):
    """One eager train step: (params, opt_state, loss, metrics); params and
    the optimizer state are updated in place (and returned). With
    ``accum_steps = k > 1``, JAX's accumulation: the batch splits into k
    micro-batches along its batch axis, their gradients are summed into
    f32 zeros and divided by k, the loss is the mean of the micro-batch
    totals, and the metrics are {"ce": loss, "moe_lb": 0.0, "moe_z": 0.0}
    (then the optimizer's "grad_norm" and "lr", as always). Gradients are
    taken with grad mode on whatever the caller's; the update runs without
    it."""
    loss, metrics, grads = _loss_and_grads(model, params, batch, accum_steps)
    params, opt_state, opt_metrics = optimizer.update(
        unflatten(params, grads), opt_state, params)
    return params, opt_state, loss.detach(), _detached(metrics, opt_metrics)


def _check_accum(accum_steps):
    if not isinstance(accum_steps, int) or accum_steps < 1:
        raise ValueError(f"accum_steps must be an int >= 1, got "
                         f"{accum_steps!r}")


class ShardedStep:
    """A step on a mesh of more than one rank, run eagerly (the collectives
    over gloo cannot be captured into a CUDA graph; graph capture of the
    sharded steps waits for NCCL on cards of their own). ``stats``:
    {"eager": True, "steps", "host_ms" (each call's host wall),
    "collective_ms" (each call's host ms inside ``parallel.comm``),
    "gathered_bytes" (each call's bytes received by ``comm.all_gather``)}."""

    def __init__(self, fn):
        self._fn = fn
        self.stats = {"eager": True, "steps": 0, "host_ms": [],
                      "collective_ms": [], "gathered_bytes": []}

    def __call__(self, *args):
        c0 = comm.elapsed["seconds"]
        b0 = comm.elapsed["gathered_bytes"]
        t0 = time.perf_counter()
        out = self._fn(*args)
        self.stats["steps"] += 1
        self.stats["host_ms"].append(1e3 * (time.perf_counter() - t0))
        self.stats["collective_ms"].append(
            1e3 * (comm.elapsed["seconds"] - c0))
        self.stats["gathered_bytes"].append(
            comm.elapsed["gathered_bytes"] - b0)
        return out


def _data_slices(pspecs, zspecs, data_axis="data"):
    """For each leaf (in leaf order), the dim ``zero1_specs`` added the
    data axis to, or None."""
    out = []
    for p, z in zip(R.spec_leaves(pspecs), R.spec_leaves(zspecs)):
        dims = [i for i, (a, b) in enumerate(zip(p, z))
                if a != b and b == data_axis]
        out.append(dims[0] if dims else None)
    return out


def _slice(t, dim, mesh):
    """This rank's "data" slice of ``t`` along ``dim`` (a view)."""
    if dim is None:
        return t
    c = t.shape[dim] // R.mesh_shape(mesh)["data"]
    return t.narrow(dim, mesh.get_local_rank("data") * c, c)


def _sum_over(tensors, groups):
    """Each tensor summed over every group, in place (one flat buffer a
    dtype, so one all-reduce a group)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        for g in groups:
            comm.all_reduce_(flat, "sum", g)
        off = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def _sharded_norm(grads, specs, mesh):
    """The global norm of gradient shards laid out by ``specs``: each
    leaf's squares summed locally, then over the axes it is sharded on."""
    by_axes = {}
    for g, spec in zip(grads, specs):
        axes = []
        for e in spec:
            if e is not None:
                axes += list(e) if isinstance(e, tuple) else [e]
        key = tuple(a for a in axes if R.mesh_shape(mesh)[a] > 1)
        by_axes.setdefault(key, []).append(torch.sum(torch.square(
            g.float())))
    total = 0.0
    for axes, sq in by_axes.items():
        part = torch.sum(torch.stack(sq))
        for a in axes:
            part = comm.all_reduce(part, "sum", mesh.get_group(a))
        total = total + part
    return torch.sqrt(total)


def _sharded_train_fn(model, optimizer, rules, pspecs, zspecs, *, zero1,
                      fsdp, accum_steps):
    """The multi-rank train step's function (see :func:`build_train_step`).
    ``params`` are this rank's shards (by ``zspecs`` under fsdp, else by
    ``pspecs``), the moments its shards by ``zspecs`` (zero1/fsdp) or
    ``pspecs``, ``batch`` this rank's rows."""
    mesh = rules.mesh
    groups = [rules.group(a) for a in rules.data_axes]
    sliced = (zero1 or fsdp) and rules.size("data") > 1
    ddims = (_data_slices(pspecs, zspecs) if sliced
             else [None] * len(R.spec_leaves(pspecs)))
    dgroup = mesh.get_group("data") if sliced else None

    def step(params, opt_state, batch):
        rest = leaves(params)
        with use_rules(rules):
            if fsdp:
                full = [t if d is None else comm.all_gather(t, d, dgroup)
                        for t, d in zip(rest, ddims)]
                full = [t.detach().requires_grad_(r.requires_grad)
                        for t, r in zip(full, rest)]
                work = unflatten(params, full)
            else:
                work = params
            loss, metrics, grads = _loss_and_grads(model, work, batch,
                                                   accum_steps)
        grads = [g.contiguous() for g in grads]
        # a data-sliced leaf needs only its slice of the sum (a
        # reduce-scatter over "data", then a sum over "pod"); the others
        # are summed whole
        _sum_over([g for g, d in zip(grads, ddims) if d is None], groups)
        rest_groups = [rules.group(a) for a in rules.data_axes
                       if a != "data"]
        for i, d in enumerate(ddims):
            if d is not None:
                grads[i] = comm.reduce_scatter(grads[i], d, dgroup)
                for g in rest_groups:
                    comm.all_reduce_(grads[i], "sum", g)
        gnorm = _sharded_norm(grads, R.spec_leaves(zspecs), mesh)
        if zero1 and not fsdp:
            targets = [_slice(p, d, mesh) for p, d in zip(rest, ddims)]
        else:
            targets = rest
        _, opt_state, opt_metrics = optimizer.update(
            grads, opt_state, targets, gnorm=gnorm)
        if zero1 and not fsdp:
            with torch.no_grad():
                for p, t, d in zip(rest, targets, ddims):
                    if d is not None:
                        p.copy_(comm.all_gather(t, d, dgroup))
        return (params, opt_state, loss.detach(),
                _detached(metrics, opt_metrics))

    return step


def build_train_step(model, optimizer, mesh=None, *, zero1=False,
                     fsdp=False, accum_steps=1):
    """``step(params, opt_state, batch)`` -> (params, opt_state, loss,
    metrics): ``model.loss``, ``torch.autograd.grad``, ``optimizer.update``,
    with JAX's micro-batch accumulation when ``accum_steps`` > 1, params
    and state updated in place (JAX donates them). ``batch`` holds
    "tokens" (B, S) and, for a model with a frontend, "prefix_embeddings"
    (B, P, d). Returns (step, info).

    - No mesh, or a mesh of one rank: :func:`train_step`, on the card as a
      :class:`TrainGraphStep` (one CUDA graph a step after the first call),
      on the CPU eagerly. info: {"accum_steps", "cuda_graph"}.
    - A mesh of more than one rank: a :class:`ShardedStep` (eager). Each
      rank passes its shards of the params and moments (info["params"],
      info["opt"]: trees of :class:`Placement`; :func:`shard_tree` makes
      them from full trees) and its rows of the global batch
      (:func:`shard_batch`); the loss and metrics are the global batch's
      on every rank. ``zero1`` shards the moments by ``zero1_specs``;
      ``fsdp`` the parameters too (at rest). info also holds "pspecs",
      "moment_pspecs", "rules", "cuda_graph" False, "eager" True."""
    _check_accum(accum_steps)
    if not _multi_rank(mesh):
        def step(params, opt_state, batch):
            return train_step(model, optimizer, params, opt_state, batch,
                              accum_steps=accum_steps)

        if model.device.type == "cuda":
            step = TrainGraphStep(step, device=model.device)
        return step, {"accum_steps": accum_steps,
                      "cuda_graph": isinstance(step, TrainGraphStep)}
    placements, pspecs, rules, shape = make_shardings(model, mesh, fsdp=fsdp)
    # the tensor-parallel specs; zero1_specs adds the data axis to one dim
    # of each large leaf (under fsdp make_shardings already did: pspecs)
    tp_specs = make_shardings(model, mesh)[1] if fsdp else pspecs
    if (zero1 or fsdp) and "data" in _names(mesh):
        zspecs = R.zero1_specs(tp_specs, shape, mesh, data_axis="data")
    else:
        zspecs = pspecs
    fn = _sharded_train_fn(model, optimizer, rules, tp_specs, zspecs,
                           zero1=zero1, fsdp=fsdp, accum_steps=accum_steps)
    moments = _placements(mesh, zspecs, shape)
    replicated = Placement(mesh, ())
    return ShardedStep(fn), {
        "accum_steps": accum_steps, "cuda_graph": False, "eager": True,
        "params": placements, "pspecs": pspecs, "moment_pspecs": zspecs,
        "opt": {"m": moments, "v": moments, "step": replicated},
        "rules": rules}


def build_prefill_step(model, mesh, *, batch, max_len, fsdp=False,
                       ring=False):
    """``prefill(params, batch)`` -> ``model.prefill``'s (logits, cache)
    under :func:`make_shardings`'s rules; ``batch`` holds "tokens" (B, S)
    and optionally "prefix_embeddings". ``ring=True`` sends prefill
    attention down the ring schedule when S divides the ring (parameters
    replicated; every rank then holds the full logits and cache).
    Otherwise, on a mesh of more than one rank, ``params`` are this rank's
    shards (``prefill.shardings["params"]``; with ``fsdp`` sliced over
    "data" too, gathered at the call) and ``batch`` its rows; the logits
    (B, Vpad) are whole on every rank, the cache holds this rank's kv heads
    and rows (``prefill.shardings["cache"]``: the "prefill" specs of
    :func:`cache_pspecs`)."""
    placements, pspecs, rules, _ = make_shardings(model, mesh, fsdp=fsdp,
                                                  ring=ring)
    gather = fsdp and _multi_rank(mesh) and "data" in _names(mesh)

    def prefill(params, batch_):
        if gather:
            params = gather_tree(params, placements)
        with use_rules(rules):
            return model.prefill(
                params, batch_["tokens"],
                prefix_embeddings=batch_.get("prefix_embeddings"),
                max_len=max_len)

    prefill.shardings = {"params": placements, "pspecs": pspecs,
                         "rules": rules,
                         "cache": cache_pspecs(model, mesh, batch, max_len,
                                               kind="prefill")}
    return prefill


def _serve(model, method, *, batch, capacity=None):
    """``step(params, cache, tokens)`` over ``method(params, tokens,
    cache)``: a :class:`GraphStep` on the card, the method itself on the
    CPU."""
    if model.device.type == "cuda":
        return GraphStep(method, batch=batch, device=model.device,
                         capacity=capacity)

    def step(params, cache, tokens):
        return method(params, tokens, cache)

    return step


def _with_split(method, split):
    return method if split is None else functools.partial(method,
                                                          split=split)


def _sharded_serve(model, method, mesh, cache):
    """The multi-rank serve step: ``method`` eagerly under the mesh's
    rules with the cache layout ``cache`` (one layer's specs); (step,
    info) with the parameter placements and rules."""
    placements, pspecs, rules, _ = make_shardings(model, mesh)
    rules = rules.with_cache(cache)

    def fn(params, cache, tokens):
        with torch.no_grad(), use_rules(rules):
            return method(params, tokens, cache)

    return ShardedStep(fn), {"params": placements, "pspecs": pspecs,
                             "rules": rules, "cuda_graph": False,
                             "eager": True}


def build_serve_step(model, mesh=None, *, batch, max_len=None, greedy=True,
                     split=None):
    """One-token decode step over a static (contiguous) cache:
    ``step(params, cache, tokens (B, 1))`` -> ``model.greedy_step``'s
    (next (B,), logits (B, Vpad), cache) with ``greedy=True``, else
    ``model.decode_step``'s (logits, cache), leaving sampling to the
    caller. ``split``: ``flash_decode``'s split length in every step (a
    tune winner; None: the kernel's rule); a captured graph keeps it.

    Without a mesh (or on one rank): on the card a :class:`GraphStep` that
    checks the cache's capacity on the host; on the CPU the method,
    eagerly. On a mesh of more than one rank: a :class:`ShardedStep` over
    this rank's parameter shards, its cache in JAX's decode layout (kv
    heads over "model", or the sequence where they do not divide it; rows
    over the batch axes: info["cache_pspecs"], :func:`cache_pspecs` at
    ``max_len``; :func:`reshard_cache` moves a prefill's cache there) and
    its rows of tokens; the greedy logits are this rank's vocab shard, the
    next tokens global. Returns (step, info)."""
    method = _with_split(model.greedy_step if greedy else model.decode_step,
                         split)
    if not _multi_rank(mesh):
        step = _serve(model, method, batch=batch,
                      capacity=model.cache_capacity)
        return step, {"greedy": greedy,
                      "cuda_graph": isinstance(step, GraphStep)}
    step, info = _sharded_serve(model, method, mesh, layer_cache_specs(
        model, mesh, batch, max_len or 0))
    info.update(greedy=greedy, cache_pspecs=cache_pspecs(
        model, mesh, batch, max_len or 0))
    return step, info


def build_paged_serve_step(model, mesh=None, *, batch, greedy=True,
                           split=None):
    """One-token decode step over PAGED KV pools (the continuous-batching
    engine's inner loop): ``step(params, cache, tokens (B, 1))`` ->
    ``model.paged_greedy_step``'s (next, logits, cache) with
    ``greedy=True``, else ``model.paged_decode_step``'s (logits, cache).
    The host mutates only the control state (tables, lengths, position
    rows) between steps, in place, through the serving scheduler.
    ``split``: paged decode's split length (as :func:`build_serve_step`'s).
    A :class:`GraphStep` on the card, the method eagerly on the CPU; on a
    mesh of more than one rank a :class:`ShardedStep` over this rank's
    parameter shards and pools (info["cache_pspecs"]: kv heads over
    "model"; tables, lengths and positions replicated) with every rank's
    tokens. Returns (step, info)."""
    if not model.pageable:
        raise ValueError("build_paged_serve_step: model is not pageable "
                         "(see LM.pageable)")
    method = _with_split(
        model.paged_greedy_step if greedy else model.paged_decode_step, split)
    if not _multi_rank(mesh):
        step = _serve(model, method, batch=batch)
        return step, {"greedy": greedy,
                      "cuda_graph": isinstance(step, GraphStep)}
    step, info = _sharded_serve(model, method, mesh,
                                paged_layer_specs(model, mesh))
    info.update(greedy=greedy,
                cache_pspecs=paged_cache_pspecs(model, mesh, batch))
    return step, info
