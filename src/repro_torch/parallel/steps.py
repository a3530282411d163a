"""Step builders (counterpart of ``repro.parallel.steps``): the train step,
a prefill step under sequence-parallel rules, and the serve steps of the
static and the paged decode loops. There are no parameter shardings:
weights and optimizer moments stay replicated on every rank until tensor
parallelism is ported, and the train and serve steps take no mesh.

Where JAX jits a train or serve step with its state donated, the port runs
it as one CUDA graph on the card (:class:`TrainGraphStep`,
:class:`GraphStep`): the first call runs eagerly, the second captures one
step and replays it, and every later call replays it; a step serves one
(params, optimizer state) or (params, cache) pair. On the CPU a step is
run eagerly. The prefill (its prompt length varies; JAX jits it per
length), the engine's admission scatter and sampling stay eager.
"""

from __future__ import annotations

import functools
import time

import torch

from repro_torch.kernels import add_launches, launch_state, launches_since
from repro_torch.tree import leaves, unflatten

from .context import Rules, use_rules

__all__ = ["make_shardings", "build_train_step", "build_prefill_step",
           "build_serve_step", "build_paged_serve_step", "GraphStep",
           "TrainGraphStep", "capture", "cache_overflow", "train_step"]


def make_shardings(model, mesh, *, ring=False):
    """The :class:`Rules` for ``model`` on ``mesh``: ``ring=True`` declares
    sequence-parallel ring attention over the "model" axis when that axis
    has more than one rank (``ring_axis`` stays None otherwise)."""
    del model  # parameter shardings come with tensor parallelism
    names = mesh.mesh_dim_names or ()
    size = mesh.size(names.index("model")) if "model" in names else 1
    return Rules(mesh=mesh, ring_axis="model" if ring and size > 1 else None)


def build_prefill_step(model, mesh, *, batch, max_len, ring=False):
    """``prefill(params, batch)`` -> ``model.prefill``'s (logits, cache)
    under :func:`make_shardings`'s rules; ``batch`` holds "tokens" (B, S)
    and optionally "prefix_embeddings". ``ring=True`` sends prefill
    attention down the ring schedule when S divides the ring (every rank
    then holds the full logits and cache)."""
    del batch  # the batch size shards nothing until data parallelism
    rules = make_shardings(model, mesh, ring=ring)

    def prefill(params, batch_):
        with use_rules(rules):
            return model.prefill(
                params, batch_["tokens"],
                prefix_embeddings=batch_.get("prefix_embeddings"),
                max_len=max_len)

    return prefill


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
    params, opt_state, opt_metrics = optimizer.update(
        unflatten(params, grads), opt_state, params)
    metrics = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in dict(metrics, **opt_metrics).items()}
    return params, opt_state, loss.detach(), metrics


def build_train_step(model, optimizer, *, accum_steps=1):
    """``step(params, opt_state, batch)`` -> (params, opt_state, loss,
    metrics): :func:`train_step` (``model.loss``, ``torch.autograd.grad``,
    ``optimizer.update``, with JAX's micro-batch accumulation when
    ``accum_steps`` > 1), as JAX's jitted step with params and state
    donated (here updated in place). On the card a
    :class:`TrainGraphStep` (one CUDA graph a step after the first call);
    on the CPU the function itself, eagerly. ``batch`` holds "tokens" (B,
    S) and, for a model with a frontend, "prefix_embeddings" (B, P, d).
    Returns (step, {"accum_steps", "cuda_graph"}). It takes no mesh:
    parameter and moment shardings, zero1 and fsdp come with tensor
    parallelism."""
    if not isinstance(accum_steps, int) or accum_steps < 1:
        raise ValueError(f"accum_steps must be an int >= 1, got "
                         f"{accum_steps!r}")

    def step(params, opt_state, batch):
        return train_step(model, optimizer, params, opt_state, batch,
                          accum_steps=accum_steps)

    if model.device.type == "cuda":
        step = TrainGraphStep(step, device=model.device)
    return step, {"accum_steps": accum_steps,
                  "cuda_graph": isinstance(step, TrainGraphStep)}


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


def build_serve_step(model, *, batch, greedy=True, split=None):
    """One-token decode step over a static (contiguous) cache:
    ``step(params, cache, tokens (B, 1))`` -> ``model.greedy_step``'s
    (next (B,), logits (B, Vpad), cache) with ``greedy=True``, else
    ``model.decode_step``'s (logits, cache), leaving sampling to the
    caller. ``split``: ``flash_decode``'s split length in every step (a
    tune winner; None: the kernel's rule); a captured graph keeps it. On
    the card a :class:`GraphStep` that checks the cache's capacity on the
    host; on the CPU the method, eagerly. Returns (step, info). It takes
    no mesh: parameter and cache shardings come with tensor
    parallelism."""
    method = model.greedy_step if greedy else model.decode_step
    step = _serve(model, _with_split(method, split), batch=batch,
                  capacity=model.cache_capacity)
    return step, {"greedy": greedy,
                  "cuda_graph": isinstance(step, GraphStep)}


def build_paged_serve_step(model, *, batch, greedy=True, split=None):
    """One-token decode step over PAGED KV pools (the continuous-batching
    engine's inner loop): ``step(params, cache, tokens (B, 1))`` ->
    ``model.paged_greedy_step``'s (next, logits, cache) with
    ``greedy=True``, else ``model.paged_decode_step``'s (logits, cache).
    The host mutates only the control state (tables, lengths, position
    rows) between steps, in place, through the serving scheduler.
    ``split``: paged decode's split length (as :func:`build_serve_step`'s).
    A :class:`GraphStep` on the card; the method, eagerly, on the CPU.
    Returns (step, info). It takes no mesh, as :func:`build_serve_step`."""
    if not model.pageable:
        raise ValueError("build_paged_serve_step: model is not pageable "
                         "(see LM.pageable)")
    method = model.paged_greedy_step if greedy else model.paged_decode_step
    step = _serve(model, _with_split(method, split), batch=batch)
    return step, {"greedy": greedy,
                  "cuda_graph": isinstance(step, GraphStep)}
