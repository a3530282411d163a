"""Step builders (counterpart of ``repro.parallel.steps``): a prefill step
under sequence-parallel rules, and the serve steps of the static and the
paged decode loops. There are no parameter shardings: weights stay
replicated on every rank until tensor parallelism is ported, and the serve
steps take no mesh.

Where JAX jits a serve step with the cache donated, the port runs it as
one CUDA graph on the card (:class:`GraphStep`): the first call runs
eagerly, the second captures one step and replays it, and every later
call replays it; a step serves one (params, cache) pair. On the CPU a
serve step is the model's method, run eagerly. The prefill (its prompt
length varies; JAX jits it per length), the engine's admission scatter,
sampling and training stay eager.
"""

from __future__ import annotations

import time

import torch

from repro_torch.kernels import add_launches, launch_state, launches_since

from .context import Rules, use_rules

__all__ = ["make_shardings", "build_prefill_step", "build_serve_step",
           "build_paged_serve_step", "GraphStep", "capture", "cache_overflow"]


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


class GraphStep:
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
    - The kernels' launch counts rise in Python, so the capture's count is
      taken back and added again at each replay: the counts are eager
      code's. ``counts`` is what one replay adds.

    A failed capture or replay raises; nothing falls back to eager code.
    ``captures`` counts the captures (0 or 1), ``capture_s`` is the
    capture's host time."""

    def __init__(self, fn, *, batch, device, capacity=None):
        self._fn = fn
        self._batch = batch
        self._device = device
        self._capacity = capacity
        self._pair = None          # the (params, cache) of the first call
        self._replay = self._out = self._tok = self.counts = None
        self._cap = self._at = None
        self.captures = 0
        self.capture_s = 0.0

    def __call__(self, params, cache, tokens):
        if tuple(tokens.shape) != (self._batch, 1):
            raise ValueError(f"serve step: tokens must be ({self._batch}, 1),"
                             f" got {tuple(tokens.shape)}")
        with torch.no_grad():
            pair = self._pair
            if pair is None:
                self._pair = (params, cache)
                return self._fn(params, tokens.to(self._device), cache)
            if pair[0] is not params or pair[1] is not cache:
                raise ValueError(
                    "serve step: built for the params and cache of its first "
                    "call (its graph holds their addresses); build a new step "
                    "for another pair")
            if self._replay is None:
                self._capture(params, cache)
            if self._cap is not None:
                if self._at >= self._cap:
                    raise cache_overflow(self._at, self._cap)
                self._at += 1
            self._tok.copy_(tokens)
            self._replay()
            add_launches(self.counts)
            return self._out

    def _capture(self, params, cache):
        t0 = time.perf_counter()
        self._cap = None if self._capacity is None else self._capacity(cache)
        if self._cap is not None:
            self._at = int(cache["pos"])     # the one read of the position
        self._tok = torch.zeros((self._batch, 1), dtype=torch.long,
                                device=self._device)
        before = launch_state()
        self._replay, self._out = capture(
            lambda: self._fn(params, self._tok, cache))
        self.counts = launches_since(before)
        add_launches(self.counts, -1)        # the capture launched nothing
        self.captures += 1
        self.capture_s = time.perf_counter() - t0


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


def build_serve_step(model, *, batch, greedy=True):
    """One-token decode step over a static (contiguous) cache:
    ``step(params, cache, tokens (B, 1))`` -> ``model.greedy_step``'s
    (next (B,), logits (B, Vpad), cache) with ``greedy=True``, else
    ``model.decode_step``'s (logits, cache), leaving sampling to the
    caller. On the card a :class:`GraphStep` that checks the cache's
    capacity on the host; on the CPU the method, eagerly. Returns (step,
    info). It takes no mesh: parameter and cache shardings come with
    tensor parallelism."""
    method = model.greedy_step if greedy else model.decode_step
    step = _serve(model, method, batch=batch, capacity=model.cache_capacity)
    return step, {"greedy": greedy,
                  "cuda_graph": isinstance(step, GraphStep)}


def build_paged_serve_step(model, *, batch, greedy=True):
    """One-token decode step over PAGED KV pools (the continuous-batching
    engine's inner loop): ``step(params, cache, tokens (B, 1))`` ->
    ``model.paged_greedy_step``'s (next, logits, cache) with
    ``greedy=True``, else ``model.paged_decode_step``'s (logits, cache).
    The host mutates only the control state (tables, lengths, position
    rows) between steps, in place, through the serving scheduler. A
    :class:`GraphStep` on the card; the method, eagerly, on the CPU.
    Returns (step, info). It takes no mesh, as :func:`build_serve_step`."""
    if not model.pageable:
        raise ValueError("build_paged_serve_step: model is not pageable "
                         "(see LM.pageable)")
    method = model.paged_greedy_step if greedy else model.paged_decode_step
    step = _serve(model, method, batch=batch)
    return step, {"greedy": greedy,
                  "cuda_graph": isinstance(step, GraphStep)}
