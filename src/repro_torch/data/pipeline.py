"""Deterministic, host-sharded token data with background prefetch:
``SyntheticLMData``, the byte-level ``TextLMData`` over a generated
corpus (``make_corpus``) and ``Prefetcher``, copied from
``repro.data.pipeline`` (numpy and threads only).

Batches are a pure function of (seed, step, host) through counter-based
Philox bits, so the port's batches are bit-equal to the JAX package's and
there is no pipeline state to checkpoint beyond the step counter.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["SyntheticLMData", "TextLMData", "Prefetcher", "make_corpus"]


class SyntheticLMData:
    """Markov-chain token stream: learnable structure, fully deterministic."""

    def __init__(self, *, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, num_hosts: int = 1, host_id: int = 0,
                 order_strength: float = 0.9):
        assert global_batch % num_hosts == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // num_hosts
        self.seed = seed
        self.host_id = host_id
        # fixed sparse transition structure (same on every host)
        rs = np.random.RandomState(seed)
        self.next_tok = rs.randint(0, vocab_size, size=(vocab_size, 4))
        self.p_follow = order_strength

    def batch(self, step: int) -> np.ndarray:
        bits = np.random.Generator(np.random.Philox(
            key=[self.seed * 2654435761 + self.host_id, step]))
        b, s = self.local_batch, self.seq
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = bits.integers(0, self.vocab, b)
        follow = bits.random((b, s)) < self.p_follow
        choice = bits.integers(0, 4, (b, s))
        rand = bits.integers(0, self.vocab, (b, s))
        for t in range(1, s):
            nxt = self.next_tok[toks[:, t - 1], choice[:, t]]
            toks[:, t] = np.where(follow[:, t], nxt, rand[:, t])
        return toks


def make_corpus(n_chars: int = 200_000, seed: int = 0) -> bytes:
    """Generates a word-like synthetic corpus (for the byte-level pipeline)."""
    rs = np.random.RandomState(seed)
    words = ["occa", "kernel", "device", "memory", "mesh", "pallas", "tile",
             "lattice", "shard", "stream", "barrier", "vector", "tensor",
             "spectral", "galerkin", "stencil", "roofline", "pipeline"]
    out = []
    size = 0
    while size < n_chars:
        w = words[rs.randint(len(words))]
        out.append(w)
        size += len(w) + 1
    return (" ".join(out)).encode()[:n_chars]


class TextLMData:
    """Byte-level windows over a corpus, deterministic per (seed, step, host)."""

    def __init__(self, corpus: bytes, *, seq_len: int, global_batch: int,
                 seed: int = 0, num_hosts: int = 1, host_id: int = 0):
        assert global_batch % num_hosts == 0
        self.data = np.frombuffer(corpus, np.uint8)
        self.seq = seq_len
        self.local_batch = global_batch // num_hosts
        self.seed = seed
        self.host_id = host_id
        self.vocab = 256

    def batch(self, step: int) -> np.ndarray:
        bits = np.random.Generator(np.random.Philox(
            key=[self.seed * 2654435761 + self.host_id, 2 ** 32 + step]))
        starts = bits.integers(0, len(self.data) - self.seq - 1,
                               self.local_batch)
        return np.stack([self.data[s:s + self.seq]
                         for s in starts]).astype(np.int32)


class Prefetcher:
    """Background-thread prefetch of ``source.batch(step)``."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                item = (step, self.source.batch(step))
            except Exception as e:  # propagate to the consumer, don't hang
                item = e
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return
            step += 1

    def next(self):
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
