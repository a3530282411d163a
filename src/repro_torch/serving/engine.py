"""Continuous-batching decode engine over paged KV caches (the counterpart
of ``repro.serving.engine``).

One paged decode step (``LM.paged_greedy_step``, or
``LM.paged_decode_step`` when sampling, through
``parallel.build_paged_serve_step``, as the JAX engine jits it) runs over
``batch`` SLOTS every step, whatever mix of sequences occupies them; the
:class:`Scheduler` retires finished sequences, refills slots from the FIFO
queue mid-flight, and preempts by eviction when the page pool runs dry. On
the card the step is one CUDA graph, captured at the engine's second step
and replayed after it: the pools, tables, lengths and position rows never
move, and the host changes them only in place between steps. Admission
prefills the new sequence alone (B=1 ``LM.prefill``, eager: its length
varies) and copies its contiguous KV into the sequence's pages with
``index_copy_``, IN PLACE in the pools (JAX donates the pools to a jitted
scatter instead).

Token semantics match ``repro.serving.Engine``: the first emitted token
comes from the prefill logits, every decode step emits the next, the EOS
token itself is emitted before the sequence retires, and a sequence emits
at most ``max_new`` tokens. ``greedy=False`` samples every token (the
admission's too) from ``softmax(logits / temperature)`` with ``rng``, a
``torch.Generator`` on the model's device, eagerly, from the sampling
step's logits before the next step overwrites them.

Autotune adoption (``launch.tuning.adopt``, kind "serve") runs in the
constructor: the persisted ``flash_decode_paged`` winner for the engine's
own pool shapes, if any, is the split length its step builder passes to
every paged decode launch (a CUDA graph keeps the split it was captured
with). The page size stays the pool's layout (``page_size``, default
``fit_block(512, max_len)``). That differs from the JAX engine, whose page
size is ``flash_decode``'s tuned ``block_kv``. ``engine.tuned`` holds what
was adopted (and what was refused or skipped); ``use_tuned=False`` looks
nothing up and runs the kernel's rule.

``Engine(mesh=)`` serves on a ("data", "model") mesh of several ranks, each
running the same engine: the parameters are this rank's shards
(``parallel.shard_tree`` by ``make_shardings``' placements, which the
engine applies to the full tree it is given, or the shards themselves with
``sharded=True``), the pools hold this rank's kv heads, or all of them
where they do not divide the "model" axis (``paged_cache_pspecs``), and
the tables, lengths and position rows are replicated. Every rank submits the same requests in the same order, so
the host schedulers make the same decisions; the admission prefill, the
decode step (``build_paged_serve_step(mesh)``, eager) and the greedy
argmax run under the mesh's rules, and the tokens every rank emits are the
global argmax's (sampled tokens are drawn on the first rank and
broadcast). ``cache_dtype`` sets the pools' dtype (default the model's).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import fit_block
from repro_torch.launch import tuning
from repro_torch.parallel import comm
from repro_torch.parallel.context import use_rules
from repro_torch.parallel.steps import (build_paged_serve_step,
                                        make_shardings, paged_layer_specs,
                                        shard_tree)

from .scheduler import Scheduler

__all__ = ["Engine", "sample"]


def sample(logits, vocab: int, temperature: float, rng: torch.Generator):
    """One token per row drawn from ``softmax(logits[..., :vocab] / T)``
    (what ``jax.random.categorical`` draws from), with the generator
    ``rng`` on the logits' device. Returns a (rows,) int64 tensor."""
    probs = torch.softmax(logits[..., :vocab].float() / temperature, dim=-1)
    return torch.multinomial(probs.reshape(-1, vocab), 1,
                             generator=rng).reshape(probs.shape[:-1])


class Engine:
    def __init__(self, model, params, *, batch: int, max_len: int,
                 num_pages: int | None = None, page_size: int | None = None,
                 eos_id: int | None = None, greedy: bool = True,
                 temperature: float = 1.0, rng=None, use_tuned: bool = True,
                 mesh=None, cache_dtype=None, sharded=False):
        if not model.pageable:
            raise ValueError("Engine needs a pageable model (see LM.pageable)")
        if temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        self.model = model
        self.greedy = greedy
        self.temperature = float(temperature)
        self._rng = (rng if rng is not None else
                     torch.Generator(device=model.device).manual_seed(0))
        self.mesh = mesh
        self._rules = None
        if mesh is not None:
            placements, _, rules, _ = make_shardings(model, mesh)
            # the pools' layout, and that of the prefill caches scattered
            # into them: kv heads over "model", or all of them replicated
            self._rules = rules.with_cache(paged_layer_specs(model, mesh))
            if not sharded:
                params = shard_tree(params, placements)
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = model.device
        if page_size is None:
            page_size = fit_block(512, max_len)
        self.page_size = int(page_size)
        nsp = -(-max_len // self.page_size)
        if num_pages is None:
            # every slot can grow to max_len: preemption never fires unless
            # the caller shrinks the pool deliberately
            num_pages = batch * nsp + 1
        if num_pages - 1 < nsp:
            raise ValueError(
                f"num_pages={num_pages} cannot hold one max_len={max_len} "
                f"sequence ({nsp} pages of {self.page_size})")
        self.sched = Scheduler(batch=batch, page_size=self.page_size,
                               num_pages=num_pages, max_len=max_len)
        with use_rules(self._rules):
            self.cache = model.init_paged_cache(batch, num_pages,
                                                self.page_size, nsp,
                                                dtype=cache_dtype)
        # the persisted paged split, passed to the step (its graph keeps it)
        self.tuned = tuning.adopt(
            model.cfg, dict(batch=batch, prompt_len=max_len, max_len=max_len,
                            page_size=self.page_size),
            kind="serve", device=model.device,
            ops=("flash_decode_paged",) if use_tuned else ())
        self._step, _ = build_paged_serve_step(
            model, mesh, batch=batch, greedy=greedy,
            split=self.tuned.knob("flash_decode_paged", "split"))
        self._requests = {}
        self._pending = np.zeros((batch,), np.int64)
        self._slot_pages = [[] for _ in range(batch)]

    # -------------------------------------------------------------- requests
    def submit(self, prompt, max_new: int) -> int:
        """Queue a prompt for generation. Returns the request id."""
        rid = self.sched.submit(prompt, max_new)
        self._requests[rid] = self.sched.queue[-1]
        return rid

    def result(self, rid: int) -> list[int]:
        return list(self._requests[rid].tokens)

    @property
    def idle(self) -> bool:
        return self.sched.idle

    # ------------------------------------------------------- device mirrors
    def _table_row(self, pages: list[int]) -> torch.Tensor:
        row = np.zeros((self.sched.nseq_pages,), np.int32)
        row[:len(pages)] = pages               # padded entries hit null page 0
        return torch.from_numpy(row).to(self.device)

    def _clear_slot(self, slot: int):
        self.cache["table"][slot] = 0
        self.cache["len"][slot] = 0
        self._slot_pages[slot] = []
        self._pending[slot] = 0

    def _scatter_prefill(self, pcache, pages: list[int], slot: int):
        """Copy a B=1 contiguous prefill cache into the sequence's pages
        (logical page j -> pool page pages[j]) and stamp their position rows
        and the slot's table/len, in place."""
        c, pg = self.cache, self.page_size
        npg = len(pages)
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        plen = 0
        for sc, pc in zip(c["stacks"], pcache["stacks"]):
            for pool, kv in (("kp", "k"), ("vp", "v")):
                src = pc[kv]                       # (n, 1, hk, plen, hd)
                n, _, hk, plen, hd = src.shape
                full = torch.zeros((n, hk, npg * pg, hd),
                                   dtype=sc[pool].dtype, device=self.device)
                full[:, :, :plen] = src[:, 0]
                sc[pool].index_copy_(1, idx, full.reshape(
                    n, hk, npg, pg, hd).transpose(1, 2))
        pos = torch.arange(npg * pg, dtype=torch.int32,
                           device=self.device).reshape(npg, pg)
        c["pos_pages"].index_copy_(0, idx, torch.where(pos < plen, pos, -1))
        c["table"][slot] = self._table_row(pages)
        c["len"][slot] = plen
        self._slot_pages[slot] = list(pages)

    def _sync_grown(self, slot: int):
        """Push newly granted pages into the device table; their position
        rows reset to -1 (the decode step stamps positions as it writes)."""
        req = self.sched.slots[slot]
        pages = self.sched.pages.owned(req.rid)
        if pages == self._slot_pages[slot]:
            return
        known = set(self._slot_pages[slot])
        new = [p for p in pages if p not in known]
        if new:
            self.cache["pos_pages"][torch.tensor(new, device=self.device)] = -1
        self.cache["table"][slot] = self._table_row(pages)
        self._slot_pages[slot] = list(pages)

    # ----------------------------------------------------------------- step
    def _sample(self, logits):
        tok = sample(logits, self.model.cfg.vocab_size, self.temperature,
                     self._rng)
        if self.mesh is not None:             # the first rank's draw
            tok = comm.broadcast(tok, 0)
        return tok.cpu().numpy()

    def _emit(self, slot: int, tok: int, emitted: dict):
        req = self.sched.slots[slot]
        req.tokens.append(tok)
        emitted.setdefault(req.rid, []).append(tok)
        if ((self.eos_id is not None and tok == self.eos_id)
                or len(req.tokens) >= req.max_new):
            self.sched.retire(slot)
            self._clear_slot(slot)

    def _admit(self, slot: int, req, emitted: dict):
        toks = torch.tensor([req.resume_prompt], dtype=torch.long,
                            device=self.device)   # prompt + generated so far
        with use_rules(self._rules):
            logits, pcache = self.model.prefill(self.params, toks)
        self._scatter_prefill(pcache, self.sched.pages.owned(req.rid), slot)
        if self.greedy:
            tok = int(self.model.greedy_token(logits[0]))
        else:
            tok = int(self._sample(logits)[0])
        self._pending[slot] = tok
        self._emit(slot, tok, emitted)

    def step(self) -> dict:
        """One engine step: admit queued requests into free slots, grow
        (preempting on famine), run ONE batched decode step, emit. Returns
        ``{rid: [tokens]}`` emitted this step (admissions emit their prefill
        token here too)."""
        emitted: dict = {}
        for slot, req in self.sched.admit():
            self._admit(slot, req, emitted)
        for slot in list(self.sched.running):
            if self.sched.slots[slot] is None:
                continue                        # evicted by a younger grow
            while not self.sched.grow(slot):
                freed = self.sched.preempt_youngest(exclude=slot)
                if freed is None:
                    raise RuntimeError(
                        "page pool cannot hold a single sequence")
                self._clear_slot(freed)
            self._sync_grown(slot)
        running = self.sched.running
        if not running:
            if self.sched.queue:
                raise RuntimeError(
                    "no slot admitted but requests remain queued: page pool "
                    "too small for the front request")
            return emitted
        toks = torch.from_numpy(self._pending.reshape(-1, 1)).to(self.device)
        if self.greedy:
            nxt = self._step(self.params, self.cache, toks)[0].cpu().numpy()
        else:
            nxt = self._sample(self._step(self.params, self.cache, toks)[0])
        for slot in running:
            tok = int(nxt[slot])
            self._pending[slot] = tok
            self._emit(slot, tok, emitted)
        return emitted

    def drain(self, max_steps: int | None = None) -> dict:
        """Step until every submitted request completed. Returns
        ``{rid: generated tokens}`` for all requests ever submitted."""
        steps = 0
        while not self.sched.idle:
            self.step()
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(f"drain: exceeded {max_steps} steps")
        return {rid: list(r.tokens) for rid, r in self._requests.items()}
