"""Continuous-batching scheduler: admission, growth, retirement, preemption.

Pure host-side bookkeeping over ``batch`` decode SLOTS and a
:class:`~repro_torch.serving.pages.PageAllocator` — no device state. The engine
owns the device mirror (block tables, lengths, KV pools) and calls back in
this order each step: ``retire`` finished slots, ``admit`` queued requests
into free slots (FIFO), ``grow`` every running slot whose next token starts
a new page — preempting the YOUNGEST running sequences when the pool runs
dry (they requeue at the FRONT with their generated prefix and re-prefill
on re-admission, so no work is lost and older sequences never starve).
"""

from __future__ import annotations

import dataclasses
from collections import deque

from .pages import PageAllocator

__all__ = ["Request", "Scheduler"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]               # original prompt tokens
    max_new: int
    tokens: list[int] = dataclasses.field(default_factory=list)  # generated
    state: str = "queued"           # queued | running | done
    preempted: int = 0              # times evicted mid-flight

    @property
    def resume_prompt(self) -> list[int]:
        """What a (re-)admission must prefill: prompt + generated so far."""
        return list(self.prompt) + list(self.tokens)


class Scheduler:
    def __init__(self, *, batch: int, page_size: int, num_pages: int,
                 max_len: int):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.batch = batch
        self.max_len = max_len
        self.pages = PageAllocator(num_pages, page_size)
        self.nseq_pages = self.pages.pages_for(max_len)
        self.slots: list[Request | None] = [None] * batch
        self.queue: deque[Request] = deque()
        self._next_rid = 0
        self._admit_order = 0
        self._slot_age: list[int] = [0] * batch   # admission order per slot

    # ------------------------------------------------------------- requests
    def submit(self, prompt, max_new: int) -> int:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new > self.max_len:
            raise ValueError(
                f"kv cache overflow: request needs "
                f"{len(prompt) + max_new} positions but "
                f"max_len={self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid=rid, prompt=prompt, max_new=max_new))
        return rid

    @property
    def running(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slots)

    # ------------------------------------------------------------ lifecycle
    def retire(self, slot: int) -> Request:
        """Slot finished (EOS / max_new): free its pages, open the slot."""
        req = self.slots[slot]
        assert req is not None, f"retire of empty slot {slot}"
        self.pages.release(req.rid)
        req.state = "done"
        self.slots[slot] = None
        return req

    def admit(self) -> list[tuple[int, Request]]:
        """FIFO-admit queued requests into free slots while pages last.
        Stops at the FIRST page shortfall (no queue jumping: a small later
        request must not starve a large earlier one). Returns the newly
        filled ``(slot, request)`` pairs; the engine prefills each."""
        placed = []
        for slot in range(self.batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            need = self.pages.pages_for(len(req.resume_prompt) + 1)
            if self.pages.alloc(req.rid, need) is None:
                break
            self.queue.popleft()
            req.state = "running"
            self.slots[slot] = req
            self._admit_order += 1
            self._slot_age[slot] = self._admit_order
            placed.append((slot, req))
        return placed

    def grow(self, slot: int) -> bool:
        """Ensure slot's next decode position has a page. Returns False on
        pool famine (caller should preempt and retry)."""
        req = self.slots[slot]
        assert req is not None
        # the last generated token is always PENDING (its KV not yet
        # written): the next decode writes at position len(resume) - 1
        pos = len(req.resume_prompt) - 1
        have = len(self.pages.owned(req.rid))
        need = self.pages.pages_for(pos + 1)
        if need <= have:
            return True
        return self.pages.alloc(req.rid, need - have) is not None

    def preempt_youngest(self, *, exclude: int | None = None) -> int | None:
        """Evict the most recently admitted running sequence: release its
        pages and requeue it at the FRONT (it keeps queue priority and its
        generated tokens; re-admission re-prefills them). Returns the freed
        slot, or None if nothing can be evicted."""
        candidates = [i for i in self.running if i != exclude]
        if not candidates:
            return None
        slot = max(candidates, key=lambda i: self._slot_age[i])
        req = self.slots[slot]
        self.pages.release(req.rid)
        req.state = "queued"
        req.preempted += 1
        self.slots[slot] = None
        self.queue.appendleft(req)
        return slot
