"""Fixed-size KV page allocator (the vLLM PagedAttention idiom).

The device holds one pool of ``num_pages`` pages per layer; this allocator
is the host-side owner of that pool. Page 0 is RESERVED as the null page —
idle batch slots' block tables point at it and their per-step writes land
there — so allocatable pages are ``1 .. num_pages - 1``. Allocation is
all-or-nothing per request: a sequence either gets every page it asked for
or none (partial grants would deadlock admission under fragmentation-free
fixed pages).
"""

from __future__ import annotations

__all__ = ["PageAllocator"]


class PageAllocator:
    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("PageAllocator needs >= 2 pages (page 0 is the "
                             f"reserved null page), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: list[int] = list(range(1, num_pages))
        self._owned: dict[object, list[int]] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` KV entries."""
        return -(-max(n_tokens, 1) // self.page_size)

    def alloc(self, seq_id, n: int) -> list[int] | None:
        """Grant ``n`` pages to ``seq_id`` (appended to its existing run in
        logical order), or None — with no state change — on shortfall."""
        if n < 0:
            raise ValueError(f"alloc: n must be >= 0, got {n}")
        if n > len(self._free):
            return None
        grant = self._free[:n]
        del self._free[:n]
        self._owned.setdefault(seq_id, []).extend(grant)
        return list(grant)

    def owned(self, seq_id) -> list[int]:
        return list(self._owned.get(seq_id, ()))

    def release(self, seq_id) -> list[int]:
        """Return every page of ``seq_id`` to the free list."""
        pages = self._owned.pop(seq_id, [])
        self._free.extend(pages)
        return list(pages)

    def check_invariants(self):
        """free ∪ owned must partition {1 .. num_pages-1}: no page leaked,
        none double-owned, none handed out twice. Raises AssertionError."""
        owned_all: list[int] = []
        for pages in self._owned.values():
            owned_all.extend(pages)
        assert len(set(owned_all)) == len(owned_all), \
            f"page double-owned: {sorted(owned_all)}"
        assert len(set(self._free)) == len(self._free), \
            f"free-list duplicate: {sorted(self._free)}"
        universe = set(range(1, self.num_pages))
        seen = set(self._free) | set(owned_all)
        assert not (set(self._free) & set(owned_all)), \
            "page both free and owned"
        assert seen == universe, \
            f"pages leaked: {sorted(universe - seen)}"
