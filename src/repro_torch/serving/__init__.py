"""Continuous-batching serving: page allocator, scheduler and the
:class:`Engine` over paged KV pools (greedy or sampled)."""

from .engine import Engine, sample
from .pages import PageAllocator
from .scheduler import Request, Scheduler

__all__ = ["Engine", "PageAllocator", "Request", "Scheduler", "sample"]
