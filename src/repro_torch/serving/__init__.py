"""Continuous-batching serving: page allocator, scheduler and the greedy
:class:`Engine` over paged KV pools."""

from .engine import Engine
from .pages import PageAllocator
from .scheduler import Request, Scheduler

__all__ = ["Engine", "PageAllocator", "Request", "Scheduler"]
