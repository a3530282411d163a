"""Straggler detection: rolling step-time statistics with a sigma threshold.

At multi-pod scale a straggling host shows up as a slow all-reduce on every
peer; the watchdog flags steps slower than mean + k*sigma (and absolute
deadlines) so the launcher can checkpoint + evict/restart. On this container
it is exercised by tests with synthetic timings.
"""

from __future__ import annotations

import collections
import math
import time

__all__ = ["StepWatchdog"]


class StepWatchdog:
    def __init__(self, *, window: int = 50, sigma: float = 4.0,
                 absolute_deadline_s: float | None = None,
                 min_samples: int = 10, on_straggler=None):
        self.window = window
        self.sigma = sigma
        self.deadline = absolute_deadline_s
        self.min_samples = min_samples
        self.times = collections.deque(maxlen=window)
        self.flagged: list[tuple[int, float]] = []
        self.on_straggler = on_straggler
        self._t0 = None
        self._step = 0

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> float:
        dt = time.monotonic() - self._t0
        self.observe(self._step, dt)
        self._step += 1
        return dt

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        flagged = False
        if self.deadline is not None and dt > self.deadline:
            flagged = True
        if len(self.times) >= self.min_samples:
            mean = sum(self.times) / len(self.times)
            var = sum((t - mean) ** 2 for t in self.times) / len(self.times)
            if dt > mean + self.sigma * math.sqrt(var) and dt > 1.5 * mean:
                flagged = True
        self.times.append(dt)
        if flagged:
            self.flagged.append((step, dt))
            if self.on_straggler:
                self.on_straggler(step, dt)
        return flagged

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0
