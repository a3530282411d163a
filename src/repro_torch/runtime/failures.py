"""Failure injection for recovery testing (simulated node loss)."""

from __future__ import annotations

__all__ = ["ChaosError", "FailureInjector"]


class ChaosError(RuntimeError):
    """Injected failure (stands in for a lost host / preempted slice)."""


class FailureInjector:
    def __init__(self, fail_at_steps=(), fail_once: bool = True):
        self.fail_at = set(fail_at_steps)
        self.fail_once = fail_once
        self.fired: set[int] = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at:
            if self.fail_once and step in self.fired:
                return
            self.fired.add(step)
            raise ChaosError(f"injected failure at step {step}")
