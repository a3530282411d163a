"""Failure injection and straggler detection, copied from
``repro.runtime`` (pure Python). ``repro.runtime.elastic`` is multi-GPU
and not ported yet."""

from .failures import ChaosError, FailureInjector
from .watchdog import StepWatchdog

__all__ = ["ChaosError", "FailureInjector", "StepWatchdog"]
