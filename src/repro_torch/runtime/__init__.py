"""Failure injection and straggler detection, copied from
``repro.runtime`` (pure Python), and elastic rescaling over
``torch.distributed`` meshes."""

from .elastic import choose_mesh_shape, reshard
from .failures import ChaosError, FailureInjector
from .watchdog import StepWatchdog

__all__ = ["ChaosError", "FailureInjector", "StepWatchdog",
           "choose_mesh_shape", "reshard"]
