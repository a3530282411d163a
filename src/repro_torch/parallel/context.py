"""Ambient parallelism rules (counterpart of ``repro.parallel.context``).

The port has sequence parallelism only: ``Rules(mesh=..., ring_axis=...)``
under :func:`use_rules` sends full-sequence attention down the ring
schedule over ``ring_axis`` of ``mesh`` (a ``torch.distributed``
``DeviceMesh``). The JAX package's ``shard_activation`` and its
activation-spec table come with tensor parallelism.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

__all__ = ["Rules", "use_rules", "current_rules"]


class Rules:
    def __init__(self, *, mesh=None, ring_axis=None):
        self.mesh = mesh
        # sequence-parallel attention: when set, q/k/v shard their SEQUENCE
        # dim over this mesh axis and attention runs the ring schedule
        # (kernels.flash_attention.ring)
        self.ring_axis = ring_axis


_rules: contextvars.ContextVar[Optional[Rules]] = contextvars.ContextVar(
    "repro_torch_parallel_rules", default=None)


def current_rules() -> Optional[Rules]:
    return _rules.get()


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    tok = _rules.set(rules)
    try:
        yield
    finally:
        _rules.reset(tok)
