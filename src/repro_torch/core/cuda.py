"""The ``cuda`` backend of the kernel language: a table from a spec's name
to the launch of its hand-written Hopper kernel.

Where the JAX package lowers a spec through Pallas, the port has a kernel
written by hand for each spec, and the spec's body does not run on the
card: ``lang.expand(spec, D, "cuda")`` looks the spec's name up here, asks
the binding whether it refuses the defines (at build time, as a Pallas
build would fail), and returns a function that launches the kernel
through its wrapper, which counts the launch in ``wrapper.launches``.
Each wrapper's module registers its own binding with :func:`bind_cuda`;
:func:`cuda_binding` imports ``repro_torch.kernels`` first, so every
binding is in the table when a spec is expanded.

A spec with no binding, or defines its binding refuses, raises
``ValueError`` at build time. Nothing runs the torch expansion in the
kernel's place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["Binding", "bind_cuda", "bound_specs", "cuda_binding"]


@dataclasses.dataclass(frozen=True)
class Binding:
    """How a spec runs on its hand-written kernel.

    ``launch(D, ins, outs)`` launches the kernel once on the input tensors
    and returns its output tensors (the defines namespace ``D`` gives its
    launch arguments): the wrapper's own, when ``outs`` is None, else
    ``outs`` written in place. ``launch_defines`` are the
    defines passed to the launch; ``fixed_defines`` those the kernel fixes
    itself (template constants, a layout rule) and ignores; every other
    define follows from the tensors' shapes. ``refusal(spec, D)`` says why
    the kernel cannot run this spec (a dtype, a tile, shared memory), or
    returns None. ``copies``: the wrapper computes into tensors of its own,
    so a call into outputs the caller owns (``Kernel(...)(*ins, *outs)``)
    copies them (one extra pass over the outputs); ``Kernel.run`` hands
    back the wrapper's tensors and copies nothing. A binding without
    ``copies`` is given the caller's outputs to write in place."""

    name: str
    wrapper: Callable
    launch: Callable
    refusal: Callable
    launch_defines: tuple[str, ...]
    fixed_defines: tuple[str, ...] = ()
    copies: bool = False


_TABLE: dict[str, Binding] = {}


def bind_cuda(name, *, wrapper, launch, refusal, launch_defines,
              fixed_defines=(), copies=False) -> Binding:
    """Register the kernel that runs specs named ``name`` on the card."""
    if name in _TABLE:
        raise ValueError(f"spec {name!r} already has a cuda binding")
    b = Binding(name, wrapper, launch, refusal, tuple(launch_defines),
                tuple(fixed_defines), bool(copies))
    _TABLE[name] = b
    return b


def _load():
    from .. import kernels  # noqa: F401  (each wrapper module binds itself)


def cuda_binding(name) -> Binding | None:
    """The binding of specs named ``name``, or None."""
    _load()
    return _TABLE.get(name)


def bound_specs() -> dict[str, Binding]:
    """Every binding, by spec name."""
    _load()
    return dict(_TABLE)
