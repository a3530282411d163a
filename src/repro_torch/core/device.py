"""occa::device analogue: a backend with its tensors' device and its own
kernel build cache (the counterpart of ``repro.core.device``).

``Device("cuda")`` runs each spec on its hand-written Hopper kernel;
``Device("torch")`` and ``Device("loops")`` run the spec's body through
the language's expansions. Tensors live on ``resolve_device(device)``: the
CUDA card unless the caller asks for the CPU, and an error without CUDA
(the cuda backend runs on the card only). ``build_kernel`` is the paper's
run-time compilation: the builder is called with the defines (addDefine),
the Spec's grid pass runs, the analyzer's body pass and footprint gate it
(``analyze=``, default the process mode), the spec is expanded for the
backend, and the kernel is cached by (builder *identity*, defines, backend): two closures
from one factory share a ``__qualname__`` but are different kernels, so
the cache is keyed on the function object itself (weakly, where possible).
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Callable

import numpy as np
import torch

from ..device import fit_block, resolve_device
from . import analyze as _analyze
from . import lang
from .kernel import Kernel
from .memory import Memory

__all__ = ["Device", "BuildStats", "default_device", "fit_block",
           "resolve_model"]


_SCALARS = (int, float, str, bool, type(None))


@dataclasses.dataclass
class BuildStats:
    builds: int = 0
    cache_hits: int = 0


def _freeze(v):
    if type(v) is dict and all(type(x) in _SCALARS for x in v.values()):
        return tuple(sorted(v.items()))     # the common case: flat defines
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    return v


def resolve_model(model, device=None) -> tuple[str, torch.device]:
    """(backend, torch device) of an app driver's ``model=`` and
    ``device=``: ``model=None`` is ``"cuda"`` on the card and ``"torch"``
    on the CPU; ``"cuda"`` on the CPU raises."""
    dev = resolve_device(device)
    if model is None:
        model = "cuda" if dev.type == "cuda" else "torch"
    if model not in lang.BACKENDS:
        raise ValueError(f"unknown model {model!r}; expected one of "
                         f"{lang.BACKENDS}")
    if model == "cuda" and dev.type != "cuda":
        raise ValueError("model 'cuda' runs the hand-written kernels on the "
                         f"card, not on {dev}")
    return model, dev


class Device:
    """A compute backend with its tensors' device and a kernel cache."""

    BACKENDS = lang.BACKENDS

    def __init__(self, backend: str = "torch", *, device=None):
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of {self.BACKENDS}")
        self.backend, self.device = resolve_model(backend, device)
        # id(builder anchor) -> (ref-or-strong-anchor, {key: Kernel}). Keyed by
        # object IDENTITY (never __eq__/__hash__: two equal-but-distinct
        # instances must not share kernels). Weakly-referenced anchors are
        # evicted by a finalizer so caching never pins short-lived closures;
        # non-weakrefable anchors are held strongly (keeping the id valid)
        # with bounded FIFO eviction.
        self._cache: dict = {}
        self._strong_keys: list = []
        self._lock = threading.Lock()
        self.stats = BuildStats()

    # -- memory ---------------------------------------------------------------
    def malloc(self, array_or_shape, dtype=None) -> Memory:
        """A new Memory: zeros of a shape (``dtype`` default float32), or a
        copy of an array or tensor (in ``dtype`` if given)."""
        if isinstance(array_or_shape, (tuple, list, int)):
            shape = (array_or_shape,) if isinstance(array_or_shape, int) \
                else tuple(array_or_shape)
            t = torch.zeros(shape, dtype=lang.as_dtype(dtype or "float32"),
                            device=self.device)
        else:
            src = array_or_shape if torch.is_tensor(array_or_shape) else \
                torch.from_numpy(np.ascontiguousarray(array_or_shape))
            t = src.to(device=self.device, copy=True,
                       dtype=None if dtype is None else lang.as_dtype(dtype))
        return Memory(self, t)

    _STRONG_CACHE_MAX = 64

    @staticmethod
    def _evict_entry(cache, key, ref):
        ent = cache.get(key)
        if ent is not None and ent[0] is ref:  # don't drop a reused-id entry
            cache.pop(key, None)

    def _builder_cache(self, builder) -> dict:
        """Per-builder kernel sub-cache, keyed on object identity.

        Bound methods are a fresh object per attribute access, so they are
        unwrapped and anchored on the *instance* (with the underlying function
        in the subkey): ``dev.build_kernel(obj.builder, ...)`` in a loop hits
        the cache. Plain closures recreated per call inherently cannot: hold
        onto the builder object to reuse its cache."""
        anchor, fn = builder, None
        if getattr(builder, "__func__", None) is not None \
                and getattr(builder, "__self__", None) is not None:
            anchor, fn = builder.__self__, builder.__func__
        key = id(anchor)
        ent = self._cache.get(key)
        if ent is not None:
            ref, sub = ent
            live = ref() if isinstance(ref, weakref.ref) else ref
            if live is not anchor:  # stale id reuse: rebuild the entry
                ent = None
        if ent is None:
            sub = {}
            try:
                ref = weakref.ref(anchor)
                self._cache[key] = (ref, sub)
                weakref.finalize(anchor, self._evict_entry, self._cache, key, ref)
            except TypeError:  # anchor not weakref-able: hold it strongly
                self._cache[key] = (anchor, sub)
                self._strong_keys.append(key)
                while len(self._strong_keys) > self._STRONG_CACHE_MAX:
                    # bounded: evict oldest so strong refs can't pile up forever
                    self._cache.pop(self._strong_keys.pop(0), None)
        if fn is None:
            return sub
        per_fn = sub.get(fn)
        if per_fn is None:
            per_fn = sub[fn] = {}
        return per_fn

    # -- run-time kernel compilation -------------------------------------------
    def build_kernel(self, builder: Callable, defines: dict | None = None,
                     *, analyze: str | None = None) -> Kernel:
        """Build ``builder`` with ``defines`` for this device's backend.
        The Spec's grid pass runs when the builder makes it; every
        cache-miss build then runs the analyzer (``check_built_spec``:
        semantics, shared-memory footprint, body pass), raising or warning
        by ``analyze`` (default :func:`analyze.analysis_mode`). On the
        cuda backend a footprint finding is kept in ``kernel.report`` and
        never raised (the spec's footprint rule is not the hand-written
        kernel's; its binding checks the kernel's own limits), and the
        binding refuses what its wrapper would. Each raises
        ``ValueError`` (``AnalysisError`` for the analyzer's findings)."""
        defines = dict(defines or {})
        key = (_freeze(defines), self.backend, self.device)
        with self._lock:
            hit = self._builder_cache(builder).get(key)
            if hit is not None:
                self.stats.cache_hits += 1
                return hit

        D = lang.defines_namespace(defines)
        spec = builder(D)
        if not isinstance(spec, lang.Spec):
            raise TypeError(f"builder {builder!r} must return lang.Spec, got {type(spec)}")
        findings = _analyze.check_semantics(spec)
        if findings:
            raise _analyze.AnalysisError(findings)
        report = _analyze.check_built_spec(
            spec, D, mode=analyze, gate_footprint=self.backend != "cuda")
        kern = Kernel(self, spec, lang.expand(spec, D, self.backend), defines,
                      report=report)

        with self._lock:
            self._builder_cache(builder)[key] = kern
            self.stats.builds += 1
        return kern

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __repr__(self):
        return f"Device(backend={self.backend!r}, device={self.device})"


_DEFAULT_DEVICES: dict = {}
_DEFAULT_DEVICES_LOCK = threading.Lock()


def default_device(backend: str, device=None) -> Device:
    """Process-wide Device per (backend, device), so code that builds
    kernels on the fly shares one kernel cache."""
    with _DEFAULT_DEVICES_LOCK:
        key = (backend, resolve_model(backend, device)[1])
        dev = _DEFAULT_DEVICES.get(key)
        if dev is None:
            dev = _DEFAULT_DEVICES[key] = Device(backend, device=key[1])
        return dev
