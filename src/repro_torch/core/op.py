"""Declarative op front end: ``define_op`` (the counterpart of
``repro.core.op``). Each public kernel op of the port is one declaration
over the wrapper that launches its hand-written kernel: the plain version
beside it, the launch parameters it can be tuned over (its *knobs*), the
shapes that key a tuning problem, and example inputs. The declarations
register in a process-wide registry under the JAX package's op names, so
tooling (``tune_cli``, the tests, the launchers' warmup) can enumerate
every op.

    fd2d_op = define_op("fd2d", kernel=_fd2d_call, ref=fd2d_ref,
                        sweep=dict(bh=[...], bw=[...]), ...)
    u3 = fd2d_op(u1, u2, weights=w, dx=dx, dt=dt)    # the wrapper
    best = fd2d_op.tune((u1, u2), weights=w, dx=dx, dt=dt)

Calling an op is a thin dispatch to its wrapper (and the wrapper's
``autograd.Function``, where it has one). ``backend="auto"`` does what the
wrapper does (the kernel on CUDA tensors, the plain version on CPU ones);
``"cuda"`` is the kernel and raises for CPU tensors; ``"torch"`` is the
plain version. The JAX package's ``$REPRO_BACKEND`` is not ported: on the
card it would let an environment variable route the main path around the
kernels. Nor are its mesh schedule (``OpShard``, ``mesh=``) and static
analysis (``analyze=``) yet.

Tuned knobs reach a launch only as arguments: whoever builds the launch
looks up ``op.cached_winner`` at its shapes (the app drivers; the engine
and the static loop through ``launch.tuning.adopt``, before their step is
captured) and passes the winner on. A wrapper called without the knob
takes its rule; no process-wide state picks a knob.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tune as _tune

__all__ = ["Op", "define_op", "get_op", "registered_ops", "to_tensors"]

_REGISTRY: dict[str, "Op"] = {}


def _load_kernels():
    import repro_torch.kernels  # noqa: F401 -- registers the op families


def registered_ops() -> dict[str, "Op"]:
    """Snapshot of the registry (name -> Op), the kernels' ops loaded."""
    _load_kernels()
    return dict(_REGISTRY)


def get_op(name: str) -> "Op":
    _load_kernels()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no op named {name!r} registered; known: "
                       f"{sorted(_REGISTRY)}") from None


def to_tensors(args, params, device):
    """An example's numpy arrays (in ``args`` and in ``params``) as
    tensors on ``device``; other values pass through."""
    def conv(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)
        return x

    return (tuple(conv(a) for a in args),
            {k: conv(v) for k, v in params.items()})


def _tensors(args, params):
    return [t for t in (*args, *params.values()) if torch.is_tensor(t)]


class Op:
    """A declared op, the callable :func:`define_op` returns.

    ``kernel(*args, **params)`` is the wrapper (it takes the knobs as
    keyword parameters), ``ref(*args, **params)`` the plain version (it
    takes the params that are not knobs); ``raw``/``raw_ref`` return every
    output (default: kernel/ref). ``derive_defines(args, params)`` gives
    the JSON-able defines of a tuning problem from shapes and dtypes alone
    (probes may be meta tensors); it raises ``ValueError`` for shapes
    outside the kernel's domain. On defines with a candidate's knobs,
    ``smem`` gives the shared memory a block needs (for pruning) and
    ``refusal`` the reason the wrapper would refuse them, or None.
    ``tolerance`` holds a candidate against the plain version while
    tuning. ``sources`` name the op's CUDA sources (their build hash keys
    its winners). ``exact_knobs``: the knobs change only which block
    computes each output, not its arithmetic, so every winner gives the
    untuned run's bits."""

    def __init__(self, name, *, kernel, ref, raw=None, raw_ref=None,
                 sweep=None, defaults=None, example=None,
                 derive_defines=None, smem=None, refusal=None,
                 tolerance=None, sources=(), exact_knobs=False, doc=None):
        self.name = name
        self.kernel = kernel
        self.ref = ref
        self.raw_kernel = raw or kernel
        self.raw_ref = raw_ref or ref
        self.sweep = dict(sweep or {})
        self.knob_names = frozenset(self.sweep)
        self.defaults = dict(defaults or {})
        self.example = example
        self.derive_defines = derive_defines
        self.smem = smem
        self.refusal = refusal
        self.tolerance = tolerance or _tune.Tolerance()
        self.sources = tuple(sources)
        self.exact_knobs = exact_knobs
        self.__doc__ = doc or getattr(kernel, "__doc__", None)
        self.__name__ = name

    # -- call plumbing -------------------------------------------------------
    def _params(self, kw) -> dict:
        unknown = set(kw) - set(self.defaults)
        if unknown:
            raise TypeError(f"op {self.name!r} got unexpected params "
                            f"{sorted(unknown)}; known: "
                            f"{sorted(self.defaults)} (+ backend)")
        return dict(self.defaults, **kw)

    def _ref_kw(self, params) -> dict:
        return {k: v for k, v in params.items()
                if k not in self.knob_names and k not in self.sweep}

    def _dispatch(self, kernel, ref, args, backend, kw):
        params = self._params(kw)
        if backend == "torch":
            return ref(*args, **self._ref_kw(params))
        if backend == "cuda":
            if not any(t.device.type == "cuda"
                       for t in _tensors(args, params)):
                raise ValueError(f"op {self.name!r}: backend='cuda' runs the "
                                 "kernel and needs CUDA tensors")
        elif backend != "auto":
            raise ValueError(f"op {self.name!r}: backend must be auto, cuda "
                             f"or torch, got {backend!r}")
        return kernel(*args, **params)

    def __call__(self, *args, backend="auto", **kw):
        return self._dispatch(self.kernel, self.ref, args, backend, kw)

    def raw(self, *args, backend="auto", **kw):
        """Every output of the kernel (or of the plain version), without
        an autograd graph: the functional entry point."""
        return self._dispatch(self.raw_kernel, self.raw_ref, args, backend,
                              kw)

    def reference(self, *args, **kw):
        """The plain version at the public call's granularity."""
        return self.ref(*args, **self._ref_kw(self._params(kw)))

    # -- tuning ----------------------------------------------------------------
    def _target(self, args, params, backend, device):
        if device is None:
            devs = {t.device for t in _tensors(args, params)
                    if t.device.type != "meta"}
            if len(devs) != 1:
                raise ValueError(f"op {self.name!r}: pass device= (the "
                                 f"tensors lie on {sorted(map(str, devs))})")
            device = devs.pop()
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if backend == "auto":
            backend = "cuda" if device.type == "cuda" else "torch"
        if backend == "cuda" and device.type != "cuda":
            raise ValueError(f"op {self.name!r}: backend='cuda' needs a "
                             "CUDA device")
        return device, backend, _tune.target_key(device, backend,
                                                 self.sources)

    def _sweep(self, sweep) -> dict:
        return dict(self.sweep if sweep is None else sweep)

    def tune(self, args, *, sweep=None, cache=True, warmup=1, repeats=3,
             backend="auto", log=None, **kw) -> _tune.TuneResult:
        """Sweep this op's knobs on ``args`` (real tensors); returns the
        winning defines (a :class:`~repro_torch.core.tune.TuneResult`).

        Candidates that overflow shared memory are pruned first. On CUDA
        tensors each one left launches the kernel, is timed on the device
        and held against the plain version by ``tolerance``; on CPU
        tensors (``backend="torch"``) the plain version is timed. Winners
        persist under ``$REPRO_CACHE_DIR`` (``cache=False`` opts out): a
        warm cache times nothing and runs no plain version."""
        params = self._params(kw)
        sweep = self._sweep(sweep)
        if not sweep:
            raise ValueError(f"op {self.name!r} declares no tuning sweep")
        device, backend, target = self._target(args, params, backend, None)
        defines = self.derive_defines(args, params)
        ref_kw = self._ref_kw(params)
        if backend == "cuda":
            def run(knobs):
                return self.raw_kernel(*args, **dict(params, **knobs))
        else:
            def run(knobs):
                return self.raw_ref(*args, **ref_kw)
        return _tune.autotune(
            run, defines, sweep=sweep, device=device, target=target,
            name=self.name, ref=lambda: self.raw_ref(*args, **ref_kw),
            check=self.tolerance, refusal=self.refusal, smem=self.smem,
            warmup=warmup, repeats=repeats, cache=cache, log=log)

    def cached_winner(self, args, *, sweep=None, backend="auto",
                      device=None, **kw) -> dict | None:
        """The persisted :meth:`tune` winner ({knob: value}) for these
        shapes on ``device`` (default: the tensors'), or None: a lookup
        alone. ``args`` may be meta tensors (shapes only)."""
        params = self._params(kw)
        sweep = self._sweep(sweep)
        if not sweep:
            return None
        _, _, target = self._target(args, params, backend, device)
        return _tune.cached_winner(self.name,
                                   self.derive_defines(args, params), sweep,
                                   target)

    def refused(self, args, winner: dict, **kw) -> str | None:
        """Why the wrapper would refuse ``winner`` at these shapes, or
        None. Builds and launches nothing."""
        if self.refusal is None:
            return None
        defines = self.derive_defines(args, self._params(kw))
        return self.refusal(dict(defines, **winner))

    def __repr__(self):
        return (f"Op({self.name!r}, params={sorted(self.defaults)}, "
                f"sweep={sorted(self.sweep)})")


def define_op(name: str, *, kernel, ref, register: bool = True,
              **kw) -> Op:
    """Declare an op over a wrapper; see :class:`Op`. ``example(rng) ->
    (args, params)`` gives representative numpy inputs (:func:`to_tensors`
    places them), for the registry-wide tests and ``tune_cli --op``.
    Registering a name twice raises (callers holding the first op would
    silently diverge from the registry); ``register=False`` keeps an op
    out of it."""
    op = Op(name, kernel=kernel, ref=ref, **kw)
    if register:
        if name in _REGISTRY:
            raise ValueError(
                f"an op named {name!r} is already registered; pick a unique "
                "name or pass register=False")
        _REGISTRY[name] = op
    return op
