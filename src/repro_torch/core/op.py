"""Declarative op front end: ``define_op`` over the kernel language (the
counterpart of ``repro.core.op``).

Every public kernel op of the port is one declaration over a builder: a
kernel-language source, its plain version, a shape -> defines derivation,
and the hooks the JAX package's ops declare. A call derives the defines,
builds the spec through ``default_device(backend, device).build_kernel``
(the Device's kernel cache; the analyzer gates every cache-miss build)
and runs the kernel:

    flash_attention_op = define_op(
        "flash_attention", builder=flash_fwd_builder, ref=mha_ref,
        derive_defines=_defines, vjp=OpVJP(bwd=_bwd, residuals=_res), ...)
    o = flash_attention_op(q, k, v)                  # auto
    o = flash_attention_op(q, k, v, backend="loops") # the same source

``backend=`` takes the language's backends: ``"cuda"`` is the spec's
binding (the hand-written kernel through its wrapper, which counts the
launch; CPU tensors raise), ``"torch"`` and ``"loops"`` its expansions,
and ``"auto"`` is ``"cuda"`` for CUDA tensors and ``"torch"`` for CPU
ones (the counterpart of JAX's interpret mode). ``op.reference`` is the
plain version. The JAX package's ``$REPRO_BACKEND`` is not ported: on the
card it would let an environment variable route the main path around the
kernels.

An op whose spec binds a ``ShardAxis`` declares its mesh schedule as an
:class:`OpShard`; ``op(..., mesh=)`` runs it over the ranks of a
``torch.distributed`` ``DeviceMesh``, each rank passing its shards of the
args (by ``in_specs``) and getting its shard of the result (by
``out_specs``), where JAX's ``shard_map`` takes and returns the global
arrays. An op without one refuses ``mesh=``.

A differentiable op declares an :class:`OpVJP`: its call is a
``torch.autograd.Function`` whose backward runs ``vjp.bwd`` on the same
backend as the forward (the backward builders on ``cuda`` are the
backward kernels); :func:`oracle_vjp` differentiates the plain version
with ``torch.func.vjp``.

Tuned knobs reach a launch only as defines: whoever builds the launch
looks up ``op.cached_winner`` at its shapes (the app drivers; the engine
and the static loop through ``launch.tuning.adopt``, before their step is
captured) and passes the winner on. A wrapper called without the knob
takes its rule; no process-wide state picks a knob.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from . import tune as _tune
from .device import default_device
from .lang import BACKENDS

__all__ = ["Op", "OpShard", "OpVJP", "define_op", "get_op", "oracle_vjp",
           "registered_ops", "to_tensors"]

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


class OpVJP:
    """The backward of a :func:`define_op` op.

    ``bwd(params, residuals, cotangent) -> per-primal-arg cotangents``
    (None for an integer or non-differentiable arg); ``params`` carries
    the resolved ``backend`` so a backward built from kernel-language
    builders runs on the same backend as the forward.
    ``residuals(outs, args, params)`` picks what the backward needs
    (default: the primal args); ``outs`` is the kernel's FULL output
    tuple, so residual-only outputs (flash attention's lse) are there
    though callers never see them."""

    def __init__(self, bwd: Callable, residuals: Callable | None = None):
        self.bwd = bwd
        self.residuals = residuals or (lambda outs, args, params: args)


def oracle_vjp(ref_fn: Callable, *, params: Sequence[str] = ()) -> OpVJP:
    """An :class:`OpVJP` that differentiates the op's plain version: the
    forward runs the kernel, the backward is ``torch.func.vjp`` through
    ``ref_fn(*primals, **{k: params[k]})``: right whenever the kernel and
    the plain version compute the same function (which the tests hold)."""

    def bwd(call_params, res, g):
        kw = {k: call_params[k] for k in params if k in call_params}
        _, pullback = torch.func.vjp(lambda *xs: ref_fn(*xs, **kw), *res)
        return pullback(g)

    return OpVJP(bwd=bwd)


class _Differentiable(torch.autograd.Function):
    """The differentiable core of an op with an :class:`OpVJP`: the
    forward runs the kernel (all its outputs kept for the residuals), the
    backward calls ``vjp.bwd`` with the forward's backend."""

    @staticmethod
    def forward(ctx, op, backend, device, params, *args):
        result, outs = op._primal(args, backend, device, params)
        res = tuple(op.vjp.residuals(outs, args, params))
        ctx.op, ctx.params = op, dict(params, backend=backend)
        ctx.layout = [torch.is_tensor(r) for r in res]
        ctx.others = [r for r in res if not torch.is_tensor(r)]
        ctx.save_for_backward(*[r for r in res if torch.is_tensor(r)])
        ctx.multi = isinstance(result, tuple)
        return result

    @staticmethod
    def backward(ctx, *gs):
        saved, others = iter(ctx.saved_tensors), iter(ctx.others)
        res = tuple(next(saved) if t else next(others) for t in ctx.layout)
        grads = ctx.op.vjp.bwd(ctx.params, res, gs if ctx.multi else gs[0])
        return (None, None, None, None, *grads)


class OpShard:
    """Executable mesh schedule for an op whose spec binds a ShardAxis
    (JAX's declaration, field for field): ``collective`` is "ppermute" (a
    ring: the ``rotate`` args hop to the next shard between steps), "psum"
    or "psum_scatter" (one step a shard, then an all-reduce or a
    reduce-scatter along ``scatter_axis``); ``in_specs(axis, args)`` and
    ``out_specs(axis)`` give the args' and the result's specs (tuples);
    ``extent_param`` names an op param set to the mesh axis size.

    JAX traces ``step``/``merge``/``done`` inside ``shard_map``; the port
    takes the schedule whole: ``run(op, mesh, axis, args, params)`` drives
    it over the mesh's ``torch.distributed`` group of ``axis`` on this
    rank's shards (the ring op's is the port's distributed ring)."""

    def __init__(self, *, mesh_axis: str = "model",
                 collective: str = "ppermute", in_specs: Callable,
                 out_specs: Callable, rotate: Sequence[int] = (),
                 extent_param: str | None = None, scatter_axis: int = 0,
                 run: Callable):
        if collective not in ("ppermute", "psum", "psum_scatter"):
            raise ValueError(f"OpShard collective {collective!r} unknown")
        if collective == "ppermute" and not rotate:
            raise ValueError(
                "OpShard(collective='ppermute') needs rotate= arg indices: "
                "a ring with nothing rotating cannot reduce across shards")
        self.mesh_axis = mesh_axis
        self.collective = collective
        self.in_specs = in_specs
        self.out_specs = out_specs
        self.rotate = tuple(int(i) for i in rotate)
        self.extent_param = extent_param
        self.scatter_axis = int(scatter_axis)
        self.run = run


class Op:
    """A declared op: the callable :func:`define_op` returns.

    Hooks (plain tuples and a params dict):

      early(args, params)          -> result or None   shape short-circuits
      pre(args, params)            -> kernel args      host-side arg prep
      derive_defines(args, params) -> defines          the builder's defines
      post(outs, args, params)     -> public result    output shaping
                                                       (default: a single
                                                       output unwrapped)

    ``args`` of ``post`` and the :class:`OpVJP` hooks are the call's own
    args (``pre`` is kernel-facing only); ``public_outputs`` exposes the
    first n kernel outputs (the rest are residual-only).
    :meth:`derive_defines` applies ``pre`` first, so it takes the call's
    args (probes may be meta tensors).

    The port's tuning declarations: ``sweep`` the knobs (defines) a tune
    sweeps; on defines with a candidate's knobs ``smem`` gives the shared
    memory a block of the hand-written kernel needs (the cuda backend
    prunes by it) and ``refusal`` the reason its wrapper would refuse
    them, or None; ``tolerance`` holds a candidate against the plain
    version (``tune_ref(kernel args, params)``, the kernel's outputs);
    ``sources`` name the op's CUDA sources (their build hash keys its
    winners); ``exact_knobs``: the knobs change only which block computes
    each output, not its arithmetic."""

    def __init__(self, name, builder, ref, derive_defines, *, vjp=None,
                 sweep=None, defaults=None, public_outputs=None, early=None,
                 pre=None, post=None, ref_params=(), tune_ref=None,
                 example=None, doc=None, array_params=(), analyze=None,
                 smem=None, refusal=None, tolerance=None, sources=(),
                 exact_knobs=False, shard=None):
        self.name = name
        self.shard = shard
        self.builder = builder
        self.ref = ref
        self._derive = derive_defines
        self.vjp = vjp
        self.sweep = dict(sweep or {})
        self.defaults = dict(defaults or {})
        self.array_params = tuple(array_params)
        self.public_outputs = public_outputs
        self.ref_params = tuple(ref_params)
        self.tune_ref = tune_ref
        self.example = example
        # per-op analyzer strictness (None: the process mode)
        self.analyze = analyze
        self.smem = smem
        self.refusal = refusal
        self.tolerance = tolerance or _tune.Tolerance()
        self.sources = tuple(sources)
        self.exact_knobs = exact_knobs
        self._early = early
        self._pre = pre
        self._post = post
        self.__doc__ = doc or (ref.__doc__ if ref is not None else None)
        self.__name__ = name

    # -- call plumbing -------------------------------------------------------
    def _resolve(self, kw: Mapping) -> tuple[str, dict]:
        unknown = set(kw) - set(self.defaults) - set(self.array_params) - {
            "backend"}
        if unknown:
            raise TypeError(
                f"op {self.name!r} got unexpected params {sorted(unknown)}; "
                f"known: {sorted(set(self.defaults) | set(self.array_params))}"
                " (+ backend)")
        params = dict(self.defaults)
        params.update(dict.fromkeys(self.array_params))
        params.update(kw)
        backend = params.pop("backend", "auto")
        if backend != "auto" and backend not in BACKENDS:
            raise ValueError(f"op {self.name!r}: backend must be auto or one "
                             f"of {BACKENDS}, got {backend!r}")
        return backend, params

    def _placed(self, backend, args, params):
        """(backend, torch device) of a call: ``auto`` is cuda for CUDA
        tensors and torch for CPU ones; ``cuda`` needs CUDA tensors."""
        ts = _tensors(args, params)
        on_card = [t for t in ts if t.device.type == "cuda"]
        device = on_card[0].device if on_card else (
            ts[0].device if ts else torch.device("cpu"))
        if backend == "auto":
            backend = "cuda" if on_card else "torch"
        if backend == "cuda" and not on_card:
            raise ValueError(f"op {self.name!r}: backend='cuda' runs the "
                             "kernel and needs CUDA tensors")
        return backend, device

    def _prepare(self, args, params) -> tuple[tuple, dict, dict]:
        """The call prologue: the pre hook, then shapes -> defines."""
        params = dict(params)
        if self._pre is not None:
            args = tuple(self._pre(tuple(args), params))
        return tuple(args), self._derive(tuple(args), params), params

    def derive_defines(self, args, params) -> dict:
        """The builder's defines of a call's args and params (``pre``
        applied first); raises ``ValueError`` outside the op's domain."""
        return self._prepare(args, params)[1]

    def _run_kernel(self, args, backend, device, params) -> tuple:
        """prepare -> build (the Device's kernel cache) -> run: every
        kernel output."""
        args, defines, _ = self._prepare(args, params)
        kern = default_device(backend, device).build_kernel(
            self.builder, defines, analyze=self.analyze)
        return kern.run(*args)

    def _publish(self, outs, args, params):
        pub = outs if self.public_outputs is None else \
            outs[: self.public_outputs]
        if self._post is not None:
            return self._post(pub, args, params)
        return pub[0] if len(pub) == 1 else tuple(pub)

    def _primal(self, args, backend, device, params):
        outs = self._run_kernel(args, backend, device, params)
        return self._publish(outs, args, params), outs

    def _shard_call(self, mesh, args, kw):
        """Run the declared :class:`OpShard` schedule over ``mesh``."""
        from repro_torch.parallel.rules import mesh_shape

        sh = self.shard
        if sh is None:
            raise ValueError(
                f"op {self.name!r} declares no mesh schedule (OpShard); "
                "mesh= is not supported here")
        ax = sh.mesh_axis
        shape = mesh_shape(mesh)
        if ax not in shape:
            raise ValueError(f"op {self.name!r}: mesh has no axis {ax!r} "
                             f"(axes: {tuple(shape)})")
        params = dict(kw)
        if sh.extent_param:
            params.setdefault(sh.extent_param, int(shape[ax]))
        self._resolve(params)             # unknown params raise
        return sh.run(self, mesh, ax, args, params)

    def __call__(self, *args, **kw):
        mesh = kw.pop("mesh", None)
        if mesh is not None:
            return self._shard_call(mesh, args, kw)
        backend, params = self._resolve(kw)
        if self._early is not None:
            got = self._early(args, dict(params))
            if got is not None:
                return got
        backend, device = self._placed(backend, args, params)
        if self.vjp is not None:
            # array-valued params do not ride the backward's params: they
            # are refused here, as the JAX op refuses them
            live = [n for n in self.array_params if params.get(n) is not None]
            if live:
                raise ValueError(
                    f"op {self.name!r}: params {live} take arrays and are not "
                    "differentiable through the public op; use the functional "
                    f"entry point ({self.name}.raw / its wrapper) instead")
            for n in self.array_params:
                params.pop(n, None)
            if torch.is_grad_enabled() and any(
                    t.requires_grad for t in args if torch.is_tensor(t)):
                return _Differentiable.apply(self, backend, device, params,
                                             *args)
        return self._primal(args, backend, device, params)[0]

    def raw(self, *args, **kw):
        """Every output of the kernel (no VJP, no early/post): the
        functional entry point."""
        backend, params = self._resolve(kw)
        backend, device = self._placed(backend, args, params)
        return self._run_kernel(args, backend, device, params)

    def reference(self, *args, **kw):
        """The plain version at the public call's granularity."""
        _, params = self._resolve(kw)
        return self.ref(*args, **{k: params[k] for k in self.ref_params
                                  if k in params})

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

    def _pruner(self, backend, prune, fit):
        """The up-front rejection of a tune: on cuda the hand-written
        kernel's own shared memory (``smem``); on torch and loops, where
        the spec's tiles are what runs, the cost model (its footprint, and
        ``prune=True`` the dominated candidates). ``fit`` fits each
        candidate to the shapes by the op's own policy."""
        if backend == "cuda":
            return lambda defines, sweep: _tune.prune_candidates(
                defines, sweep, self.smem, fit=fit)
        return lambda defines, sweep: _tune.prune_by_cost(
            self.builder, defines, sweep, dominated=prune, fit=fit)

    def tune(self, args, *, sweep=None, cache=True, warmup=1, repeats=3,
             backend="auto", prune=True, log=None,
             **kw) -> _tune.TuneResult:
        """Sweep this op's knobs on ``args`` (real tensors); returns the
        winning defines (a :class:`~repro_torch.core.tune.TuneResult`).

        Every candidate is built through the Device on the backend (auto:
        cuda for CUDA tensors, torch for CPU ones) and run; candidates
        are pruned up front (:meth:`_pruner`), a build the binding or the
        analyzer refuses is skipped, each one left is timed (device time
        on the card) and held against the plain version by ``tolerance``.
        Winners persist under ``$REPRO_CACHE_DIR`` (``cache=False`` opts
        out): a warm cache builds, times and runs nothing."""
        _, params = self._resolve(kw)
        sweep = self._sweep(sweep)
        if not sweep:
            raise ValueError(f"op {self.name!r} declares no tuning sweep")
        device, backend, target = self._target(args, params, backend, None)
        run_args, defines, pparams = self._prepare(args, params)
        dev = default_device(backend, device)

        def fit(cand):
            # a candidate's knobs through the op's fitting (derive_defines)
            return self._derive(run_args, dict(pparams, **{
                n: cand[n] for n in sweep}))

        def run(knobs):
            return dev.build_kernel(self.builder, dict(defines, **knobs),
                                    analyze=self.analyze).run(*run_args)

        def ref():
            if self.tune_ref is not None:
                return self.tune_ref(run_args, pparams)
            return self.ref(*args, **{k: params[k] for k in self.ref_params
                                      if k in params})

        return _tune.autotune(
            run, defines, sweep=sweep, device=device, target=target,
            name=self.name, ref=ref, check=self.tolerance,
            refusal=self.refusal if backend == "cuda" else None,
            prune=self._pruner(backend, prune, fit), warmup=warmup,
            repeats=repeats, cache=cache, log=log)

    def cached_winner(self, args, *, sweep=None, backend="auto",
                      device=None, **kw) -> dict | None:
        """The persisted :meth:`tune` winner ({knob: value}) for these
        shapes on ``device`` (default: the tensors'), or None: a lookup
        alone. ``args`` may be meta tensors (shapes only)."""
        _, params = self._resolve(kw)
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
        _, params = self._resolve(kw)
        return self.refusal(dict(self.derive_defines(args, params), **winner))

    def __repr__(self):
        return (f"Op({self.name!r}, params={sorted(self.defaults)}, "
                f"sweep={sorted(self.sweep)}, vjp={self.vjp is not None})")


def define_op(name: str, *, builder: Callable, ref: Callable | None,
              derive_defines: Callable, vjp: OpVJP | None = None,
              sweep: Mapping | None = None, defaults: Mapping | None = None,
              public_outputs: int | None = None, early: Callable | None = None,
              pre: Callable | None = None, post: Callable | None = None,
              ref_params: Sequence[str] = (), tune_ref: Callable | None = None,
              example: Callable | None = None, doc: str | None = None,
              array_params: Sequence[str] = (), register: bool = True,
              analyze: str | None = None, shard: OpShard | None = None,
              **tuning) -> Op:
    """Declare a public op over the kernel language; see :class:`Op`
    (``tuning``: its ``smem``, ``refusal``, ``tolerance``, ``sources`` and
    ``exact_knobs``). ``example(rng) -> (args, params)`` gives
    representative numpy inputs (:func:`to_tensors` places them) for the
    registry-wide tests, ``lint_kernels`` and ``tune_cli --op``.
    ``array_params`` name params that may hold tensors (a carried state
    ``h0``): legal on ``op.raw`` and ``op.tune``, refused on the
    differentiable call. ``shard``: the op's :class:`OpShard` (its
    ``mesh=`` schedule). Registering a name twice raises;
    ``register=False`` keeps an op out of the registry."""
    op = Op(name, builder, ref, derive_defines, vjp=vjp, sweep=sweep,
            defaults=defaults, public_outputs=public_outputs, early=early,
            pre=pre, post=post, ref_params=ref_params, tune_ref=tune_ref,
            example=example, doc=doc, array_params=array_params,
            analyze=analyze, shard=shard, **tuning)
    if register:
        if name in _REGISTRY:
            raise ValueError(
                f"an op named {name!r} is already registered; pick a unique "
                "name or pass register=False")
        _REGISTRY[name] = op
    return op
