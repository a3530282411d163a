"""Kernel autotuning for the port: the paper's ``setThreadArray`` tuning
loop (the counterpart of ``repro.core.tune``). An op's launch parameters
(its *knobs*: a decode split, an app kernel's tile or elements a block)
are swept on real tensors, each candidate timed and held against the op's
plain version, and the winner kept on disk.

Winners persist across processes as JSON under ``$REPRO_CACHE_DIR``
(default ``~/.cache/repro-occa``), in ``autotune_torch/`` beside the JAX
package's ``autotune/``: neither package's ``tune_cli --lint --evict``
touches the other's entries. An entry is keyed by the op, the defines its
knobs do not set (shapes, dtype, masks), the candidate sets, the backend
(``"cuda"``: the hand-written kernel; ``"torch"`` or ``"loops"``: the
spec's expansion), the device's name, the torch and CUDA versions and, for ``"cuda"``, the build
hash of the op's kernel sources (``kernels._build.source_hash``), so an
edited ``.cu`` never answers with a winner timed on the old one. A sweep
on the CPU times the spec's torch expansion and is keyed
``backend="torch"``, ``device="cpu"``: it never answers for the card (the
JAX package's rule for interpret mode).

Candidates are pruned before any build: on ``cuda`` by the hand-written
kernel's own shared memory (:func:`prune_candidates`, the wrapper's size
function), on ``torch`` and ``loops``, where the spec's tiles are what
runs, by the cost model (:func:`prune_by_cost`: the spec's footprint,
and the candidates another one dominates, the JAX package's rule). The
spec's byte model does not describe a hand-written kernel (``fd2d.cu``
streams rows and fetches no halo twice), so dominance never prunes on
``cuda``.

Entries carry :data:`SCHEMA_VERSION`. A corrupt entry, one of another
schema, one whose stored key disagrees with its digest, or one whose
winner lacks a swept knob is evicted on load, never reused and never
crashed on. :func:`cached_winner` is the lookup alone: no tensor is made,
no kernel built or timed.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import pathlib
import time

import torch

__all__ = ["SCHEMA_VERSION", "Tolerance", "TuneResult",
           "autotune", "cached_winner", "candidates", "prune_by_cost",
           "prune_candidates",
           "target_key", "tune_cache_dir", "tune_cache_key"]

# Bump whenever the meaning of an entry changes (payload layout, winner
# semantics, timing protocol): entries of any other version are evicted.
# 2: the defines are the builders' (JAX's fitting policy), and a "torch"
# winner times the spec's torch expansion, not the plain version.
SCHEMA_VERSION = 2
CACHE_SUBDIR = "autotune_torch"


def tune_cache_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get(
        "REPRO_CACHE_DIR", os.path.expanduser("~/.cache/repro-occa")))


def _root() -> pathlib.Path:
    return tune_cache_dir() / CACHE_SUBDIR


def target_key(device: torch.device, backend: str, sources=()) -> dict:
    """What a winner was timed on: ``backend`` ("cuda", "torch" or
    "loops"), the device's name ("cpu" on the CPU), the torch and CUDA
    versions, and for "cuda" the build hash of the kernel ``sources``."""
    if backend not in ("cuda", "torch", "loops"):
        raise ValueError(f"backend must be cuda, torch or loops, got "
                         f"{backend!r}")
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
    elif device.type == "cpu":
        name = "cpu"
    else:
        raise ValueError(f"no tuning target on device {device}")
    build = None
    if backend == "cuda":
        from ..kernels._build import source_hash

        build = source_hash(*sources)
    return dict(backend=backend, device=name, torch_version=torch.__version__,
                cuda_version=torch.version.cuda, build_hash=build)


def tune_cache_key(name: str, defines: dict, sweep: dict,
                   target: dict) -> tuple[str, dict]:
    """(digest, payload): the persisted identity of one tuning problem.

    The swept knobs are left out of the defines (they are the output), but
    the candidate sets are in: a narrower sweep is another problem, whose
    winner must not come from values the caller left out."""
    base = {k: defines[k] for k in sorted(defines) if k not in sweep}
    payload = dict(op=name, defines=base,
                   sweep={k: list(sweep[k]) for k in sorted(sweep)}, **target)
    # a JSON round trip first: the stored entry is compared with it
    payload = json.loads(json.dumps(payload, sort_keys=True))
    digest = hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()[:24]
    return digest, payload


def _evict(path: pathlib.Path):
    try:
        path.unlink()
    except OSError:
        pass


def _cache_load(digest: str, payload: dict, names):
    """The entry for ``digest``, or None; an unusable one is evicted."""
    path = _root() / f"{digest}.json"
    try:
        with open(path) as f:
            entry = json.load(f)
    except OSError:
        return None                     # no entry: nothing to evict
    except ValueError:
        _evict(path)                    # corrupt: remove and re-tune
        return None
    winner = entry.get("winner") if isinstance(entry, dict) else None
    if (not isinstance(winner, dict)
            or entry.get("schema") != SCHEMA_VERSION
            or any(entry.get(k) != v for k, v in payload.items())
            or not all(n in winner for n in names)):
        _evict(path)
        return None
    return entry


def _cache_store(digest: str, payload: dict, winner: dict, seconds: float):
    root = _root()
    try:
        root.mkdir(parents=True, exist_ok=True)
        tmp = root / f".{digest}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(dict(payload, schema=SCHEMA_VERSION, winner=winner,
                           best_seconds=seconds), f, indent=1, sort_keys=True)
        os.replace(tmp, root / f"{digest}.json")
    except OSError:
        pass  # the cache saves time; a tune never fails over it


def cached_winner(name: str, defines: dict, sweep: dict,
                  target: dict) -> dict | None:
    """The persisted winner of one tuning problem ({knob: value}), or None.
    A lookup alone; stale entries are evicted on the way."""
    names = sorted(sweep)
    digest, payload = tune_cache_key(name, defines, sweep, target)
    hit = _cache_load(digest, payload, names)
    return None if hit is None else {n: hit["winner"][n] for n in names}


class TuneResult(dict):
    """The winning defines (the problem's defines with the winning knobs).
    ``.trials``: (candidate, seconds a launch) for every candidate timed;
    ``.best_seconds`` the winner's; ``.skipped``: (candidate, reason) for
    candidates rejected before or after timing (``prune[...]`` reasons are
    also ``.pruned``: rejected up front, never launched; a candidate the
    wrapper refuses, or whose outputs miss the plain version's, is
    skipped with its reason); ``.cached``: the result came from the
    persisted cache, and nothing was timed; ``.seconds``: the wall time the
    call took (the whole sweep, or the lookup)."""

    def __init__(self, best, trials, skipped=(), best_seconds=None,
                 cached=False, seconds=float("nan")):
        super().__init__(best)
        self.seconds = seconds
        self.trials = list(trials)
        if best_seconds is None:
            timed = [t for _, t in self.trials]
            best_seconds = min(timed) if timed else float("nan")
        self.best_seconds = best_seconds
        self.skipped = list(skipped)
        self.cached = cached

    @property
    def pruned(self):
        return [(c, r) for c, r in self.skipped if r.startswith("prune[")]


class Tolerance:
    """What a candidate's outputs must meet against the plain version on
    the same tensors: |out - ref| <= atol + rtol |ref| elementwise, with
    (atol, rtol) by the reference's dtype; ``scaled`` multiplies atol by
    max |ref| (for sums whose error grows with their magnitude). Calling
    it returns None, or the reason a candidate fails."""

    def __init__(self, f32=(1e-4, 1e-4), bf16=(2e-2, 2e-2), *,
                 scaled=False):
        self.by_dtype = {torch.float32: f32, torch.bfloat16: bf16}
        self.scaled = scaled

    def __call__(self, out, ref):
        outs = out if isinstance(out, (tuple, list)) else (out,)
        refs = ref if isinstance(ref, (tuple, list)) else (ref,)
        for i, (o, r) in enumerate(zip(outs, refs, strict=True)):
            if o.shape != r.shape:
                return (f"output {i}: shape {tuple(o.shape)} != "
                        f"{tuple(r.shape)}")
            atol, rtol = self.by_dtype.get(r.dtype, self.by_dtype[
                torch.float32])
            o32, r32 = o.float(), r.float()
            if self.scaled and r32.numel():
                atol = atol * float(r32.abs().max())
            err = (o32 - r32).abs()
            bad = ~(err <= atol + rtol * r32.abs())   # NaN counts as bad
            if bool(bad.any()):
                worst = float(torch.nan_to_num(err, nan=float("inf")).max())
                return (f"output {i}: {int(bad.sum())} of {err.numel()} "
                        f"elements outside atol={atol:.3g} rtol={rtol:.3g} "
                        f"(max |err| {worst:.3e})")
        return None


def prune_candidates(defines: dict, sweep: dict, smem, *, fit=None):
    """Reject up front, without a launch, every candidate whose shared
    memory per block (``smem(candidate defines)``, the wrapper's own size
    function; None: unknown, kept) exceeds the H100's 227 KB a block
    (``kernels.apps._common.SMEM_MAX``): the cuda backend's rule. Returns
    (kept, pruned), pruned as (candidate, ``prune[SMEM_OVERFLOW]: ...``).
    ``fit`` (see :func:`candidates`) fits each candidate to the shapes."""
    from ..kernels.apps import _common

    budget = _common.SMEM_MAX
    kept, pruned = [], []
    for cand in candidates(defines, sweep, fit):
        need = smem(cand) if smem is not None else None
        if need is not None and need > budget:
            pruned.append((cand, f"prune[SMEM_OVERFLOW]: {need} B of shared "
                                 f"memory a block > budget {budget} B"))
        else:
            kept.append(cand)
    return kept, pruned


def candidates(defines, sweep, fit=None) -> list[dict]:
    """Every combination of the swept knobs over ``defines``, in order;
    ``fit(candidate) -> defines`` fits each to the shapes (the op's own
    policy: a tile larger than the field is clipped to it, as the
    wrappers do), and candidates that fit to the same knobs are kept
    once."""
    names = sorted(sweep)
    out, seen = [], set()
    for combo in itertools.product(*(sweep[n] for n in names)):
        cand = dict(defines, **dict(zip(names, combo)))
        if fit is not None:
            cand = fit(cand)
        key = tuple(repr(cand[n]) for n in names)
        if key not in seen:
            seen.add(key)
            out.append(cand)
    return out


def prune_by_cost(builder, defines: dict, sweep: dict, *, budget=None,
                  dominated: bool = True, fit=None):
    """The cost model's pass over a sweep (the torch and loops backends'
    rule; the JAX package's ``prune_candidates``): no candidate is built
    or run. Returns (kept, pruned), reasons prefixed ``prune[CODE]:``.
    Both rules fail open (a candidate the model cannot price is kept for
    the build to judge):

    * ``prune[SMEM_OVERFLOW]``: the spec's footprint exceeds the budget
      (:func:`analyze.smem_budget`); its build would raise the same.
    * ``prune[DOMINATED]`` (``dominated=True``): another candidate that
      fits moves no more device-memory bytes and does no more FLOPs, one
      of them strictly less. The footprint is not part of the vector
      (bigger blocks trade it for bytes nearly always); the budget alone
      polices it.

    ``fit`` (see :func:`candidates`) fits each candidate to the shapes."""
    from types import SimpleNamespace

    from . import analyze as _analyze

    budget = _analyze.smem_budget() if budget is None else int(budget)
    names = sorted(sweep)
    cands = []   # (cand, report | None)
    for cand in candidates(defines, sweep, fit):
        try:
            D = SimpleNamespace(**cand)
            rep = _analyze.estimate_cost(builder(D), D, budget=budget)
        except Exception:
            rep = None   # invalid or unpriceable: the build loop decides
        cands.append((cand, rep))

    kept, pruned = [], []
    fitting = [(c, r) for c, r in cands
               if r is not None and r.smem_bytes <= budget]
    for cand, rep in cands:
        if rep is None:
            kept.append(cand)
            continue
        if rep.smem_bytes > budget:
            pruned.append((cand, (
                f"prune[SMEM_OVERFLOW]: static footprint {rep.smem_bytes} B "
                f"> budget {budget} B")))
            continue
        dominator = None
        if dominated and rep.flops is not None:
            for other, orep in fitting:
                if other is cand or orep.flops is None:
                    continue
                if (orep.hbm_bytes <= rep.hbm_bytes
                        and orep.flops <= rep.flops
                        and (orep.hbm_bytes < rep.hbm_bytes
                             or orep.flops < rep.flops)):
                    dominator = (other, orep)
                    break
        if dominator is not None:
            other, orep = dominator
            over = {n: other[n] for n in names}
            pruned.append((cand, (
                f"prune[DOMINATED]: {over} moves {orep.hbm_bytes} B vs "
                f"{rep.hbm_bytes} B and does {orep.flops} vs {rep.flops} "
                "FLOPs: statically at least as fast")))
            continue
        kept.append(cand)
    return kept, pruned


def _device_seconds(fn, n, device):
    """Seconds a call of ``fn`` takes on the card: CUDA events around ``n``
    calls queued behind a sleep kernel, so the card starts the first one
    only once the host has enqueued all of them and no host time between
    calls is timed (a decode kernel runs for less than its wrapper's
    Python takes; a compiled step replays it without that Python). The
    sleep is lengthened until it outlasts the host's enqueueing."""
    torch.cuda.synchronize(device)
    cycles = 1 << 20
    for _ in range(8):
        s0, s, e = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s0.record()
        torch.cuda._sleep(cycles)
        s.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = time.perf_counter() - t0
        e.record()
        e.synchronize()
        if s0.elapsed_time(s) / 1e3 > 1.25 * host + 5e-5:
            return s.elapsed_time(e) / 1e3 / n
        cycles *= 4
    raise RuntimeError(f"the host took {host * 1e3:.3f} ms to enqueue {n} "
                       "calls, longer than the longest sleep")


def _time(fn, device, *, warmup, repeats):
    """(seconds a call, the first call's output): ``warmup`` calls (at
    least one), then ``repeats`` calls timed on the card by
    :func:`_device_seconds`, on the CPU by the host clock."""
    out = fn()
    for _ in range(warmup - 1):
        fn()
    n = max(1, repeats)
    if device.type == "cuda":
        return _device_seconds(fn, n, device), out
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n, out


def autotune(run, defines: dict, *, sweep: dict, device, target: dict,
             name: str, ref, check=None, refusal=None, prune=None,
             warmup: int = 1, repeats: int = 3, cache: bool = False,
             log=None) -> TuneResult:
    """Grid-search ``sweep`` ({knob: candidates}) for one tuning problem.

    ``run(knobs)`` builds and runs the op once on its fixed tensors with
    those knobs and returns its outputs. ``prune(defines, sweep)`` ->
    (kept, pruned) rejects candidates first (:func:`prune_candidates`,
    :func:`prune_by_cost`; None keeps all); those ``refusal`` names a
    reason for, or whose build or launch raises ``ValueError`` (a binding
    or the analyzer refusing them), are skipped with the reason; each one
    left is timed (:func:`_time`: device time on the card) and its outputs
    held against ``ref()`` (the plain version on the same tensors,
    evaluated once, after a cache miss) by ``check`` (a
    :class:`Tolerance`): a candidate that fails is skipped with the
    reason, never chosen. ``log(candidate, seconds)`` sees each timing.
    ``cache`` reads and writes the persisted winner
    (:func:`cached_winner`)."""
    t0 = time.perf_counter()
    names = sorted(sweep)
    if cache:
        digest, payload = tune_cache_key(name, defines, sweep, target)
        hit = _cache_load(digest, payload, names)
        if hit is not None:
            winner = {n: hit["winner"][n] for n in names}
            return TuneResult(dict(defines, **winner), trials=[],
                              best_seconds=hit.get("best_seconds",
                                                   float("nan")),
                              cached=True,
                              seconds=time.perf_counter() - t0)
    check = check or Tolerance()
    cands, skipped = (prune(defines, sweep) if prune is not None
                      else (candidates(defines, sweep), []))
    if not cands and skipped:
        raise ValueError(
            f"{name}: every sweep candidate was statically pruned:\n"
            + "\n".join(f"  {c}: {r}" for c, r in skipped))
    reference = None
    trials = []
    for cand in cands:
        knobs = {n: cand[n] for n in names}
        reason = refusal(cand) if refusal is not None else None
        if reason is not None:
            skipped.append((cand, reason))
            continue
        try:
            sec, out = _time(lambda: run(knobs), device, warmup=warmup,
                             repeats=repeats)
        except ValueError as e:          # the wrapper refused these knobs
            skipped.append((cand, str(e)))
            continue
        if reference is None:
            reference = ref()
            reference = (tuple(reference) if isinstance(reference,
                                                        (tuple, list))
                         else (reference,))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        bad = check(tuple(outs)[:len(reference)], reference)
        if bad is not None:
            skipped.append((cand, f"validation: {bad}"))
            continue
        trials.append((cand, sec))
        if log is not None:
            log(knobs, sec)
    if not trials:
        raise ValueError(
            f"{name}: no valid candidate in the sweep:\n"
            + "\n".join(f"  {({n: c[n] for n in names})}: {r}"
                        for c, r in skipped))
    best, best_sec = min(trials, key=lambda t: t[1])
    result = TuneResult(best, trials, skipped, best_seconds=best_sec,
                        seconds=time.perf_counter() - t0)
    if cache:
        _cache_store(digest, payload, {n: best[n] for n in names}, best_sec)
    return result
