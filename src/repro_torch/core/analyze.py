"""Static analysis of kernel-language specs (the counterpart of
``repro.core.analyze``).

``check_grid_invariants(spec)`` enumerates every tile's index map over the
concrete grid: bounds (``BOUNDS_INDEX``, ``BOUNDS_HALO``, ``BOUNDS_TABLE``,
``BOUNDS_SCRATCH``), write races, where distinct (outer x slot) cells map
to one output block (``RACE_PARALLEL_WRITE``), index maps that depend on
accumulated reduce axes (``SEMANTICS_ACC_INDEX``) and blocks never visited
(``COVERAGE_UNWRITTEN``). These are certain bugs: ``lang.Spec`` raises
:class:`AnalysisError` on any at construction, so an invalid define fails
inside ``Device.build_kernel``. ``check_shard_binding`` adds the
cross-shard hazards of a ``ShardAxis`` (``RACE_MESH_WRITE``,
``COLLECTIVE_UNDECLARED``) and ``check_semantics`` a ``"parallel"`` reduce
axis that carries state (``SEMANTICS_PARALLEL_CARRIED``).

``trace_body(spec, defines)`` + ``check_body(spec, events)`` is the body
pass: the body runs once on ``meta`` tensors of the block shapes (no
memory, no arithmetic) with a recording ctx and refs that log every ref
read and write beside the ``when``/``cell_when`` predicates around it.
``is_first``/``reduce_first(d)``/... are symbolic tokens there; a
predicate of grid ids or data (a 0-dim meta tensor, which has no value)
is opaque: it may skip. From the log: ``LIVENESS_SCRATCH_UNINIT``
(scratch read before a write that is certain on the first reduce visit)
and ``COVERAGE_SKIP_NO_INIT`` (an output only written under skippable
predicates, with no certain first-visit init or last-visit flush, or read
before a certain write). The torch and loops expansions zero-fill output
and scratch blocks, so such a body passes there; the hand-written kernel
of a spec, like the TPU, finds undefined memory.

The cost model (``estimate_cost``) prices one built spec for the H100:
its footprint per block against the shared memory a block may use
(:func:`smem_budget`: 232,448 B, ``$REPRO_SMEM_BUDGET`` to override), the
device-memory bytes its C-order grid walk moves, and its FLOPs, counted
from the body run on meta tensors under a ``TorchDispatchMode`` once per
set of enabled guarded regions. The footprint rule is the JAX package's
(a streamed block counts twice, then scratch): it describes the spec's
tiles, not a hand-written kernel's, which keeps some of them in registers
or streams them, so on the ``cuda`` backend ``Device.build_kernel``
reports a footprint finding and the binding's own refusal gates the build.

Finding codes, severities and messages are the JAX analyzer's (the
footprint's ``SMEM_OVERFLOW`` is its ``VMEM_OVERFLOW``). Strictness is a
process knob (``$REPRO_ANALYZE`` / :func:`set_analysis_mode`, per build
``Device.build_kernel(..., analyze=...)``):

  ``off``     skip the body pass and the footprint (the grid pass still
              guards every Spec)
  ``warn``    report every finding as an :class:`AnalysisWarning`
  ``error``   raise on error findings, warn on coverage ones   (default)
  ``strict``  raise on any finding (``repro_torch.lint_kernels --strict``)
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import warnings
from types import SimpleNamespace

import numpy as np
import torch

__all__ = [
    "ANALYZE_MODES",
    "AnalysisError",
    "AnalysisWarning",
    "CostReport",
    "DEFAULT_SMEM_BUDGET",
    "Finding",
    "FOOTPRINT_CODES",
    "Report",
    "SEVERITY",
    "analysis_mode",
    "analyze_spec",
    "check_body",
    "check_built_spec",
    "check_grid_invariants",
    "check_semantics",
    "check_shard_binding",
    "estimate_cost",
    "estimate_flops",
    "set_analysis_mode",
    "smem_budget",
    "smem_footprint",
    "trace_body",
]

ANALYZE_MODES = ("off", "warn", "error", "strict")

# finding code -> severity; "error" findings are certain (or near-certain)
# cross-backend divergence, "coverage" findings are may-leave-undefined
# hazards gated by the strictness knob
SEVERITY = {
    "BOUNDS_INDEX": "error",
    "BOUNDS_HALO": "error",
    "BOUNDS_TABLE": "error",
    "BOUNDS_SCRATCH": "error",
    "RACE_PARALLEL_WRITE": "error",
    "SEMANTICS_ACC_INDEX": "error",
    "COVERAGE_UNWRITTEN": "error",
    "LIVENESS_SCRATCH_UNINIT": "error",
    "SEMANTICS_PARALLEL_CARRIED": "error",
    "COVERAGE_SKIP_NO_INIT": "coverage",
    "TRACE_INCOMPLETE": "coverage",
    # -- mesh-extended grid (ShardAxis bindings) --
    "RACE_MESH_WRITE": "error",
    "COLLECTIVE_UNDECLARED": "error",
    # -- static cost model (performance findings) --
    "SMEM_OVERFLOW": "error",
    "FOOTPRINT_NEAR_LIMIT": "coverage",
    "REDUNDANT_FETCH": "coverage",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer verdict: a stable code + the offending spec/ref/message."""

    code: str
    spec: str
    subject: str  # tile/scratch name (or "" for spec-level findings)
    message: str

    @property
    def severity(self) -> str:
        return SEVERITY.get(self.code, "error")

    def __str__(self):
        return f"[{self.code}] kernel {self.spec!r}: {self.message}"


class AnalysisError(ValueError):
    """A rejected kernel spec. Subclasses ValueError on purpose: the tuner
    treats build-time ValueErrors as skippable invalid candidates."""

    def __init__(self, findings):
        self.findings = tuple(findings)
        super().__init__("\n".join(str(f) for f in self.findings))


class AnalysisWarning(UserWarning):
    """A non-fatal analyzer finding (coverage class, or warn mode)."""


@dataclasses.dataclass
class Report:
    """All findings for one spec + the dispatch policy per strictness mode."""

    spec: str
    findings: list

    @property
    def errors(self):
        return [f for f in self.findings if f.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.findings

    def emit(self, mode: str) -> None:
        """Raise or warn per the strictness mode: ``off`` nothing, ``warn``
        every finding as an :class:`AnalysisWarning`, ``error`` raise on
        error findings and warn on coverage ones, ``strict`` raise on any."""
        if mode not in ANALYZE_MODES:
            raise ValueError(
                f"unknown analyze mode {mode!r}; expected one of {ANALYZE_MODES}")
        if mode == "off" or not self.findings:
            return
        if mode == "strict":
            raise AnalysisError(self.findings)
        if mode == "error" and self.errors:
            raise AnalysisError(self.errors)
        for f in self.findings:
            if mode == "warn" or f.severity != "error":
                warnings.warn(str(f), AnalysisWarning, stacklevel=3)


# ---------------------------------------------------------------------------
# Strictness knob
# ---------------------------------------------------------------------------

_MODE_OVERRIDE: str | None = None


def analysis_mode() -> str:
    """The process-wide strictness mode: :func:`set_analysis_mode`'s
    override, else ``$REPRO_ANALYZE``, else ``"error"``."""
    if _MODE_OVERRIDE is not None:
        return _MODE_OVERRIDE
    mode = os.environ.get("REPRO_ANALYZE", "error")
    if mode not in ANALYZE_MODES:
        raise ValueError(
            f"REPRO_ANALYZE={mode!r} is not an analyze mode; expected one "
            f"of {ANALYZE_MODES}")
    return mode


def set_analysis_mode(mode: str | None) -> str | None:
    """Override the process-wide mode (None restores ``$REPRO_ANALYZE``).
    Returns the previous override so callers can restore it."""
    global _MODE_OVERRIDE
    if mode is not None and mode not in ANALYZE_MODES:
        raise ValueError(
            f"unknown analyze mode {mode!r}; expected one of {ANALYZE_MODES}")
    prev, _MODE_OVERRIDE = _MODE_OVERRIDE, mode
    return prev


# ---------------------------------------------------------------------------
# Concrete-grid invariants (index-map enumeration)
# ---------------------------------------------------------------------------

def _bounds_detail(bi, nb):
    for ax, (i, n) in enumerate(zip(bi, nb)):
        if not 0 <= i < n:
            return f"axis {ax}: block index {i} not in [0, {n})"
    return f"rank {len(bi)} != block-grid rank {len(nb)}"


def _is_integer(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return not (dtype.is_floating_point or dtype.is_complex
                    or dtype == torch.bool)
    return np.issubdtype(np.dtype(dtype), np.integer)


def _table_findings(spec):
    """Structural validation of every ``Tile(index_tile=...)`` declaration:
    the dynamic block index must come from an integer INPUT tile whose block
    is all-ones (its block index IS the element it contributes), naming a
    real axis of the gathered tile. Run-time values are clamped by the
    expansions, so a well-formed declaration cannot read out of bounds;
    malformed declarations are certain bugs (BOUNDS_TABLE)."""
    findings = []
    in_tiles = {t.name: t for t in spec.inputs}

    def bad(t, msg):
        findings.append(Finding(
            "BOUNDS_TABLE", spec.name, t.name,
            f"tile {t.name!r}: {msg}"))

    for t in spec.outputs:
        if getattr(t, "index_tile", None) is not None:
            bad(t, "index_tile= is input-only (a run-time write destination "
                   "would race undetectably)")
    for t in spec.inputs:
        it = getattr(t, "index_tile", None)
        if it is None:
            continue
        if (not isinstance(it, tuple)) or len(it) != 2:
            bad(t, f"index_tile must be a (table_name, axis) pair, got {it!r}")
            continue
        tname, axis = it
        if t.halo is not None and any(t.resolved_halo()):
            bad(t, "halo= and index_tile= cannot combine (the windowed "
                   "lowering would reorder the gathered axis)")
        if not isinstance(axis, int) or not 0 <= axis < len(t.shape):
            bad(t, f"index_tile axis {axis!r} out of range for rank-"
                   f"{len(t.shape)} tile")
            continue
        table = in_tiles.get(tname)
        if table is None or table is t:
            bad(t, f"index_tile names {tname!r}, which is not another "
                   "input tile of this kernel")
            continue
        if getattr(table, "index_tile", None) is not None:
            bad(t, f"table tile {tname!r} is itself gathered via "
                   "index_tile — tables must have static index maps")
        if not _is_integer(table.dtype):
            bad(t, f"table tile {tname!r} dtype "
                   f"{str(table.dtype).removeprefix('torch.')} is not an "
                   "integer type")
        if any(b != 1 for b in table.resolved_block()):
            bad(t, f"table tile {tname!r} block {table.resolved_block()} "
                   "must be all-ones so its block index selects exactly "
                   "the element the gather reads")
    return findings


def _identity_cover(spec, t, nb) -> bool:
    """True when ``t``'s blocks need no walk: the identity index map of a
    blocked tile over a grid without reduce axes that equals its block
    grid, so each cell reads or writes its own block, every one in bounds
    and every one once (the FD stencil's tiles, up to 262,144 cells)."""
    return (t.index is None and t.index_tile is None and not spec.reduce_axes
            and tuple(t.resolved_block()) != tuple(t.shape)
            and tuple(spec.grid) == tuple(nb))


def check_grid_invariants(spec):
    """Enumerate every tile's index map over the whole grid.

    Returns ``(findings, input_reduce_invariant)``: the latter is the
    per-input hoisting mask the torch expansion needs (computed here so the
    grid is walked once per tile). All findings from this pass are errors;
    ``lang.Spec.__post_init__`` raises on any."""
    findings = []
    k = len(spec.grid) - len(spec.reduce_axes)
    zero_r = (0,) * len(spec.reduce_axes)

    input_reduce_invariant = []
    tab_findings = _table_findings(spec)
    if tab_findings:
        return tab_findings, input_reduce_invariant
    for t in spec.inputs:
        blk = t.resolved_block()
        idx = t.resolved_index(spec.grid)
        nb = tuple(s // bb for s, bb in zip(t.shape, blk))
        gax = None if t.index_tile is None else t.index_tile[1]
        for ax, (r, s) in enumerate(zip(t.resolved_halo(), t.shape)):
            # a radius past the array extent would wrap more than one full
            # period (or clamp a window wider than the data): certainly a
            # mis-sized stencil, on every backend
            if r > s:
                findings.append(Finding(
                    "BOUNDS_HALO", spec.name, t.name,
                    f"input tile {t.name!r}: halo radius {r} on axis {ax} "
                    f"exceeds the array extent {s} — the fetched window "
                    "would span more than one full period of the data"))
                return findings, input_reduce_invariant
        if _identity_cover(spec, t, nb):
            input_reduce_invariant.append(True)
            continue
        inv = True
        bi0 = None
        for cell in np.ndindex(*spec.grid):
            bi = tuple(int(i) for i in idx(*cell))
            if gax is not None and len(bi) == len(nb):
                # the static map's value at the gathered axis is an ignored
                # placeholder: the run-time table value is clamped in-range
                # by construction, so only the other axes are bounds-checked
                bi = bi[:gax] + (0,) + bi[gax + 1:]
            if len(bi) != len(nb) or any(
                    not (0 <= i < n) for i, n in zip(bi, nb)):
                findings.append(Finding(
                    "BOUNDS_INDEX", spec.name, t.name,
                    f"input tile {t.name!r}: index map returned block "
                    f"{bi} for grid cell {cell}, outside the {nb} block "
                    f"grid (shape {t.shape}, block {blk}; "
                    f"{_bounds_detail(bi, nb)})"))
                return findings, input_reduce_invariant
            if inv and spec.reduce_axes:
                # C-order walk: each outer group starts at reduce ids 0, so
                # that cell's bi IS the group's reference
                if cell[k:] == zero_r:
                    bi0 = bi
                elif bi != bi0:
                    inv = False
        input_reduce_invariant.append(inv)

    # a gathered tile's block index is only reduce-invariant when its own
    # static map AND the table it reads are: a table indexed by a reduce id
    # (the paged block walk) makes the gather a fresh fetch every step
    name_to_i = {t.name: i for i, t in enumerate(spec.inputs)}
    for i, t in enumerate(spec.inputs):
        if t.index_tile is not None:
            ti = name_to_i[t.index_tile[0]]
            input_reduce_invariant[i] = (
                input_reduce_invariant[i] and input_reduce_invariant[ti])

    for i, s in enumerate(spec.scratch):
        if any(d <= 0 for d in s.shape):
            findings.append(Finding(
                "BOUNDS_SCRATCH", spec.name, f"scratch[{i}]",
                f"scratch[{i}]: shape {s.shape} has a non-positive "
                "dimension"))

    # Per-output reduce granularity: an output accumulates over SOME of the
    # reduce axes (all by default; none when streamed) and its index map may
    # depend only on the REMAINING axes. Distinct (outer x non-accumulated)
    # cells must write distinct blocks, covering every block exactly once.
    for t in spec.outputs:
        blk = t.resolved_block()
        idx = t.resolved_index(spec.grid)
        nb = tuple(s // b for s, b in zip(t.shape, blk))
        nblocks = math.prod(nb)
        slot_axes = spec.output_slot_axes(t)
        kind = "stream output" if t.stream else "output"
        if _identity_cover(spec, t, nb):
            continue
        seen: dict[tuple, tuple] = {}
        visited: set[tuple] = set()
        for cell in np.ndindex(*spec.grid):
            bi = tuple(int(i) for i in idx(*cell))
            if len(bi) != len(nb) or any(
                    not (0 <= i < n) for i, n in zip(bi, nb)):
                findings.append(Finding(
                    "BOUNDS_INDEX", spec.name, t.name,
                    f"{kind} tile {t.name!r}: index map returned block "
                    f"{bi} for grid cell {cell}, outside the {nb} block "
                    f"grid (shape {t.shape}, block {blk}; "
                    f"{_bounds_detail(bi, nb)})"))
                return findings, input_reduce_invariant
            key = cell[:k] + tuple(cell[a] for a in slot_axes)
            if key in seen:
                if seen[key] != bi:
                    findings.append(Finding(
                        "SEMANTICS_ACC_INDEX", spec.name, t.name,
                        f"output tile {t.name!r}: index map depends on reduce "
                        f"axes it accumulates over (cell {cell} -> {bi}, "
                        f"expected {seen[key]}); exclude those axes via "
                        "Tile(reduce=...) or stream=True"))
                    return findings, input_reduce_invariant
            else:
                if bi in visited:
                    hint = ("streamed outputs must write a distinct block "
                            "per grid cell" if t.stream else
                            "grid-carried accumulation needs an explicit "
                            "reduce axis (Spec(reduce_axes=...) + "
                            "Tile(reduce=...)) — implicit revisits are "
                            "rejected")
                    findings.append(Finding(
                        "RACE_PARALLEL_WRITE", spec.name, t.name,
                        f"{kind} tile {t.name!r} block {bi} visited more "
                        f"than once by distinct cells; {hint}"))
                    return findings, input_reduce_invariant
                seen[key] = bi
                visited.add(bi)
        if len(seen) != nblocks:
            findings.append(Finding(
                "COVERAGE_UNWRITTEN", spec.name, t.name,
                f"{kind} tile {t.name!r}: {len(seen)} blocks visited but "
                f"{nblocks} exist; kernel would leave garbage"))
            return findings, input_reduce_invariant

    findings.extend(check_shard_binding(spec))
    return findings, input_reduce_invariant


def check_shard_binding(spec):
    """Cross-shard semantics of a ShardAxis binding over the MESH-EXTENDED
    grid: the local grid replicated ``extent`` times along the bound reduce
    axis, one replica per device.

    Two hazards a single-shard walk cannot see: an output that ACCUMULATES
    over the bound axis holds a per-shard partial, and without a declared
    collective the partials never meet (``COLLECTIVE_UNDECLARED``); an
    output whose index map SELECTS along the bound axis writes blocks owned
    by other shards as data rotates, a write race over the extended grid
    unless the output is declared in ``sharded_outputs``
    (``RACE_MESH_WRITE``)."""
    sh = getattr(spec, "shard", None)
    if sh is None or sh.extent <= 1:
        return []
    findings = []
    if sh.collective == "ppermute" and not sh.rotate:
        findings.append(Finding(
            "COLLECTIVE_UNDECLARED", spec.name, "",
            f"shard axis {sh.axis} on mesh axis {sh.mesh_axis!r} declares a "
            "ppermute ring but rotates no input tiles — no data ever "
            "crosses shards, so the ring reduces over the same local chunk "
            f"{sh.extent} times"))
    for t in spec.outputs:
        acc = spec.output_reduce_axes(t)
        if sh.axis in acc:
            if sh.collective is None:
                findings.append(Finding(
                    "COLLECTIVE_UNDECLARED", spec.name, t.name,
                    f"output tile {t.name!r} accumulates over shard axis "
                    f"{sh.axis} ({sh.extent} shards on mesh axis "
                    f"{sh.mesh_axis!r}) but the binding declares no "
                    "collective — per-shard partials would never be "
                    "combined"))
        elif sh.axis in spec.output_slot_axes(t):
            if t.name not in sh.sharded_outputs:
                findings.append(Finding(
                    "RACE_MESH_WRITE", spec.name, t.name,
                    f"output tile {t.name!r} selects blocks along shard "
                    f"axis {sh.axis}: all {sh.extent} shards on mesh axis "
                    f"{sh.mesh_axis!r} write the same local block "
                    "coordinates for different chunks of the data — a "
                    "cross-shard write race unless the output is declared "
                    "in ShardAxis.sharded_outputs (partials ride the "
                    "collective back to their owner)"))
    return findings


def check_semantics(spec):
    """``dimension_semantics`` consistency: an axis marked ``"parallel"``
    (free to be reordered) must not carry sequential state along it."""
    sem = getattr(spec, "dimension_semantics", None)
    if not sem:
        return []
    findings = []
    for a, s in enumerate(sem):
        if s != "parallel" or a not in spec.reduce_axes:
            continue
        carried = ["scratch"] if spec.scratch else []
        carried += [f"output {t.name!r}" for t in spec.outputs
                    if a in spec.output_reduce_axes(t)]
        if carried:
            findings.append(Finding(
                "SEMANTICS_PARALLEL_CARRIED", spec.name, f"axis {a}",
                f"dimension_semantics marks reduce axis {a} \"parallel\" "
                f"but {', '.join(carried)} carries a sequential dependence "
                "along it (its reduce_id feeds carried state); declare the "
                "axis \"arbitrary\""))
    return findings


# ---------------------------------------------------------------------------
# The body pass: a recording run of the body on meta tensors
# ---------------------------------------------------------------------------

class _Opaque:
    """A predicate the analyzer cannot prove (of grid ids or data, or any
    boolean algebra over symbolic tokens). Opaque guards may skip."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __and__(self, other):
        return self

    __rand__ = __or__ = __ror__ = __xor__ = __rxor__ = __and__

    def __invert__(self):
        return self

    def __repr__(self):
        return "<opaque predicate>"


_OPAQUE = _Opaque()


class _Pred:
    """A symbolic predicate token: the analyzer knows exactly when it holds
    (``("is_first",)``, ``("reduce_first", d)``, ...). Any algebra over it
    degrades to opaque: conservative, never unsound."""

    __slots__ = ("key",)

    def __init__(self, key):
        self.key = key

    def __and__(self, other):
        return _OPAQUE

    __rand__ = __or__ = __ror__ = __xor__ = __rxor__ = __and__

    def __invert__(self):
        return _OPAQUE

    def __bool__(self):
        raise TypeError(
            f"predicate {self.key} is symbolic under analysis (and a tensor "
            "in the torch expansion): use ctx.when/ctx.cell_when, not a "
            "Python `if`")

    def __repr__(self):
        return f"<pred {self.key}>"


@dataclasses.dataclass(frozen=True)
class _Event:
    op: str       # "read" | "write"
    kind: str     # "input" | "output" | "scratch"
    name: str
    ctx: tuple    # the predicate tags active at the access


_META = torch.device("meta")


class _RecRef:
    """A recording TileRef: the same read/write surface, every access
    logged with the active predicate context, over a meta tensor so the
    body keeps running."""

    __slots__ = ("_trace", "kind", "name", "_value")

    def __init__(self, trace, kind, name, value):
        self._trace = trace
        self.kind = kind
        self.name = name
        self._value = value

    def __getitem__(self, idx):
        self._trace.record("read", self)
        return self._value[idx]

    def __setitem__(self, idx, val):
        self._trace.record("write", self)
        v = self._value
        val = val.to(v.dtype) if torch.is_tensor(val) else torch.as_tensor(
            val, dtype=v.dtype, device=_META)
        if idx is Ellipsis or idx == (Ellipsis,) or idx == slice(None):
            self._value = torch.broadcast_to(val, v.shape)
        else:
            v = v.clone()
            v[idx] = val
            self._value = v

    @property
    def value(self):
        self._trace.record("read", self)
        return self._value

    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def device(self):
        return _META


class _RecCtx:
    """A recording Ctx: :class:`lang.Ctx`'s surface, with the reduce
    position predicates as symbolic tokens and ``when``/``cell_when``
    running their thunk unconditionally while the classified predicate is
    on the context stack. Grid ids are 0-dim int32 meta tensors, so a
    predicate of them stays opaque rather than folding for one cell.
    Backend flags are all False (a body that branches on the backend is
    traced on its generic path)."""

    backend = "analyze"
    is_torch = is_loops = False
    device = _META

    def __init__(self, trace, spec, defines, gids):
        self._trace = trace
        self.D = defines
        self._gids = tuple(gids)
        self.grid = spec.grid
        self._reduce_axes = tuple(spec.reduce_axes)
        self.scratch = ()

    def outer_id(self, d: int):
        return self._gids[d]

    def outer_dim(self, d: int) -> int:
        return self.grid[d]

    def reduce_id(self, d: int = 0):
        return self._gids[self._reduce_axes[d]]

    def reduce_dim(self, d: int = 0) -> int:
        return self.grid[self._reduce_axes[d]]

    def reduce_first(self, d: int = 0):
        return _Pred(("reduce_first", int(d)))

    def reduce_last(self, d: int = 0):
        return _Pred(("reduce_last", int(d)))

    @property
    def is_first(self):
        return True if not self._reduce_axes else _Pred(("is_first",))

    @property
    def is_last(self):
        return True if not self._reduce_axes else _Pred(("is_last",))

    def when(self, pred):
        return self._trace.guard(pred, "when")

    def cell_when(self, pred):
        return self._trace.guard(pred, "cell_when")

    def lane_ids(self, n: int):
        return torch.arange(n, device=_META)

    def barrier(self, *_fence):
        return None

    def cache(self, ref):
        return ref[...]

    def private(self, value):
        return value


def _classify(pred):
    """A guard's tag: None (always runs), False (never runs), a symbolic
    key, or None-or-False of a host value; "opaque" for the rest."""
    if isinstance(pred, _Pred):
        return pred.key
    if isinstance(pred, (bool, np.bool_)):
        return None if pred else False
    if pred is _OPAQUE:
        return "opaque"
    try:  # concrete scalars fold like Python bools...
        return None if bool(pred) else False
    except Exception:  # ...meta tensors (grid ids, data) are opaque
        return "opaque"


class _Trace:
    """The event log and predicate-context stack of one body run."""

    def __init__(self):
        self.events: list[_Event] = []
        self._stack: list[tuple] = []
        self._serial = itertools.count()

    def record(self, op, ref):
        self.events.append(_Event(op, ref.kind, ref.name, tuple(self._stack)))

    def guard(self, pred, kind):
        """when/cell_when under analysis: classify the predicate, push it,
        run the thunk unconditionally (every guarded path is traced),
        pop."""
        tag = _classify(pred)
        if tag == "opaque":
            tag = (kind, next(self._serial))

        def deco(fn):
            if tag is False:
                return fn
            if tag is not None:
                self._stack.append(tag)
            try:
                fn()
            finally:
                if tag is not None:
                    self._stack.pop()
            return fn

        return deco


def _run_recorded(spec, defines, trace):
    """One body run on meta tensors of the block shapes under ``trace``."""
    gids = [torch.zeros((), dtype=torch.int32, device=_META)
            for _ in spec.grid]
    ctx = _RecCtx(trace, spec, defines, gids)
    ins = [_RecRef(trace, "input", t.name,
                   torch.empty(t.body_block(), dtype=t.dtype, device=_META))
           for t in spec.inputs]
    outs = [_RecRef(trace, "output", t.name,
                    torch.empty(t.resolved_block(), dtype=t.dtype,
                                device=_META))
            for t in spec.outputs]
    ctx.scratch = tuple(
        _RecRef(trace, "scratch", f"scratch[{i}]",
                torch.empty(s.shape, dtype=s.dtype, device=_META))
        for i, s in enumerate(spec.scratch))
    spec.body(ctx, *ins, *outs)


def trace_body(spec, defines=None):
    """Run the body once on meta tensors with a recording ctx and refs;
    returns the ordered read/write event log. No memory is touched and
    nothing is computed."""
    trace = _Trace()
    _run_recorded(spec, defines if defines is not None else SimpleNamespace(),
                  trace)
    return trace.events


def _guaranteed(ctx_tags, allowed) -> bool:
    """True if an access under these tags is certain to run whenever every
    predicate in ``allowed`` holds (every guard around it is provable)."""
    return all(tag in allowed for tag in ctx_tags)


def _first_last_sets(spec, t):
    """The predicate tags certain to hold on an output block's first and
    last visit: ``reduce_first(d)`` / ``reduce_last(d)`` for the axes it
    accumulates over, plus ``is_first`` / ``is_last`` when those are the
    whole reduce space."""
    acc = set(spec.output_reduce_axes(t))
    n_red = len(spec.reduce_axes)
    first = {("reduce_first", d) for d, a in enumerate(spec.reduce_axes)
             if a in acc}
    last = {("reduce_last", d) for d, a in enumerate(spec.reduce_axes)
            if a in acc}
    if n_red == 0 or acc == set(spec.reduce_axes):
        first.add(("is_first",))
        last.add(("is_last",))
    return first, last


_SCRATCH_FIRST_BASE = frozenset([("is_first",)])


def check_body(spec, events):
    """Liveness and coverage verdicts from one body trace."""
    findings = []
    n_red = len(spec.reduce_axes)
    scratch_first = set(_SCRATCH_FIRST_BASE) | {
        ("reduce_first", d) for d in range(n_red)}

    def read_before_init(name, firstset, code, what):
        """Walk the ref's events in order: a read is safe once a write
        certain on the first visit has happened, or when an earlier write
        dominates it within the same guarded region (its tags are a subset
        of the read's)."""
        init = False
        prior_writes: list[frozenset] = []
        for ev in events:
            if ev.name != name:
                continue
            if ev.op == "write":
                if _guaranteed(ev.ctx, firstset):
                    init = True
                prior_writes.append(frozenset(ev.ctx))
            elif not init:
                rc = set(ev.ctx)
                if any(w <= rc for w in prior_writes):
                    continue
                findings.append(Finding(code, spec.name, name, what(ev)))
                return

    for i, _s in enumerate(spec.scratch):
        name = f"scratch[{i}]"
        read_before_init(
            name, scratch_first, "LIVENESS_SCRATCH_UNINIT",
            lambda ev, name=name: (
                f"{name} is read (context {list(ev.ctx) or 'unconditional'}) "
                "before any write guaranteed on the first reduce visit; "
                "first-visit scratch contents are undefined in a "
                "hand-written kernel: initialize under "
                "ctx.when(ctx.is_first) / ctx.reduce_first"))

    for t in spec.outputs:
        firstset, lastset = _first_last_sets(spec, t)
        evs = [ev for ev in events if ev.kind == "output" and ev.name == t.name]
        if not evs:
            continue  # never touched: the grid walk already flags UNWRITTEN
        writes = [ev for ev in evs if ev.op == "write"]
        has_init = any(_guaranteed(ev.ctx, firstset) for ev in writes)
        has_flush = any(_guaranteed(ev.ctx, lastset) for ev in writes)
        if writes and not (has_init or has_flush):
            ctxs = sorted({str(list(ev.ctx)) for ev in writes})
            findings.append(Finding(
                "COVERAGE_SKIP_NO_INIT", spec.name, t.name,
                f"output tile {t.name!r} is only written under skippable "
                f"predicates ({', '.join(ctxs)}): a block whose guards all "
                "skip is left undefined in a hand-written kernel "
                "(zero-filled only on torch/loops). Add a guaranteed init "
                "(ctx.is_first / ctx.reduce_first) or flush (ctx.is_last / "
                "ctx.reduce_last)"))
        read_before_init(
            t.name, firstset, "COVERAGE_SKIP_NO_INIT",
            lambda ev, t=t: (
                f"output tile {t.name!r} is read (context "
                f"{list(ev.ctx) or 'unconditional'}) before any write "
                "guaranteed on its block's first visit; first-visit output "
                "contents are undefined in a hand-written kernel: "
                "initialize under ctx.reduce_first of an accumulated axis"))

    return findings


# ---------------------------------------------------------------------------
# The cost model: shared-memory footprint, bytes moved, FLOPs
# ---------------------------------------------------------------------------

#: Shared memory a block may use on the H100 (the 227 KB opt-in limit of
#: sm_90, ``kernels.apps._common.SMEM_MAX``); override with
#: ``$REPRO_SMEM_BUDGET`` (plain bytes or a K/M/G suffix).
DEFAULT_SMEM_BUDGET = 232448

#: Fraction of the budget above which FOOTPRINT_NEAR_LIMIT warns.
NEAR_LIMIT_FRAC = 0.8

#: Grid sizes past this are not walked cell by cell; bytes fall back to the
#: every-visit-fetches upper bound and REDUNDANT_FETCH is not looked for.
WALK_CELL_LIMIT = 1 << 20

#: The footprint's findings (``Device.build_kernel`` reports them without
#: raising on the cuda backend, whose binding checks the kernel's own
#: shared memory).
FOOTPRINT_CODES = frozenset(["SMEM_OVERFLOW", "FOOTPRINT_NEAR_LIMIT"])


def smem_budget() -> int:
    """The shared-memory budget of a block: ``$REPRO_SMEM_BUDGET`` (bytes,
    or with a K/M/G suffix, e.g. ``96K``), else
    :data:`DEFAULT_SMEM_BUDGET`."""
    raw = os.environ.get("REPRO_SMEM_BUDGET", "").strip()
    if not raw:
        return DEFAULT_SMEM_BUDGET
    mult = {"K": 2**10, "M": 2**20, "G": 2**30}.get(raw[-1].upper(), 1)
    digits = raw[:-1] if mult != 1 else raw
    try:
        val = int(digits) * mult
    except ValueError:
        raise ValueError(
            f"REPRO_SMEM_BUDGET={raw!r} is not a byte count (use plain "
            "bytes or a K/M/G suffix, e.g. 227K)") from None
    if val <= 0:
        raise ValueError(f"REPRO_SMEM_BUDGET={raw!r} must be positive")
    return val


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def smem_footprint(spec) -> tuple[int, dict]:
    """Bytes a grid cell keeps resident, by the JAX package's rule: every
    tile's block (twice when the grid has more than one cell and the tile
    is blocked, for the copy of the next block in flight) plus scratch.
    No grid walk: cheap enough for every build."""
    ncells = math.prod(spec.grid) if spec.grid else 1
    detail = {}
    for t in list(spec.inputs) + list(spec.outputs):
        blk = t.resolved_block()
        # the body sees the block grown by any halo fringe
        nbytes = math.prod(t.body_block()) * _itemsize(t.dtype)
        mult = 1 if (ncells == 1 or blk == tuple(t.shape)) else 2
        detail[t.name] = nbytes * mult
    for i, s in enumerate(spec.scratch):
        detail[f"scratch[{i}]"] = math.prod(s.shape) * _itemsize(s.dtype)
    return sum(detail.values()), detail


def _footprint_findings(spec, *, budget=None):
    """SMEM_OVERFLOW / FOOTPRINT_NEAR_LIMIT findings for one spec."""
    budget = smem_budget() if budget is None else int(budget)
    total, detail = smem_footprint(spec)
    top = ", ".join(f"{k}={v}" for k, v in sorted(
        detail.items(), key=lambda kv: -kv[1])[:4])
    if total > budget:
        return [Finding(
            "SMEM_OVERFLOW", spec.name, "",
            f"static shared-memory footprint {total} B exceeds the budget "
            f"{budget} B (largest blocks: {top}); shrink tile blocks or "
            "raise $REPRO_SMEM_BUDGET")]
    if total > NEAR_LIMIT_FRAC * budget:
        return [Finding(
            "FOOTPRINT_NEAR_LIMIT", spec.name, "",
            f"static shared-memory footprint {total} B is above "
            f"{int(NEAR_LIMIT_FRAC * 100)}% of the budget {budget} B "
            f"(largest blocks: {top})")]
    return []


def _runs(seq) -> int:
    """Number of maximal runs of equal consecutive elements."""
    it = iter(seq)
    try:
        prev = next(it)
    except StopIteration:
        return 0
    n = 1
    for x in it:
        if x != prev:
            n += 1
            prev = x
    return n


def _sweep_refetches(sweep) -> bool:
    """True if one outer cell's ordered reduce sweep ``[(rcell, bi), ...]``
    fetches again a block it already held, leaving out the re-reads an
    interleaved independent axis causes (blocked-GEMM reuse): axis ``p`` is
    dependent for the tile if two entries differing only at ``p`` map to
    different blocks; entries are grouped by the other axes' ids, and a
    group whose block sequence has more runs than distinct blocks dropped
    a block it fetches again."""
    if len(sweep) < 2:
        return False
    nred = len(sweep[0][0])
    dep = set()
    for p in range(nred):
        seen = {}
        for rcell, bi in sweep:
            key = rcell[:p] + rcell[p + 1:]
            if key in seen:
                if seen[key] != bi:
                    dep.add(p)
                    break
            else:
                seen[key] = bi
    groups = {}
    for rcell, bi in sweep:
        gkey = tuple(v for q, v in enumerate(rcell) if q not in dep)
        groups.setdefault(gkey, []).append(bi)
    return any(_runs(seq) > len(set(seq)) for seq in groups.values())


def _walk_costs(spec):
    """One C-order walk of the concrete grid: each tile's runs of one
    block -> device-memory bytes (a repeated block index is not fetched
    again), and REDUNDANT_FETCH on inputs whose reduce sweep fetches again
    a block it already held; an accumulated output block revisited after
    moving off it is also read back."""
    grid = tuple(spec.grid)
    reduce_axes = tuple(spec.reduce_axes)
    outer_axes = [d for d in range(len(grid)) if d not in reduce_axes]
    findings = []
    bytes_in = 0
    bytes_out = 0

    cells = [tuple(int(g) for g in c) for c in np.ndindex(*grid)] \
        if grid else [()]

    for t in spec.inputs:
        idx = t.resolved_index(grid)
        # a halo tile fetches the overlapped window, not the bare block
        blk_bytes = math.prod(t.body_block()) * _itemsize(t.dtype)
        if t.index_tile is not None:
            # a gathered block index is run-time data: every visiting cell
            # is charged a fetch, and REDUNDANT_FETCH (a static walk) skips it
            bytes_in += len(cells) * blk_bytes
            continue
        walk = [tuple(idx(*c)) for c in cells]
        bytes_in += _runs(walk) * blk_bytes
        if reduce_axes and len(cells) > 1:
            sweeps = {}
            for c, bi in zip(cells, walk):
                ocell = tuple(c[d] for d in outer_axes)
                rcell = tuple(c[a] for a in reduce_axes)
                sweeps.setdefault(ocell, []).append((rcell, bi))
            if any(_sweep_refetches(sw) for sw in sweeps.values()):
                findings.append(Finding(
                    "REDUNDANT_FETCH", spec.name, t.name,
                    f"input tile {t.name!r}: the reduce sweep re-fetches a "
                    "block it already held — the index map revisits a block "
                    "after moving off it. Reorder the reduce walk or hoist "
                    "the tile (a reduce-invariant map is hoisted "
                    "automatically by the torch expansion)"))

    for t in spec.outputs:
        idx = t.resolved_index(grid)
        blk_bytes = math.prod(t.resolved_block()) * _itemsize(t.dtype)
        walk = [tuple(idx(*c)) for c in cells]
        runs = _runs(walk)
        bytes_out += runs * blk_bytes
        if spec.output_reduce_axes(t):
            bytes_in += max(0, runs - len(set(walk))) * blk_bytes

    return bytes_in, bytes_out, findings


# -- FLOPs from a body run on meta tensors ----------------------------------
#
# The JAX package counts from a jaxpr: 2 out x contraction for dot_general,
# one an output element for float elementwise primitives, one an input
# element for reductions, 0 for data movement, casts and select. The same
# classes over aten ops:

_MATMUL_OPS = frozenset(["mm", "bmm", "matmul", "dot", "mv", "addmm",
                         "baddbmm"])

_ELEMENTWISE_OPS = frozenset([
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "maximum",
    "minimum", "pow", "neg", "abs", "sign", "exp", "exp2", "expm1", "log",
    "log1p", "log2", "tanh", "sigmoid", "rsqrt", "sqrt", "reciprocal",
    "erf", "erfc", "sin", "cos", "tan", "atan2", "floor", "ceil", "round",
    "trunc", "nextafter", "clamp", "clamp_min", "clamp_max", "square",
    "softplus", "addcmul", "addcdiv"])

_REDUCE_OPS = frozenset(["sum", "amax", "amin", "max", "min", "prod",
                         "cumsum", "cumprod", "cummax", "cummin",
                         "logcumsumexp", "mean"])


def _is_float_t(t) -> bool:
    return torch.is_tensor(t) and (t.dtype.is_floating_point
                                   or t.dtype.is_complex)


def _first_tensor(xs):
    for x in xs:
        if torch.is_tensor(x):
            return x
    return None


def _op_flops(func, args, out) -> int:
    """FLOPs of one aten call by the JAX package's classes."""
    name = func._overloadpacket.__name__.rstrip("_")
    outs = out if isinstance(out, (tuple, list)) else (out,)
    o = _first_tensor(outs)
    if name in _MATMUL_OPS:
        a = args[1] if name in ("addmm", "baddbmm") else args[0]
        k = a.shape[-1] if a.dim() else 1
        n = 2 * (o.numel() if o is not None else 1) * k
        if name in ("addmm", "baddbmm"):   # the accumulate: one an element
            n += o.numel()
        return n
    if name in _ELEMENTWISE_OPS:
        return o.numel() if _is_float_t(o) else 0
    if name in _REDUCE_OPS:
        src = _first_tensor(args)
        if not _is_float_t(src):
            return 0
        n = src.numel()
        if name == "mean":   # reduce_sum, then a divide an output element
            n += o.numel() if o is not None else 1
        return n
    return 0


def _flop_mode():
    """A ``TorchDispatchMode`` that sums :func:`_op_flops` (built on first
    use: nothing of torch's dispatch machinery runs at import)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Flops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.total += _op_flops(func, args, out)
            return out

    return _Flops()


class _CostTrace:
    """A :class:`_Trace` for counting FLOPs: guarded regions get stable ids
    (the path of guard indices at each nesting level), so one region keeps
    its id across body runs with different enabled sets. ``enabled=None``
    (discovery) runs every symbolic region; otherwise only regions whose
    path is in the set run. ``record`` does nothing."""

    def __init__(self, enabled=None):
        self._enabled = enabled
        self._counters = [itertools.count()]
        self._path: tuple = ()
        self.regions: list[tuple[tuple, tuple]] = []   # (path, tag)

    def record(self, op, ref):
        pass

    def _run(self, path, fn):
        self._path = path
        self._counters.append(itertools.count())
        try:
            fn()
        finally:
            self._counters.pop()
            self._path = self._path[:-1]

    def guard(self, pred, kind):
        path = self._path + (next(self._counters[-1]),)
        tag = _classify(pred)
        if tag == "opaque":
            tag = ("opaque",)

        def deco(fn):
            if tag is False:
                return fn
            if tag is None:  # unconditional: run, keeping nested ids stable
                self._run(path, fn)
                return fn
            self.regions.append((path, tag))
            if self._enabled is None or path in self._enabled:
                self._run(path, fn)
            return fn

        return deco


def _region_weight(spec, tag) -> float:
    """Share of grid cells a guarded region runs on: a symbolic first/last
    predicate one cell of its reduce space; an opaque (data-dependent)
    guard counts in full, an upper bound."""
    red = tuple(spec.reduce_grid)
    if tag == ("is_first",) or tag == ("is_last",):
        return 1.0 / max(1, math.prod(red))
    if isinstance(tag, tuple) and len(tag) == 2 and \
            tag[0] in ("reduce_first", "reduce_last"):
        return 1.0 / max(1, red[tag[1]])
    return 1.0


def estimate_flops(spec, defines=None):
    """FLOPs of one spec: the body is run on meta tensors under a FLOP
    counting dispatch mode once per (ancestor-closed) set of enabled
    guarded regions; each region's marginal FLOPs are weighted by the
    share of cells its predicate holds on. None when the body cannot run
    on meta tensors."""
    defines = defines if defines is not None else SimpleNamespace()

    def flops_of(trace):
        mode = _flop_mode()
        with mode:
            _run_recorded(spec, defines, trace)
        return mode.total

    try:
        discovery = _CostTrace(None)
        flops_of(discovery)
        regions = discovery.regions
        memo: dict[frozenset, int] = {}

        def flops_with(enabled: frozenset) -> int:
            if enabled not in memo:
                memo[enabled] = flops_of(_CostTrace(enabled))
            return memo[enabled]

        per_cell = float(flops_with(frozenset()))
        for path, tag in regions:
            ancestors = frozenset(
                p for p, _t in regions
                if len(p) < len(path) and p == path[:len(p)])
            marginal = flops_with(ancestors | {path}) - flops_with(ancestors)
            weight = _region_weight(spec, tag)
            for p, t in regions:
                if len(p) < len(path) and p == path[:len(p)]:
                    weight *= _region_weight(spec, t)
            per_cell += weight * max(0, marginal)
        ncells = math.prod(spec.grid) if spec.grid else 1
        return int(round(ncells * per_cell))
    except Exception:
        return None


@dataclasses.dataclass
class CostReport:
    """Static roofline terms of one built spec."""

    spec: str
    grid: tuple
    cells: int
    smem_bytes: int
    smem_detail: dict
    smem_budget: int
    bytes_in: int
    bytes_out: int
    flops: int | None
    findings: list
    # interconnect bytes each shard sends over the whole schedule of the
    # declared ShardAxis (by tile in comm_detail); 0 without one
    comm_bytes: int = 0
    comm_detail: dict = dataclasses.field(default_factory=dict)

    @property
    def hbm_bytes(self) -> int:
        return self.bytes_in + self.bytes_out

    @property
    def smem_frac(self) -> float:
        return self.smem_bytes / self.smem_budget if self.smem_budget else 0.0

    @property
    def intensity(self) -> float | None:
        """FLOPs a device-memory byte (the roofline's x axis)."""
        if self.flops is None or not self.hbm_bytes:
            return None
        return self.flops / self.hbm_bytes

    def __str__(self):
        fl = "?" if self.flops is None else f"{self.flops:,}"
        ai = self.intensity
        return (f"{self.spec}: smem {self.smem_bytes:,} B "
                f"({self.smem_frac:.0%} of budget), hbm {self.hbm_bytes:,} B "
                f"(in {self.bytes_in:,} / out {self.bytes_out:,}), "
                f"flops {fl}"
                + (f", intensity {ai:.2f} flop/B" if ai is not None else "")
                + (f", comm {self.comm_bytes:,} B/shard"
                   if self.comm_bytes else ""))


def estimate_cost(spec, defines=None, *, budget=None,
                  walk: bool = True, flops: bool = True) -> CostReport:
    """The cost model of one built spec: footprint against the budget,
    device-memory bytes over the concrete grid walk, FLOPs from the body
    run. ``walk=False`` / ``flops=False`` skip the costly passes."""
    budget = smem_budget() if budget is None else int(budget)
    smem, detail = smem_footprint(spec)
    findings = _footprint_findings(spec, budget=budget)
    ncells = math.prod(spec.grid) if spec.grid else 1
    if walk and ncells <= WALK_CELL_LIMIT:
        bytes_in, bytes_out, fetch_findings = _walk_costs(spec)
        findings += fetch_findings
    else:
        # upper bound: every visit fetches its block and writes its output
        # block, except whole-array inputs, fetched once
        bytes_in = sum(
            (1 if (t.resolved_block() == tuple(t.shape)
                   and t.index_tile is None) else ncells)
            * math.prod(t.body_block()) * _itemsize(t.dtype)
            for t in spec.inputs)
        bytes_out = sum(
            ncells * math.prod(t.resolved_block()) * _itemsize(t.dtype)
            for t in spec.outputs)
    fl = estimate_flops(spec, defines) if flops else None
    comm, comm_detail = _comm_costs(spec)
    return CostReport(
        spec=spec.name, grid=tuple(spec.grid), cells=ncells,
        smem_bytes=smem, smem_detail=detail, smem_budget=budget,
        bytes_in=int(bytes_in), bytes_out=int(bytes_out), flops=fl,
        findings=findings, comm_bytes=comm, comm_detail=comm_detail)


def _comm_costs(spec):
    """Interconnect bytes a shard sends over the whole schedule of the
    declared ShardAxis (tile shapes are the local ones):

      ppermute       each rotated input hops extent - 1 times, and the
                     sharded outputs' partials ride the ring home as often
      psum           ring all-reduce: 2 (n - 1) / n of the array a shard
      psum_scatter   reduce-scatter: (n - 1) / n
    """
    sh = getattr(spec, "shard", None)
    if sh is None or sh.extent <= 1:
        return 0, {}
    n = sh.extent
    detail: dict[str, int] = {}
    tiles = {t.name: t for t in spec.inputs + spec.outputs}
    if sh.collective == "ppermute":
        for name in (*sh.rotate, *sh.sharded_outputs):
            t = tiles[name]
            b = (n - 1) * math.prod(t.shape) * _itemsize(t.dtype)
            detail[name] = detail.get(name, 0) + b
    elif sh.collective in ("psum", "psum_scatter"):
        hops = 2 * (n - 1) / n if sh.collective == "psum" else (n - 1) / n
        for t in spec.outputs:
            if sh.axis in spec.output_reduce_axes(t):
                b = math.prod(t.shape) * _itemsize(t.dtype)
                detail[t.name] = int(round(hops * b))
    return sum(detail.values()), detail


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _body_findings(spec, defines):
    try:
        events = trace_body(spec, defines)
    except Exception as e:  # a body the recorder cannot run on meta tensors
        return [Finding(
            "TRACE_INCOMPLETE", spec.name, "",
            f"body trace failed ({type(e).__name__}: {e}); liveness/"
            "coverage analysis skipped for this kernel")]
    return check_body(spec, events)


def analyze_spec(spec, defines=None, *, body=True, footprint=True) -> Report:
    """Every pass over one built Spec, raising nothing: grid invariants,
    semantics, (``footprint=True``) the shared-memory budget and
    (``body=True``) the body pass."""
    findings, _ = check_grid_invariants(spec)
    findings = list(findings)
    findings += check_semantics(spec)
    if footprint:
        findings += _footprint_findings(spec)
    if body and not findings:
        findings += _body_findings(spec, defines)
    return Report(spec.name, findings)


def check_built_spec(spec, defines=None, *, mode: str | None = None,
                     gate_footprint: bool = True) -> Report:
    """The build hook (``Device.build_kernel``): semantics, footprint and
    body pass, raised or warned by the strictness mode (the grid pass
    already ran when the Spec was made). ``gate_footprint=False`` (the
    cuda backend, whose binding checks the kernel's real shared memory)
    keeps a footprint finding in the returned report and neither raises
    nor warns of it."""
    mode = analysis_mode() if mode is None else mode
    if mode == "off":
        return Report(spec.name, [])
    findings = list(check_semantics(spec))
    footprint = _footprint_findings(spec)
    if gate_footprint:
        findings += footprint
    findings += _body_findings(spec, defines)
    Report(spec.name, findings).emit(mode)
    return Report(spec.name, findings + ([] if gate_footprint
                                         else footprint))
