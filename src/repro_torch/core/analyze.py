"""Static analysis of kernel-language specs: the grid pass (the
counterpart of the grid half of ``repro.core.analyze``).

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
axis that carries state (``SEMANTICS_PARALLEL_CARRIED``), which
``build_kernel`` runs after the builder.

The finding codes, their severities and the messages are the JAX
analyzer's. Its body trace (liveness and coverage of the body's writes)
and its cost model are not ported yet: no ``analyze=`` mode exists here.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

__all__ = [
    "ANALYZE_MODES",
    "AnalysisError",
    "AnalysisWarning",
    "Finding",
    "Report",
    "SEVERITY",
    "check_grid_invariants",
    "check_semantics",
    "check_shard_binding",
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
    "VMEM_OVERFLOW": "error",
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
