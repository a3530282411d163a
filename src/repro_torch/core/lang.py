"""The unified kernel language (the counterpart of ``repro.core.lang``).

One kernel source, a ``body(ctx, *tiles)`` function over blocks plus a
:class:`Spec` describing its grid and block structure, expands to three
backends, as the paper's macros expand one source to OpenMP, OpenCL and
CUDA:

  ``torch``  vectorised over the outer grid cells with ``torch.func.vmap``,
             sequential over the reduce steps (the JAX package's ``jnp``)
  ``loops``  one body call per grid cell in C order (the OpenMP expansion;
             ``cell_when`` is a real skip)
  ``cuda``   the spec's hand-written Hopper kernel, looked up by the spec's
             name in ``core.cuda``'s table (the JAX package's ``pallas``).
             The body does not run there; the kernel computes the same
             function, and the spec's defines are its launch arguments.

Keyword mapping (paper appendix tables -> this module) is the JAX
language's: ``occaOuterId`` is ``ctx.outer_id(d)``; ``occaInnerId``
``ctx.lane_ids(n)``; ``occaShared`` caching ``ctx.cache(ref)`` and
accumulators ``Spec(scratch=[Scratch(...)])``; ``occaBarrier``
``ctx.barrier()`` (a no-op: a block's body runs as one sequenced
program); a guarded ``occaOuterFor`` body ``ctx.cell_when(pred)``;
``occaPrivate`` ``ctx.private(x)``; ``occaCPU``/``occaGPU``
``ctx.is_torch``/``ctx.is_loops``; ``addDefine``/``buildKernel``
``Device.build_kernel(builder, defines)``. Reduce axes
(``Spec(reduce_axes=...)``, the trailing grid axes) are visited in order
and carry scratch and output blocks across their steps;
``Tile(reduce=axes)`` accumulates an output over a subset of them and
``stream=True`` over none; ``Tile(halo=, wrap=)`` fetches each block with
a periodic or edge-clamped fringe; ``Tile(index_tile=("table", axis))``
reads the block index along ``axis`` at run time from an integer input
tile (the paged-attention block table).

Reduction protocol: output and scratch blocks keep their contents across
the reduce visits of a block and are zero-filled on the first visit (on a
real accelerator they are undefined there, so bodies initialise under
``ctx.when(ctx.is_first)`` or ``ctx.reduce_first(d)``), and outputs flush
under ``ctx.when(ctx.is_last)``; an unconditional write is fine too, the
last visit wins.

Writing bodies for the torch expansion. The body runs under
``torch.func.vmap`` over the outer cells, so:

- refs are functional: ``ref[...]`` returns a copy of the block, and
  ``ref[idx] = v`` replaces the ref's value (``acc[...] += x`` works);
- outer ids are 0-dim tensors (reduce ids and the ``is_first`` family are
  Python values): arithmetic on them is fine, a Python ``if`` on them or
  ``.item()`` is not. ``when``/``cell_when`` on a tensor predicate select
  with ``torch.where`` over the tracked refs there and skip for real under
  ``loops``;
- a slice at an outer-id-dependent offset is an index (``x[bi * bn +
  ctx.lane_ids(bn)]``), not ``narrow``.

Index maps are plain Python functions of the grid ids, evaluated on the
host over the concrete grid; each tile's blocks are gathered into one
``(cells, *block)`` batch by advanced indexing (a reshape when the map is
the identity over the block grid). Restrictions (checked by the grid pass
of ``core.analyze`` when the Spec is built): blocks divide the array; an
output's index map does not depend on the reduce axes it accumulates over;
distinct (outer x non-accumulated reduce) cells write distinct blocks,
covering every block once.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = [
    "Tile",
    "Scratch",
    "ShardAxis",
    "Spec",
    "Ctx",
    "TileRef",
    "cdiv",
    "as_dtype",
    "defines_namespace",
    "expand",
    "BACKENDS",
]

BACKENDS = ("torch", "loops", "cuda")

_DTYPES = {n: getattr(torch, n) for n in (
    "float64", "float32", "float16", "bfloat16", "int64", "int32", "int16",
    "int8", "uint8", "bool")}


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or type, or its name
    (``"float32"``, ``"bfloat16"``, ``"torch.int32"``): the JAX defines
    carry dtype names, so builders pass them through here."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = (dtype.removeprefix("torch.") if isinstance(dtype, str)
            else np.dtype(dtype).name)
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}; expected one of "
                         f"{tuple(_DTYPES)}")
    return _DTYPES[name]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def defines_namespace(defines: dict | None) -> SimpleNamespace:
    return SimpleNamespace(**(defines or {}))


@dataclasses.dataclass(frozen=True)
class Tile:
    """One kernel argument: full array shape + its per-grid-cell block.

    ``block=None`` means the whole array is visible to every grid cell. The
    ``index`` map takes grid ids to *block* indices; ``None`` selects the
    identity map (requires ``len(grid) == ndim``) or the constant-zero map
    for whole-array tiles.

    ``halo=(r0, r1, ...)`` (INPUT tiles only, requires ``block=``) fetches
    each block with a per-axis fringe: the body sees a ``(b0 + 2 r0, b1 +
    2 r1, ...)`` window centred on the block, taken periodically
    (``wrap=True``) or edge-clamped (``wrap=False``); interior element
    ``(i, j)`` of the block is ``window[r0 + i, r1 + j]``.

    ``stream`` / ``reduce`` (outputs): the reduce axes the output
    accumulates over (``reduce=None``: all of them; ``stream=True`` or
    ``reduce=()``: none, each cell writes its own block).
    ``index_tile=("table", axis)`` (inputs): the block index along ``axis``
    is read at run time from the named integer input tile's element for the
    cell (its block must be all-ones), clamped to the block grid; the
    static map's value at ``axis`` is an ignored placeholder.
    """

    name: str
    shape: tuple[int, ...]
    dtype: object
    block: tuple[int, ...] | None = None
    index: Callable[..., tuple] | None = None
    stream: bool = False
    reduce: tuple[int, ...] | None = None
    halo: tuple[int, ...] | None = None
    wrap: bool = True
    index_tile: tuple[str, int] | None = None

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "dtype", as_dtype(self.dtype))
        if self.block is not None:
            object.__setattr__(self, "block",
                               tuple(int(b) for b in self.block))

    def resolved_block(self) -> tuple[int, ...]:
        blk = tuple(self.shape) if self.block is None else tuple(self.block)
        if len(blk) != len(self.shape):
            raise ValueError(
                f"tile {self.name!r}: block rank {len(blk)} != array rank {len(self.shape)}")
        for s, b in zip(self.shape, blk):
            if b <= 0 or s % b != 0:
                raise ValueError(
                    f"tile {self.name!r}: block {blk} does not divide shape {self.shape}")
        return blk

    def resolved_halo(self) -> tuple[int, ...]:
        """Validated per-axis halo radii ((0,)*ndim when no halo)."""
        if self.halo is None:
            return (0,) * len(self.shape)
        halo = tuple(int(r) for r in self.halo)
        if len(halo) != len(self.shape):
            raise ValueError(
                f"tile {self.name!r}: halo rank {len(halo)} != array rank "
                f"{len(self.shape)}")
        if any(r < 0 for r in halo):
            raise ValueError(f"tile {self.name!r}: negative halo radius {halo}")
        if self.block is None and any(halo):
            raise ValueError(
                f"tile {self.name!r}: halo= requires a blocked tile (block=); "
                "a whole-array tile already sees every element")
        return halo

    def body_block(self) -> tuple[int, ...]:
        """The block shape the BODY sees: the resolved block grown by the
        halo fringe (``resolved_block()`` for halo-free tiles)."""
        return tuple(b + 2 * r
                     for b, r in zip(self.resolved_block(),
                                     self.resolved_halo()))

    def resolved_index(self, grid: tuple[int, ...]) -> Callable[..., tuple]:
        if self.index is not None:
            return self.index
        blk = self.resolved_block()
        if blk == tuple(self.shape):  # whole-array tile
            ndim = len(self.shape)
            return lambda *gids: (0,) * ndim
        if len(grid) != len(self.shape):
            raise ValueError(
                f"tile {self.name!r}: no index map and grid rank {len(grid)} != "
                f"array rank {len(self.shape)}; pass index= explicitly")
        return lambda *gids: gids


@dataclasses.dataclass(frozen=True)
class Scratch:
    """A scratch buffer (occaShared accumulator analogue), handed to the
    body via ``ctx.scratch``; it persists across the sequential visits of
    the reduce space (the torch and loops expansions carry it)."""

    shape: tuple[int, ...]
    dtype: object = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "dtype", as_dtype(self.dtype))


SHARD_COLLECTIVES = (None, "ppermute", "psum", "psum_scatter")


@dataclasses.dataclass(frozen=True)
class ShardAxis:
    """A grid reduce axis that lives ACROSS devices on a named mesh axis.

    The spec's grid stays the per-shard (local) grid; ``extent`` says how
    many shards the bound reduce axis spans, and ``collective`` how the
    per-shard partials meet: ``"ppermute"`` (a ring: the ``rotate`` input
    tiles hop to the next shard after each step; outputs that select along
    the bound axis are declared in ``sharded_outputs``), ``"psum"``,
    ``"psum_scatter"``, or ``None`` (nothing crosses shards). The checks
    here are structural; ``core.analyze.check_shard_binding`` adds the
    cross-shard race and collective checks. The expansions run the local
    grid: the schedule across devices is not ported yet.
    """

    mesh_axis: str
    axis: int
    extent: int = 1
    collective: str | None = "ppermute"
    rotate: tuple[str, ...] = ()
    sharded_outputs: tuple[str, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "axis", int(self.axis))
        object.__setattr__(self, "extent", int(self.extent))
        object.__setattr__(self, "rotate", tuple(self.rotate))
        object.__setattr__(self, "sharded_outputs",
                           tuple(self.sharded_outputs))
        if not self.mesh_axis or not isinstance(self.mesh_axis, str):
            raise ValueError("ShardAxis.mesh_axis must be a mesh axis name")
        if self.extent < 1:
            raise ValueError(f"ShardAxis.extent must be >= 1, got {self.extent}")
        if self.collective not in SHARD_COLLECTIVES:
            raise ValueError(
                f"ShardAxis.collective {self.collective!r} unknown "
                f"(one of {SHARD_COLLECTIVES})")


@dataclasses.dataclass
class Spec:
    """A built kernel: grid + tiles + body, produced by a ``builder(D)``
    call. ``reduce_axes`` marks trailing grid axes as sequential reduction
    axes; ``scratch`` declares accumulators that persist across them.
    Construction runs the grid pass of ``core.analyze`` and raises
    ``AnalysisError`` on its findings."""

    name: str
    grid: tuple[int, ...]
    inputs: list[Tile]
    outputs: list[Tile]
    body: Callable
    reduce_axes: tuple[int, ...] = ()
    scratch: list[Scratch] = dataclasses.field(default_factory=list)
    # per-axis "parallel" | "arbitrary"; None: outer axes parallel, reduce
    # axes arbitrary (check_semantics rejects a carried "parallel" axis)
    dimension_semantics: tuple[str, ...] | None = None
    shard: ShardAxis | None = None

    def __post_init__(self):
        self.grid = tuple(int(g) for g in self.grid)
        if not self.grid:
            raise ValueError("grid must be non-empty")
        names = [t.name for t in self.inputs + self.outputs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tile names in kernel {self.name!r}")

        self.reduce_axes = tuple(sorted(int(a) for a in self.reduce_axes))
        if len(set(self.reduce_axes)) != len(self.reduce_axes):
            raise ValueError(f"duplicate reduce axes {self.reduce_axes}")
        k = len(self.grid) - len(self.reduce_axes)
        if self.reduce_axes and self.reduce_axes != tuple(range(k, len(self.grid))):
            raise ValueError(
                f"reduce_axes {self.reduce_axes} must be the trailing grid axes "
                f"(grid rank {len(self.grid)}): sequential axes are innermost")
        self.scratch = list(self.scratch)
        for s in self.scratch:
            if not isinstance(s, Scratch):
                raise TypeError(f"scratch entries must be lang.Scratch, got {type(s)}")

        if self.dimension_semantics is not None:
            sem = tuple(self.dimension_semantics)
            if len(sem) != len(self.grid):
                raise ValueError(
                    f"dimension_semantics has {len(sem)} entries for a rank-"
                    f"{len(self.grid)} grid")
            bad = [s for s in sem if s not in ("parallel", "arbitrary")]
            if bad:
                raise ValueError(
                    f"dimension_semantics entries must be 'parallel' or "
                    f"'arbitrary', got {bad}")
            self.dimension_semantics = sem

        for t in self.inputs:
            # stream=/reduce= are OUTPUT declarations; on an input they
            # would be silently ignored
            if t.stream or t.reduce is not None:
                raise ValueError(
                    f"input tile {t.name!r}: stream=/reduce= are output-only "
                    "declarations (inputs are read at every visit)")
            t.resolved_halo()  # structural halo validation (rank/sign/block)

        for t in self.outputs:
            # a halo is a FETCH pattern; overlapping output windows would race
            if t.halo is not None and any(int(r) for r in t.halo):
                raise ValueError(
                    f"output tile {t.name!r}: halo= is input-only "
                    "(overlapping output windows would write racily)")

        if self.shard is not None:
            sh = self.shard
            if not isinstance(sh, ShardAxis):
                raise TypeError(
                    f"Spec.shard must be a lang.ShardAxis, got {type(sh)}")
            if sh.axis not in self.reduce_axes:
                raise ValueError(
                    f"kernel {self.name!r}: shard axis {sh.axis} is not a "
                    f"reduce axis {self.reduce_axes}: only sequential "
                    "(reduce) grid axes can be distributed across the mesh")
            in_names = {t.name for t in self.inputs}
            out_names = {t.name for t in self.outputs}
            unknown = set(sh.rotate) - in_names
            if unknown:
                raise ValueError(
                    f"kernel {self.name!r}: ShardAxis.rotate names unknown "
                    f"input tiles {sorted(unknown)}")
            unknown = set(sh.sharded_outputs) - out_names
            if unknown:
                raise ValueError(
                    f"kernel {self.name!r}: ShardAxis.sharded_outputs names "
                    f"unknown output tiles {sorted(unknown)}")

        # the grid pass: certain bugs fail the build here, inside
        # build_kernel; it also finds the inputs whose block ignores the
        # reduce ids, which the torch expansion gathers once per outer cell
        from .analyze import AnalysisError, check_grid_invariants

        findings, self._input_reduce_invariant = check_grid_invariants(self)
        if findings:
            raise AnalysisError(findings)

    # -- grid split helpers --------------------------------------------------
    @property
    def outer_grid(self) -> tuple[int, ...]:
        return self.grid[: len(self.grid) - len(self.reduce_axes)]

    @property
    def reduce_grid(self) -> tuple[int, ...]:
        return tuple(self.grid[a] for a in self.reduce_axes)

    def resolved_semantics(self) -> tuple[str, ...]:
        """Per-axis ``dimension_semantics``: the declared tuple, else outer
        axes ``"parallel"`` and reduce axes ``"arbitrary"``."""
        if self.dimension_semantics is not None:
            return tuple(self.dimension_semantics)
        n_par = len(self.grid) - len(self.reduce_axes)
        return ("parallel",) * n_par + ("arbitrary",) * len(self.reduce_axes)

    def output_reduce_axes(self, t: Tile) -> tuple[int, ...]:
        """The reduce axes this output ACCUMULATES over (sorted grid axes)."""
        if t.reduce is not None:
            r = tuple(sorted(int(a) for a in t.reduce))
            if len(set(r)) != len(r):
                raise ValueError(
                    f"output tile {t.name!r}: duplicate axes in reduce={r}")
            if t.stream and r:
                raise ValueError(
                    f"output tile {t.name!r}: stream=True means reduce=(), "
                    f"got reduce={r}")
            if not set(r) <= set(self.reduce_axes):
                raise ValueError(
                    f"output tile {t.name!r}: reduce={r} is not a subset of "
                    f"the kernel's reduce axes {self.reduce_axes}")
            return r
        return () if t.stream else self.reduce_axes

    def output_slot_axes(self, t: Tile) -> tuple[int, ...]:
        """Reduce axes the output's index map may depend on: they select
        which of the output's blocks ("slot") a reduce step writes."""
        acc = set(self.output_reduce_axes(t))
        return tuple(a for a in self.reduce_axes if a not in acc)

    def slot_index(self, t: Tile) -> Callable[..., tuple]:
        """Output index map over (outer + slot-axis) cells: the accumulated
        reduce ids are pinned to 0 (the map does not depend on them)."""
        full = t.resolved_index(self.grid)
        acc = set(self.output_reduce_axes(t))
        k = len(self.outer_grid)

        def f(*cells):
            og, sg = cells[:k], iter(cells[k:])
            rids = tuple(0 if a in acc else next(sg) for a in self.reduce_axes)
            return full(*og, *rids)

        return f


def _is_full(idx) -> bool:
    return (idx is Ellipsis or idx == (Ellipsis,)
            or (isinstance(idx, slice) and idx == slice(None)))


class TileRef:
    """A functional ref: ``ref[idx]`` returns a copy of the selected part
    (so ``acc[...] += x`` and in-place ops on what was read never touch the
    ref), ``ref[idx] = v`` replaces the ref's value with an updated one.

    Under vmap ``zero`` is a batched 0-dim zero: a read adds it, so what
    the body reads is batched even where the ref holds an unbatched value
    (a constant it wrote), and an in-place update of it by a batched value
    (``acc[...] += x``) is legal."""

    __slots__ = ("_value", "_zero")

    def __init__(self, value, zero=None):
        self._value = value
        self._zero = zero

    def __getitem__(self, idx):
        v = self._value[idx]
        if self._zero is None:
            return v.clone()
        return v + self._zero.to(v.dtype)

    def __setitem__(self, idx, val):
        v = self._value
        val = torch.as_tensor(val, dtype=v.dtype, device=v.device) \
            if not torch.is_tensor(val) else val.to(v.dtype)
        if _is_full(idx):
            self._value = torch.broadcast_to(val, v.shape)
            return
        # a scatter into a flat copy: functional, so it also works under
        # vmap where v and val may be batched or not
        pos = torch.arange(v.numel(), device=v.device).reshape(v.shape)[idx]
        src = torch.broadcast_to(val, pos.shape).reshape(-1)
        self._value = v.reshape(-1).scatter(0, pos.reshape(-1), src).reshape(
            v.shape)

    @property
    def value(self):
        return self._value

    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def device(self):
        return self._value.device


def _holds(pred) -> bool | None:
    """A predicate's value when it is known on the host, else None."""
    if isinstance(pred, (bool, np.bool_)):
        return bool(pred)
    return None


class Ctx:
    """occaKernelInfoArg analogue: grid ids/dims, defines, backend flags,
    reduce position and scratch refs."""

    def __init__(self, backend: str, defines: SimpleNamespace,
                 gids: Sequence, grid: tuple[int, ...], *,
                 reduce_axes: tuple[int, ...] = (), scratch: Sequence = (),
                 refs: Sequence = (), device=None):
        self.backend = backend
        self.D = defines
        self._gids = tuple(gids)
        self.grid = grid
        self._reduce_axes = tuple(reduce_axes)
        self.scratch = tuple(scratch)
        self._refs = tuple(refs)
        self.device = device

    # --- occaOuterId / occaOuterDim ---------------------------------------
    def outer_id(self, d: int):
        return self._gids[d]

    def outer_dim(self, d: int) -> int:
        return self.grid[d]

    # --- reduce (sequential) axes -----------------------------------------
    def reduce_id(self, d: int = 0):
        """Position along the d-th reduce axis (0 .. reduce_dim(d) - 1)."""
        return self._gids[self._reduce_axes[d]]

    def reduce_dim(self, d: int = 0) -> int:
        return self.grid[self._reduce_axes[d]]

    def reduce_first(self, d: int = 0):
        """True on the first step along the d-th reduce axis: the init point
        for state accumulated over that axis only."""
        return self._gids[self._reduce_axes[d]] == 0

    def reduce_last(self, d: int = 0):
        """True on the last step along the d-th reduce axis (flush point)."""
        a = self._reduce_axes[d]
        return self._gids[a] == self.grid[a] - 1

    @property
    def is_first(self):
        """True on the first visit of the reduce space (init point); True
        for kernels without reduce axes."""
        return all(self._gids[a] == 0 for a in self._reduce_axes)

    @property
    def is_last(self):
        """True on the last visit of the reduce space (flush point)."""
        return all(self._gids[a] == self.grid[a] - 1
                   for a in self._reduce_axes)

    def when(self, pred):
        """Run the decorated thunk only when ``pred`` holds. A host
        predicate skips for real; a tensor one skips for real under loops
        and, under the torch expansion, runs the thunk and keeps each
        tracked ref's old value where ``pred`` is false."""
        def deco(fn):
            held = _holds(pred)
            if held is not None or self.backend == "loops":
                if held if held is not None else bool(pred):
                    fn()
                return fn
            before = [r._value for r in self._refs]
            fn()
            for r, old in zip(self._refs, before):
                r._value = torch.where(pred, r._value, old)
            return fn
        return deco

    def cell_when(self, pred):
        """Masked grid cell: skip the whole block's work unless ``pred``
        holds (the causal block skip). ``pred`` is a scalar of grid ids,
        defines and values loaded from input tiles, never of output or
        scratch contents; the same expansion as :meth:`when`."""
        return self.when(pred)

    # --- occaInnerId: lanes of the vectorized tile ------------------------
    def lane_ids(self, n: int):
        return torch.arange(n, device=self.device)

    # --- occaBarrier: no-op (sequential block execution) ------------------
    def barrier(self, *_fence):
        return None

    # --- occaShared manual caching ----------------------------------------
    def cache(self, ref):
        return ref[...]

    # --- occaPrivate ------------------------------------------------------
    def private(self, value):
        return value

    # --- occaCPU / occaGPU ------------------------------------------------
    @property
    def is_torch(self) -> bool:
        return self.backend == "torch"

    @property
    def is_loops(self) -> bool:
        return self.backend == "loops"


# ---------------------------------------------------------------------------
# Halo lowering
# ---------------------------------------------------------------------------
#
# A halo tile is lowered to a regular blocked tile over a windowed layout
# before the torch and loops expansions see it: per block index i along a
# haloed axis, the window [i*b - r, (i+1)*b + r) (periodic or edge-clamped)
# is laid out contiguously, so block i of the lowered array IS the window.
# The gather is one static-index ``index_select`` per haloed axis; its cost
# is the halo amplification (b + 2r) / b. The cuda backend takes the field
# as it is: the hand-written kernel fetches its own fringe.

def _halo_axis_index(nblocks: int, b: int, r: int, s: int, wrap: bool):
    """Static source indices for one haloed axis's windowed layout."""
    offs = np.arange(-r, b + r)
    idx = (np.arange(nblocks)[:, None] * b + offs[None, :]).reshape(-1)
    return idx % s if wrap else np.clip(idx, 0, s - 1)


class _OnDevice:
    """Host-built int64 index arrays, copied to each device once."""

    def __init__(self, arrays):
        self._host = [np.ascontiguousarray(a, dtype=np.int64) for a in arrays]
        self._dev = {}

    def on(self, device):
        got = self._dev.get(device)
        if got is None:
            got = self._dev[device] = [torch.from_numpy(a).to(device)
                                       for a in self._host]
        return got


def _lower_halo_tile(tile: Tile) -> tuple[Tile, Callable]:
    blk = tile.resolved_block()
    halo = tile.resolved_halo()
    nb = tuple(s // b for s, b in zip(tile.shape, blk))
    wblk = tile.body_block()
    wshape = tuple(n * w for n, w in zip(nb, wblk))
    axes = [d for d, r in enumerate(halo) if r]
    idx = _OnDevice([_halo_axis_index(nb[d], blk[d], halo[d], tile.shape[d],
                                      tile.wrap) for d in axes])

    def windowize(arr):
        for d, ix in zip(axes, idx.on(arr.device)):
            arr = torch.index_select(arr, d, ix)
        return arr

    lowered = dataclasses.replace(tile, shape=wshape, block=wblk, halo=None)
    return lowered, windowize


def _lower_halos(spec: Spec) -> tuple[Spec, list | None]:
    """(lowered spec, per-input window fns); (spec, None) when halo-free."""
    if not any(t.halo is not None and any(t.resolved_halo())
               for t in spec.inputs):
        return spec, None
    preps, inputs = [], []
    for t in spec.inputs:
        if t.halo is not None and any(t.resolved_halo()):
            lowered, prep = _lower_halo_tile(t)
        else:
            lowered, prep = t, None
        inputs.append(lowered)
        preps.append(prep)
    lowered = dataclasses.replace(spec, inputs=inputs)
    return lowered, preps


# ---------------------------------------------------------------------------
# Blocks of a tile at a list of grid cells
# ---------------------------------------------------------------------------

def _grid_cells(grid) -> np.ndarray:
    """Every cell of ``grid`` in C order, as an (n, len(grid)) array."""
    return np.indices(grid).reshape(len(grid), -1).T if grid else \
        np.zeros((1, 0), np.int64)


class _Blocks:
    """The blocks of one tile at a list of grid cells, in that order:
    :meth:`take` gathers them into an ``(n, *block)`` batch, :meth:`put`
    scatters such a batch into the array. The block indices come from the
    tile's index map on the host; a tile gathered through a table reads
    its gathered axis from the table at run time."""

    def __init__(self, tile: Tile, cells: np.ndarray, index_fn):
        self.blk = tile.resolved_block()
        self.shape = tile.shape
        self.nb = tuple(s // b for s, b in zip(tile.shape, self.blk))
        self.n = len(cells)
        ndim = len(self.blk)
        bidx = np.asarray([[int(i) for i in index_fn(*map(int, c))]
                           for c in cells], dtype=np.int64).reshape(
                               self.n, ndim)
        self.gax = None if tile.index_tile is None else tile.index_tile[1]
        self.canonical = (self.gax is None and self.n == math.prod(self.nb)
                          and np.array_equal(bidx, _grid_cells(self.nb)))
        self.bidx = bidx
        self._ix = _OnDevice([
            bidx[:, d:d + 1] * b + np.arange(b)[None, :]
            for d, b in enumerate(self.blk)])

    def _views(self, ix):
        nd = len(self.blk)
        return tuple(x.view((self.n,) + tuple(b if e == d else 1
                                              for e, b in enumerate(self.blk)))
                     for d, x in enumerate(ix[:nd]))

    def take(self, arr, gathered=None):
        """(n, *block) batch of ``arr``'s blocks; ``gathered``: the
        run-time block indices (n,) along the table-read axis."""
        if self.canonical:
            k = len(self.blk)
            x = arr.reshape(tuple(v for nb, b in zip(self.nb, self.blk)
                                  for v in (nb, b)))
            x = x.permute(tuple(range(0, 2 * k, 2)) + tuple(range(1, 2 * k, 2)))
            return x.reshape((self.n,) + self.blk)
        ix = list(self._ix.on(arr.device))
        if gathered is not None:
            b = self.blk[self.gax]
            ix[self.gax] = gathered[:, None] * b + torch.arange(
                b, device=arr.device)[None, :]
        return arr[self._views(ix)]

    def put(self, out, stack):
        """Write the (n, *block) batch ``stack`` into ``out`` in place."""
        if self.canonical:
            k = len(self.blk)
            x = stack.reshape(self.nb + self.blk)
            perm = tuple(v for d in range(k) for v in (d, k + d))
            out.copy_(x.permute(perm).reshape(self.shape))
        else:
            out[self._views(self._ix.on(out.device))] = stack
        return out


def _table_values(tile: Tile, table, table_blocks: _Blocks):
    """Run-time block indices along ``tile``'s gathered axis: the elements
    of ``table`` its cells name (an all-ones block: the block index is the
    element index), clamped to the block grid."""
    axis = tile.index_tile[1]
    ix = torch.from_numpy(table_blocks.bidx).to(table.device)
    vals = table[tuple(ix[:, d] for d in range(ix.shape[1]))].to(torch.int64)
    nb = tile.shape[axis] // tile.resolved_block()[axis]
    return vals.clamp(0, nb - 1)


# ---------------------------------------------------------------------------
# Backend expansions. Each returns fn(*inputs, outs=None) -> outputs: fresh
# tensors, or ``outs`` written in place.
# ---------------------------------------------------------------------------

def _device_of(arrays):
    return arrays[0].device if arrays else torch.device("cpu")


def _run_body(spec, backend, defines, gids, ins, out_vals, scr_vals, device,
              zero=None):
    """One body call over TileRefs; returns the updated (output block
    values, scratch values). ``zero``: the batched zero under vmap."""
    outs = [TileRef(v, zero) for v in out_vals]
    scr = [TileRef(v, zero) for v in scr_vals]
    ctx = Ctx(backend, defines, gids, spec.grid,
              reduce_axes=spec.reduce_axes, scratch=scr,
              refs=tuple(outs) + tuple(scr), device=device)
    spec.body(ctx, *[TileRef(v, zero) for v in ins], *outs)
    return tuple(o.value for o in outs), tuple(s.value for s in scr)


def _is_whole(t: Tile) -> bool:
    return t.index_tile is None and t.resolved_block() == tuple(t.shape)


def _expand_torch(spec: Spec, defines: SimpleNamespace):
    outer_grid, red_grid = spec.outer_grid, spec.reduce_grid
    k = len(outer_grid)
    ocells = _grid_cells(outer_grid)
    nouter = len(ocells)
    rcells = [tuple(int(i) for i in c) for c in _grid_cells(red_grid)]
    hoist = spec._input_reduce_invariant if red_grid else \
        [True] * len(spec.inputs)
    # per output: the positions (within reduce_axes) of its slot axes and
    # their extents; it owns one block per slot within an outer cell
    slots = []
    for t in spec.outputs:
        axes = spec.output_slot_axes(t)
        slots.append((tuple(spec.reduce_axes.index(a) for a in axes),
                      tuple(spec.grid[a] for a in axes)))
    place = [_Blocks(t, _grid_cells(outer_grid + sd), spec.slot_index(t))
             for t, (_, sd) in zip(spec.outputs, slots)]
    blocks = {}

    def blocks_at(i, r):
        """The blocks of input i at the outer cells of reduce step r."""
        if (i, r) not in blocks:
            rg = np.asarray(rcells[r], np.int64)
            cells = np.concatenate([ocells, np.broadcast_to(
                rg, (nouter, len(rg)))], axis=1)
            t = spec.inputs[i]
            blocks[(i, r)] = _Blocks(t, cells, t.resolved_index(spec.grid))
        return blocks[(i, r)]

    names = {t.name: i for i, t in enumerate(spec.inputs)}
    n_in, n_out = len(spec.inputs), len(spec.outputs)

    def fn(*arrays):
        dev = _device_of(arrays)
        ids = torch.from_numpy(np.ascontiguousarray(ocells)).to(dev)
        stacks = [torch.zeros((nouter, math.prod(sd)) + t.resolved_block(),
                              dtype=t.dtype, device=dev)
                  for t, (_, sd) in zip(spec.outputs, slots)]
        scr = [torch.zeros((nouter,) + s.shape, dtype=s.dtype, device=dev)
               for s in spec.scratch]
        pinned = {}
        for r, rg in enumerate(rcells):
            ins, dims = [], []
            for i, (t, a) in enumerate(zip(spec.inputs, arrays)):
                if _is_whole(t):
                    ins.append(a)
                    dims.append(None)
                    continue
                if not (hoist[i] and i in pinned):
                    # a hoisted input's block ignores the reduce ids: its
                    # blocks at step 0 serve every step
                    step = 0 if hoist[i] else r
                    gathered = None
                    if t.index_tile is not None:
                        ti = names[t.index_tile[0]]
                        gathered = _table_values(t, arrays[ti],
                                                 blocks_at(ti, step))
                    pinned[i] = blocks_at(i, step).take(a, gathered)
                ins.append(pinned[i])
                dims.append(0)
            sl = []
            for pos, sd in slots:
                s = 0
                for p, dim in zip(pos, sd):
                    s = s * dim + rg[p]
                sl.append(s)
            cur = [st[:, s] for st, s in zip(stacks, sl)]

            def cell(cid, *vals):
                gids = tuple(cid[d] for d in range(k)) + rg
                new_out, new_scr = _run_body(
                    spec, "torch", defines, gids, vals[:n_in],
                    vals[n_in:n_in + n_out], vals[n_in + n_out:], dev,
                    zero=cid.sum() * 0)
                return new_out + new_scr

            res = torch.func.vmap(
                cell, in_dims=(0, *dims, *[0] * (n_out + len(scr))))(
                    ids, *ins, *cur, *scr)
            for st, s, v in zip(stacks, sl, res[:n_out]):
                st[:, s] = v
            scr = list(res[n_out:])
            if not red_grid:
                break
        return tuple(
            p.put(torch.empty(t.shape, dtype=t.dtype, device=dev),
                  st.reshape((-1,) + t.resolved_block()))
            for t, p, st in zip(spec.outputs, place, stacks))

    return fn


def _slices(tile: Tile, gids, grid, tables):
    """The block of ``tile`` at grid cell ``gids`` as a tuple of slices
    (host ints: the loops and single-cell expansions)."""
    blk = tile.resolved_block()
    bidx = [int(i) for i in tile.resolved_index(grid)(*gids)]
    if tile.index_tile is not None:
        tname, axis = tile.index_tile
        ttile, tarr = tables[tname]
        val = int(tarr[_slices(ttile, gids, grid, tables)].reshape(-1)[0])
        nb = tile.shape[axis] // blk[axis]
        bidx[axis] = min(max(val, 0), nb - 1)
    return tuple(slice(i * b, (i + 1) * b) for i, b in zip(bidx, blk))


def _expand_loops(spec: Spec, defines: SimpleNamespace):
    grid = spec.grid
    cells = [tuple(int(i) for i in c) for c in _grid_cells(grid)]

    def fn(*arrays):
        dev = _device_of(arrays)
        tables = {t.name: (t, a) for t, a in zip(spec.inputs, arrays)}
        outs = [torch.zeros(t.shape, dtype=t.dtype, device=dev)
                for t in spec.outputs]
        scr = tuple(torch.zeros(s.shape, dtype=s.dtype, device=dev)
                    for s in spec.scratch)
        for gids in cells:   # C order: the reduce axes innermost
            ins = [a if _is_whole(t) else a[_slices(t, gids, grid, tables)]
                   for t, a in zip(spec.inputs, arrays)]
            where = [_slices(t, gids, grid, tables) for t in spec.outputs]
            # with reduce axes an output block keeps its contents across
            # its visits (zeros on the first); without, each is visited once
            cur = [o[w] if spec.reduce_axes else torch.zeros(
                       t.resolved_block(), dtype=t.dtype, device=dev)
                   for t, o, w in zip(spec.outputs, outs, where)]
            vals, scr = _run_body(spec, "loops", defines, gids, ins, cur,
                                  scr, dev)
            for o, w, v in zip(outs, where, vals):
                o[w] = v
        return tuple(outs)

    return fn


def _expand_single_cell(spec: Spec, defines: SimpleNamespace, backend: str):
    """Degenerate grid (one cell): run the body once, directly on the whole
    arrays: the torch and loops expansions are the same program here."""
    grid = spec.grid
    gids = (0,) * len(grid)

    def fn(*arrays):
        dev = _device_of(arrays)
        tables = {t.name: (t, a) for t, a in zip(spec.inputs, arrays)}
        ins = [a if _is_whole(t) else a[_slices(t, gids, grid, tables)]
               for t, a in zip(spec.inputs, arrays)]
        out0 = [torch.zeros(t.resolved_block(), dtype=t.dtype, device=dev)
                for t in spec.outputs]
        scr0 = [torch.zeros(s.shape, dtype=s.dtype, device=dev)
                for s in spec.scratch]
        vals, _ = _run_body(spec, backend, defines, gids, ins, out0, scr0,
                            dev)
        # one cell writes each output's one block (the grid pass checked
        # the coverage): the block is the array
        return tuple(torch.broadcast_to(v, t.shape).contiguous()
                     for t, v in zip(spec.outputs, vals))

    return fn


def _expand_cuda(spec: Spec, defines: SimpleNamespace):
    from .cuda import cuda_binding

    b = cuda_binding(spec.name)
    if b is None:
        raise ValueError(
            f"kernel {spec.name!r} has no cuda binding (no hand-written "
            f"kernel runs this spec); the backends that run it: "
            f"{[x for x in BACKENDS if x != 'cuda']}")
    why = b.refusal(spec, defines)
    if why:
        raise ValueError(f"kernel {spec.name!r}: the cuda kernel refuses "
                         f"these defines: {why}")

    def fn(*arrays, outs=None):
        # the wrapper's own tensors; only a call into outputs the caller
        # owns copies, and a binding that writes in place (copies=False)
        # is handed them
        res = tuple(b.launch(defines, arrays, None if b.copies else outs))
        if outs is None:
            return res
        for o, r in zip(outs, res):
            if r is not o:
                o.copy_(r)
        return tuple(outs)

    fn.binding = b
    return fn


def expand(spec: Spec, defines: SimpleNamespace, backend: str):
    """Expand one kernel Spec for a backend (the run-time 'macro
    expansion'): returns ``fn(*inputs, outs=None)``, which gives the
    outputs as fresh tensors, or writes them into ``outs`` in place."""
    if backend == "cuda":
        return _expand_cuda(spec, defines)
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}")
    spec, preps = _lower_halos(spec)
    if math.prod(spec.grid) == 1:
        inner = _expand_single_cell(spec, defines, backend)
    elif backend == "torch":
        inner = _expand_torch(spec, defines)
    else:
        inner = _expand_loops(spec, defines)

    def fn(*arrays, outs=None):
        if preps is not None:
            arrays = tuple(a if p is None else p(a)
                           for p, a in zip(preps, arrays))
        res = inner(*arrays)
        if outs is None:
            return res
        for o, r in zip(outs, res):
            o.copy_(r)
        return tuple(outs)

    return fn
