"""The analyzer's body pass in the port (``repro_torch.core.analyze``):
the counterparts of the JAX package's tests/test_analyze.py. Each seeded
bad spec is built on the port's torch and loops backends and must fail
with its finding code, the code the JAX analyzer gives the same spec
(written in jnp, built on JAX's backends); the modes, the nested guards'
run-time composition, and a registry that lints clean."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core as jcore

from repro_torch import core as tcore
from repro_torch.core import (AnalysisError, AnalysisWarning, Device,
                              analysis_mode, analyze_spec,
                              set_analysis_mode)

BACKENDS = ("torch", "loops")


def _codes(err):
    return {f.code for f in err.findings}


def _both(make, defines=None, **kw):
    """The port's finding codes on each of its backends, and the JAX
    analyzer's on JAX's, for one spec written once per package."""
    got = {}
    for be in BACKENDS:
        with pytest.raises(AnalysisError) as ei:
            Device(be, device="cpu").build_kernel(make(tcore, torch),
                                                  defines or {}, **kw)
        got[be] = ei.value
    with pytest.raises(jcore.AnalysisError) as ej:
        jcore.Device("jnp").build_kernel(make(jcore, jnp), defines or {},
                                         **kw)
    for be, err in got.items():
        assert _codes(err) == _codes(ej.value), be
    return got


def _sum(xp, x):
    return jnp.sum(x, keepdims=True) if xp is jnp else x.sum(0, keepdim=True)


F32 = "float32"


# ---------------------------------------------------------------------------
# the five seeded bad specs, one distinct finding code each
# ---------------------------------------------------------------------------

def _race(pkg, xp):
    def bad(D):
        def body(ctx, x, y):
            y[...] = x[...]

        return pkg.Spec("race", grid=(4,),
                        inputs=[pkg.Tile("x", (16,), F32, block=(4,))],
                        outputs=[pkg.Tile("y", (16,), F32, block=(4,),
                                          index=lambda i: (i // 2,))],
                        body=body)
    return bad


def test_parallel_axis_race_rejected():
    for err in _both(_race).values():
        assert _codes(err) == {"RACE_PARALLEL_WRITE"}
        assert "visited more than once" in str(err)


def _holes(pkg, xp):
    def bad(D):
        def body(ctx, x, y):
            y[...] = x[...]

        return pkg.Spec("holes", grid=(2,),
                        inputs=[pkg.Tile("x", (16,), F32, block=(4,),
                                         index=lambda i: (i,))],
                        outputs=[pkg.Tile("y", (16,), F32, block=(4,),
                                          index=lambda i: (i,))],
                        body=body)
    return bad


def test_unwritten_block_rejected():
    for err in _both(_holes).values():
        assert _codes(err) == {"COVERAGE_UNWRITTEN"}
        assert "leave garbage" in str(err)


def _noinit(pkg, xp, name="noinit", semantics=None, init=False):
    def bad(D):
        def body(ctx, x, out):
            acc, = ctx.scratch
            if init:
                @ctx.when(ctx.is_first)
                def _init():
                    acc[...] = (jnp.zeros(acc.shape, acc.dtype) if xp is jnp
                                else torch.zeros(acc.shape, dtype=acc.dtype,
                                                 device=acc.device))

            acc[...] += _sum(xp, x[...])

            @ctx.when(ctx.is_last)
            def _flush():
                out[...] = acc[...]

        return pkg.Spec(name, grid=(4,), reduce_axes=(0,),
                        dimension_semantics=semantics,
                        scratch=[pkg.Scratch((1,), F32)],
                        inputs=[pkg.Tile("x", (16,), F32, block=(4,),
                                         index=lambda r: (r,))],
                        outputs=[pkg.Tile("out", (1,), F32, block=(1,),
                                          index=lambda r: (0,))],
                        body=body)
    return bad


def test_scratch_read_before_init_rejected():
    for err in _both(_noinit).values():
        assert _codes(err) == {"LIVENESS_SCRATCH_UNINIT"}


def _skippy(pkg, xp):
    def bad(D):
        def body(ctx, x, y):
            @ctx.cell_when(ctx.outer_id(0) % 2 == 0)
            def _maybe():
                y[...] = x[...] * 2.0

        return pkg.Spec("skippy", grid=(4,),
                        inputs=[pkg.Tile("x", (16,), F32, block=(4,))],
                        outputs=[pkg.Tile("y", (16,), F32, block=(4,))],
                        body=body)
    return bad


def test_skippable_write_without_init_rejected_strict():
    """An output written only under a grid-dependent cell_when: a block
    whose guard skips is left undefined in a hand-written kernel."""
    for err in _both(_skippy, analyze="strict").values():
        assert _codes(err) == {"COVERAGE_SKIP_NO_INIT"}
    # coverage findings warn by default, they do not fail the build
    with pytest.warns(AnalysisWarning, match="COVERAGE_SKIP_NO_INIT"):
        Device("torch", device="cpu").build_kernel(_skippy(tcore, torch), {})


def test_parallel_reduce_axis_with_carried_state_rejected():
    def make(pkg, xp):
        return _noinit(pkg, xp, "badsem", semantics=("parallel",), init=True)

    for err in _both(make).values():
        assert _codes(err) == {"SEMANTICS_PARALLEL_CARRIED"}


# ---------------------------------------------------------------------------
# index-map bounds: the offending cell and axis in the message
# ---------------------------------------------------------------------------

def _copy_spec(pkg, name, grid, x, y):
    def bad(D):
        def body(ctx, xr, yr):
            yr[...] = xr[...]

        return pkg.Spec(name, grid=grid, inputs=[pkg.Tile("x", **x)],
                        outputs=[pkg.Tile("y", **y)], body=body)
    return bad


def test_output_index_out_of_bounds_reports_cell_and_axis():
    def make(pkg, xp):
        return _copy_spec(pkg, "oob", (4,), dict(shape=(16,), dtype=F32,
                                                 block=(4,)),
                          dict(shape=(16,), dtype=F32, block=(4,),
                               index=lambda i: (i + 1,)))

    for err in _both(make).values():
        assert _codes(err) == {"BOUNDS_INDEX"}
        msg = str(err)
        assert "cell (3,)" in msg and "axis 0" in msg and \
            "block index 4" in msg


def test_input_index_out_of_bounds_reports_cell_and_axis():
    def make(pkg, xp):
        return _copy_spec(pkg, "oob_in", (2, 2),
                          dict(shape=(8, 8), dtype=F32, block=(4, 4),
                               index=lambda i, j: (i, j + 2)),
                          dict(shape=(8, 8), dtype=F32, block=(4, 4)))

    for err in _both(make).values():
        assert _codes(err) == {"BOUNDS_INDEX"}
        assert "cell (0, 0)" in str(err) and "axis 1" in str(err)


def test_scratch_shape_validated():
    def make(pkg, xp):
        def bad(D):
            def body(ctx, x, y):
                y[...] = x[...]

            return pkg.Spec("scr0", grid=(4,),
                            scratch=[pkg.Scratch((0,), F32)],
                            inputs=[pkg.Tile("x", (16,), F32, block=(4,))],
                            outputs=[pkg.Tile("y", (16,), F32, block=(4,))],
                            body=body)
        return bad

    for err in _both(make).values():
        assert _codes(err) == {"BOUNDS_SCRATCH"}


# ---------------------------------------------------------------------------
# the strictness knob
# ---------------------------------------------------------------------------

def test_analyze_off_skips_body_analysis():
    kern = Device("torch", device="cpu").build_kernel(
        _noinit(tcore, torch, "noinit_off"), {}, analyze="off")
    # the zero-filled torch expansion still runs (the bug it would hide)
    out, = kern.run(torch.arange(16, dtype=torch.float32))
    assert float(out[0]) == 120.0


def test_analyze_warn_mode_downgrades_errors():
    with pytest.warns(AnalysisWarning, match="LIVENESS_SCRATCH_UNINIT"):
        Device("loops", device="cpu").build_kernel(
            _noinit(tcore, torch, "noinit_warn"), {}, analyze="warn")


def test_set_analysis_mode_round_trips(monkeypatch):
    assert analysis_mode() == "error"  # the default
    prev = set_analysis_mode("strict")
    try:
        assert analysis_mode() == "strict"
    finally:
        set_analysis_mode(prev)
    monkeypatch.setenv("REPRO_ANALYZE", "warn")
    assert analysis_mode() == "warn"
    monkeypatch.setenv("REPRO_ANALYZE", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        analysis_mode()
    with pytest.raises(ValueError, match="analyze mode"):
        set_analysis_mode("bogus")


def test_dimension_semantics_validated():
    def bad(D):
        def body(ctx, x, y):
            y[...] = x[...]

        return tcore.Spec("sem_len", grid=(4,),
                          dimension_semantics=("parallel",) * 2,
                          inputs=[tcore.Tile("x", (16,), F32, block=(4,))],
                          outputs=[tcore.Tile("y", (16,), F32, block=(4,))],
                          body=body)

    with pytest.raises(ValueError, match="dimension_semantics"):
        Device("torch", device="cpu").build_kernel(bad, {})


# ---------------------------------------------------------------------------
# nested when / cell_when: predicates compose (AND) on every expansion
# ---------------------------------------------------------------------------

def test_nested_when_inside_cell_when_agrees_across_backends():
    """A when nested under a cell_when runs iff both predicates hold; the
    analyzer traces both guards and finds nothing (a guaranteed write
    comes first), and the expansions agree exactly."""
    def builder(D):
        def body(ctx, x, y):
            y[...] = x[...]  # guaranteed init: skipped cells keep x

            @ctx.cell_when(ctx.outer_id(0) % 2 == 0)
            def _even_cells():
                @ctx.when(x[0] > 0.0)
                def _positive_lead():
                    y[...] = x[...] * 2.0

        return tcore.Spec("nested", grid=(4,),
                          inputs=[tcore.Tile("x", (16,), F32, block=(4,))],
                          outputs=[tcore.Tile("y", (16,), F32, block=(4,))],
                          body=body)

    x = np.asarray([1, 2, 3, 4, -1, -2, -3, -4,
                    5, 6, 7, 8, -5, -6, -7, -8], np.float32)
    want = x.copy()
    for i in range(4):
        blk = x[4 * i: 4 * i + 4]
        if i % 2 == 0 and blk[0] > 0:
            want[4 * i: 4 * i + 4] = blk * 2
    outs = {}
    for be in BACKENDS:
        k = Device(be, device="cpu").build_kernel(builder, {},
                                                  analyze="strict")
        outs[be] = k.run(torch.from_numpy(x))[0].numpy()
        np.testing.assert_array_equal(outs[be], want,
                                      err_msg=f"backend {be} diverged")
    np.testing.assert_array_equal(outs["torch"], outs["loops"])


# ---------------------------------------------------------------------------
# no false positives: the whole registry analyzes clean
# ---------------------------------------------------------------------------

def test_registry_sweeps_clean():
    """Every registered op (and the flash and LM-head backward builders a
    family builds beside its op's), across its sweep: zero findings."""
    from repro_torch.lint_kernels import lint_op

    ops = tcore.registered_ops()
    assert len(ops) == 13
    for name in sorted(ops):
        result = lint_op(ops[name], np.random.RandomState(0))
        assert result["checked"] > 0, f"{name}: nothing analyzed"
        assert result["findings"] == [], (
            f"{name}: analyzer false positives {result['findings']}")


def test_analyze_spec_reports_without_raising():
    """analyze_spec is the surface that raises nothing (lint, tooling)."""
    good = _copy_spec(tcore, "idty", (4,), dict(shape=(16,), dtype=F32,
                                                block=(4,)),
                      dict(shape=(16,), dtype=F32, block=(4,)))
    D = tcore.defines_namespace({})
    report = analyze_spec(good(D), D)
    assert report.ok and report.errors == []
    bad = _noinit(tcore, torch, "noinit_report")(D)
    report = analyze_spec(bad, D)
    assert {f.code for f in report.findings} == {"LIVENESS_SCRATCH_UNINIT"}
