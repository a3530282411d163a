"""The port's OCCA host API (``repro_torch.core``: Device, Memory, Kernel,
the build cache, the cuda backend's table) and its analyzer's grid pass,
on the CPU.

Every spec the JAX package rejects is rejected here too: each bad spec is
written once over either package's ``Spec``/``Tile`` and built on JAX's
``jnp`` device and on the port's ``torch`` and ``loops`` devices; an
``AnalysisError`` carries the same finding codes in both, a structural
``ValueError`` the same message.
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro_torch import core as tcore
from repro_torch.core import lang as tlang

PORT = ("torch", "loops")


def _saxpy(D):
    def body(ctx, x, y, out):
        out[...] = D.alpha * x[...] + y[...]

    return tcore.Spec(
        "saxpy", grid=(D.n // D.bn,),
        inputs=[tcore.Tile("x", (D.n,), "float32", block=(D.bn,)),
                tcore.Tile("y", (D.n,), "float32", block=(D.bn,))],
        outputs=[tcore.Tile("out", (D.n,), "float32", block=(D.bn,))],
        body=body)


def _scale_builder(alpha):
    def builder(D):
        def body(ctx, x, o):
            o[...] = alpha * x[...]

        return tcore.Spec("scale", grid=(4,),
                          inputs=[tcore.Tile("x", (16,), "float32", block=(4,))],
                          outputs=[tcore.Tile("o", (16,), "float32", block=(4,))],
                          body=body)

    return builder


def _cpu(backend="torch"):
    return tcore.Device(backend, device="cpu")


# ---------------------------------------------------------------------------
# the build cache: hits, misses, identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", PORT)
def test_build_cache_and_defines_specialization(backend):
    dev = _cpu(backend)
    d = dict(n=32, bn=8, alpha=2.0)
    k1 = dev.build_kernel(_saxpy, d)
    assert dev.build_kernel(_saxpy, dict(d)) is k1
    k3 = dev.build_kernel(_saxpy, dict(d, alpha=3.0))
    assert k3 is not k1
    assert (dev.stats.builds, dev.stats.cache_hits) == (2, 1)
    x = torch.ones(32)
    torch.testing.assert_close(k1.run(x, x)[0], 3.0 * x)
    torch.testing.assert_close(k3.run(x, x)[0], 4.0 * x)
    # the backend and the device are part of the key
    assert _cpu("loops" if backend == "torch" else "torch").build_kernel(
        _saxpy, d) is not k1


def test_cache_distinguishes_factory_closures_and_drops_dead_ones():
    dev = _cpu()
    b2, b3 = _scale_builder(2.0), _scale_builder(3.0)
    assert b2.__qualname__ == b3.__qualname__
    k2, k3 = dev.build_kernel(b2, {}), dev.build_kernel(b3, {})
    assert k2 is not k3 and dev.stats.cache_hits == 0
    x = torch.ones(16)
    assert float(k2.run(x)[0][0]) == 2.0 and float(k3.run(x)[0][0]) == 3.0
    assert dev.build_kernel(b2, {}) is k2
    del b2, b3, k2, k3
    dev.build_kernel(_scale_builder(4.0), {})
    gc.collect()
    assert len(dev._cache) == 0, "the weak cache must drop dead builders"


def test_cache_keys_bound_methods_by_instance_identity():
    class Family:
        def __init__(self, alpha):
            self.alpha = alpha

        def __eq__(self, other):          # equal, yet different kernels
            return isinstance(other, Family)

        __hash__ = object.__hash__

        def builder(self, D):
            return _scale_builder(self.alpha)(D)

    dev = _cpu()
    f2, f3 = Family(2.0), Family(3.0)
    k2 = dev.build_kernel(f2.builder, {})
    assert dev.build_kernel(f2.builder, {}) is k2     # a fresh bound method
    assert dev.stats.cache_hits == 1
    k3 = dev.build_kernel(f3.builder, {})
    assert k3 is not k2 and f2 == f3
    assert float(k3.run(torch.ones(16))[0][0]) == 3.0


def test_builder_must_return_a_spec():
    with pytest.raises(TypeError, match="lang.Spec"):
        _cpu().build_kernel(lambda D: None, {})


# ---------------------------------------------------------------------------
# Memory and Kernel
# ---------------------------------------------------------------------------

def test_malloc_swap_and_host_round_trip():
    dev = _cpu()
    a = dev.malloc(np.arange(4, dtype=np.float32))
    b = dev.malloc(4)
    assert b.shape == (4,) and b.dtype == torch.float32 and b.nbytes == 16
    src = torch.arange(3, dtype=torch.float64)
    c = dev.malloc(src, "float32")
    assert c.dtype == torch.float32 and c.data.data_ptr() != src.data_ptr()
    pa, pb = a.data.data_ptr(), b.data.data_ptr()
    a.swap(b)
    assert (a.data.data_ptr(), b.data.data_ptr()) == (pb, pa)
    assert a.to_host().sum() == 0 and b.to_host().sum() == 6
    b.from_host(np.full(4, 2.0, np.float32))
    assert b.data.data_ptr() == pa                     # copied in place
    np.testing.assert_array_equal(b.to_host(), 2.0)
    with pytest.raises(ValueError, match="from_host"):
        b.from_host(np.zeros(5, np.float32))
    with pytest.raises(ValueError, match="from_host"):
        b.from_host(np.zeros(4, np.float64))
    with pytest.raises(ValueError, match="different devices"):
        a.swap(_cpu().malloc(4))
    with pytest.raises(TypeError, match="Memory"):
        a.swap(torch.zeros(4))


def test_kernel_writes_outputs_in_place_and_run_returns_fresh():
    dev = _cpu("loops")
    k = dev.build_kernel(_saxpy, dict(n=16, bn=8, alpha=1.0))
    x, y = dev.malloc(np.ones(16, np.float32)), dev.malloc(np.ones(16, np.float32))
    out = dev.malloc(16)
    ptr = out.data.data_ptr()
    (res,) = k(x, y, out)
    assert res is out.data and out.data.data_ptr() == ptr
    np.testing.assert_array_equal(out.to_host(), 2.0)
    (fresh,) = k.run(x, y.data)                        # Memory or tensors
    assert fresh.data_ptr() != ptr and float(fresh.sum()) == 32.0
    assert k.name == "saxpy" and k.binding is None
    assert k.defines == dict(n=16, bn=8, alpha=1.0)


def test_kernel_call_raises_on_wrong_arguments():
    dev = _cpu()
    k = dev.build_kernel(_saxpy, dict(n=16, bn=8, alpha=1.0))
    x, out = dev.malloc(16), dev.malloc(16)
    with pytest.raises(TypeError, match="2 inputs \\+ 1 outputs"):
        k(x, out)
    with pytest.raises(TypeError, match="must be Memory"):
        k(x, x, torch.zeros(16))
    other = _cpu()
    with pytest.raises(ValueError, match="output Memory belongs to"):
        k(x, x, other.malloc(16))
    with pytest.raises(ValueError, match="belongs to"):
        k(other.malloc(16), x, out)
    with pytest.raises(ValueError, match="shape"):
        k(x, x, dev.malloc(8))
    with pytest.raises(ValueError, match="shape"):
        k.run(torch.zeros(8), torch.zeros(8))
    with pytest.raises(TypeError, match="2 inputs"):
        k.run(x)


# ---------------------------------------------------------------------------
# devices and the cuda backend
# ---------------------------------------------------------------------------

def test_devices_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in tcore.BACKENDS:
        with pytest.raises(RuntimeError, match="CUDA"):
            tcore.Device(backend)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.Device("cuda", device="cuda")
    with pytest.raises(ValueError, match="on the card"):
        tcore.Device("cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        tcore.Device("pallas", device="cpu")
    assert tcore.Device("loops", device="cpu").device == torch.device("cpu")
    assert tcore.resolve_model(None, "cpu") == ("torch", torch.device("cpu"))
    assert tcore.default_device("torch", "cpu") is tcore.default_device(
        "torch", torch.device("cpu"))


def test_the_cuda_backend_binds_the_six_specs():
    """The six specs of the apps, matmul and rmsnorm, and since the
    attention, head and scan builders joined them, every builder's spec:
    each bound to the wrapper of its hand-written kernel."""
    table = tcore.bound_specs()
    assert sorted(table) == [
        "dg_swe_surface", "dg_swe_volume", "fd2d", "flash_attention_bwd",
        "flash_attention_fwd", "flash_decode", "flash_decode_paged",
        "flash_delta", "lm_head_ce", "lm_head_ce_bwd", "lm_head_logits",
        "matmul", "ring_flash_bwd", "ring_flash_fwd", "rmsnorm", "sem_ax",
        "ssm_scan"]
    from repro_torch.kernels import KERNELS
    for name, b in table.items():
        assert b.wrapper in KERNELS.values(), name
    assert table["matmul"].fixed_defines == ("bm", "bn", "bk")
    assert table["matmul"].copies and table["rmsnorm"].copies
    assert table["rmsnorm"].fixed_defines == ("block_rows",)
    assert not table["fd2d"].copies and table["fd2d"].launch_defines == (
        "weights", "dx", "dt", "bh", "bw")
    with pytest.raises(ValueError, match="already has a cuda binding"):
        tcore.bind_cuda("fd2d", wrapper=None, launch=None, refusal=None,
                        launch_defines=())


def _expand_cuda(builder, defines):
    D = tcore.defines_namespace(defines)
    return tlang.expand(builder(D), D, "cuda")


def test_cuda_expansion_raises_for_an_unbound_spec():
    with pytest.raises(ValueError, match="no cuda binding.*'torch', 'loops'"):
        _expand_cuda(_saxpy, dict(n=16, bn=8, alpha=1.0))


def test_cuda_expansion_refuses_what_the_wrappers_refuse():
    from repro_torch.apps.dg_swe import dg_surface_builder, dg_volume_builder
    from repro_torch.apps.fd2d import fd2d_builder
    from repro_torch.apps.sem import sem_builder
    from repro_torch.kernels.matmul import matmul_builder
    from repro_torch.kernels.rmsnorm import rmsnorm_builder

    fd = dict(w=32, h=32, bh=8, bw=32, r=1, dt=0.1, dx=0.1,
              weights=(1.0, -2.0, 1.0), dtype="float32")
    fn = _expand_cuda(fd2d_builder, fd)                 # a valid binding
    assert fn.binding.name == "fd2d"
    w9 = tuple([0.1] * 19)
    bad = [
        (fd2d_builder, dict(fd, dtype="float64"), "float32"),
        (fd2d_builder, dict(fd, r=9, weights=w9, bh=32), "2r \\+ 1"),
        (sem_builder, dict(E=4, nq=25, eb=2, dtype="float32"), "nq <= 24"),
        (dg_volume_builder, dict(E=4, np_=6, eb=2, g=9.81, dtype="float64"),
         "float32"),
        (dg_surface_builder, dict(E=8192, np_=300, nfp3=72, eb=8192, g=9.81,
                                  dtype="float32"), "shared memory"),
        (matmul_builder, dict(M=8, K=8, N=8, bm=8, bk=8, bn=8,
                              dtype="float64"), "float32"),
        (rmsnorm_builder, dict(rows=4, d=8, block_rows=4, eps=1e-6,
                               dtype="float16", wdtype="float32"),
         "float16"),
    ]
    for builder, defines, why in bad:
        with pytest.raises(ValueError, match="refuses these defines.*" + why):
            _expand_cuda(builder, defines)


# ---------------------------------------------------------------------------
# rejected specs: JAX's finding codes and messages
# ---------------------------------------------------------------------------

def _copy_body(ctx, x, y):
    y[...] = x[...]


def _spec(pkg, name, *, grid=(4,), x=None, y=None, **kw):
    x = x or dict(shape=(16,), block=(4,))
    y = y or dict(shape=(16,), block=(4,))
    return pkg.Spec(name, grid=grid,
                    inputs=[pkg.Tile("x", dtype="float32", **x)],
                    outputs=[pkg.Tile("y", dtype="float32", **y)],
                    body=kw.pop("body", _copy_body), **kw)


def _sharded(pkg, shard, y):
    return _spec(pkg, "sharded", grid=(2, 2), reduce_axes=(1,),
                 x=dict(shape=(8, 8), block=(4, 4),
                        index=lambda i, r: (i, r)),
                 y=y, shard=shard(pkg))


_RING = dict(shape=(8, 8), block=(4, 4), index=lambda i, r: (i, r),
             stream=True)
_ACC = dict(shape=(8,), block=(4,), index=lambda i, r: (i,))

# name -> (spec factory over a package, the finding codes or the
# ValueError message both packages give)
BAD = {
    "race": (lambda p: _spec(p, "race", y=dict(
        shape=(16,), block=(4,), index=lambda i: (i // 2,))),
        {"RACE_PARALLEL_WRITE"}),
    "unwritten": (lambda p: _spec(p, "holes", grid=(2,)),
                  {"COVERAGE_UNWRITTEN"}),
    "acc_index": (lambda p: _spec(
        p, "bad_r", grid=(2, 2), reduce_axes=(1,),
        x=dict(shape=(8, 8), block=(4, 4), index=lambda i, kk: (i, kk)),
        y=dict(shape=(8, 8), block=(4, 4), index=lambda i, kk: (i, kk))),
        {"SEMANTICS_ACC_INDEX"}),
    "oob_output": (lambda p: _spec(p, "oob", y=dict(
        shape=(16,), block=(4,), index=lambda i: (i + 1,))),
        {"BOUNDS_INDEX"}),
    "oob_input": (lambda p: _spec(
        p, "oob_in", grid=(2, 2),
        x=dict(shape=(8, 8), block=(4, 4), index=lambda i, j: (i, j + 2)),
        y=dict(shape=(8, 8), block=(4, 4))), {"BOUNDS_INDEX"}),
    "oob_halo": (lambda p: _spec(p, "halo9", grid=(2, 2), x=dict(
        shape=(8, 8), block=(4, 4), halo=(9, 0)),
        y=dict(shape=(8, 8), block=(4, 4))), {"BOUNDS_HALO"}),
    "scratch": (lambda p: _spec(p, "scr0", scratch=[p.Scratch((0,), "float32")]),
                {"BOUNDS_SCRATCH"}),
    "ring_no_rotate": (lambda p: _sharded(p, lambda q: q.ShardAxis(
        "sp", axis=1, extent=2), _RING), {"COLLECTIVE_UNDECLARED",
                                          "RACE_MESH_WRITE"}),
    "mesh_race": (lambda p: _sharded(p, lambda q: q.ShardAxis(
        "sp", axis=1, extent=2, rotate=("x",)), _RING), {"RACE_MESH_WRITE"}),
    "no_collective": (lambda p: _sharded(p, lambda q: q.ShardAxis(
        "sp", axis=1, extent=2, collective=None), _ACC),
        {"COLLECTIVE_UNDECLARED"}),
    "nondividing": (lambda p: _spec(p, "bad2", grid=(3,), x=dict(
        shape=(16,), block=(5,)), y=dict(shape=(16,), block=(5,))),
        "does not divide"),
    "halo_on_output": (lambda p: _spec(p, "bad", grid=(2,), x=dict(
        shape=(8,), block=(4,)), y=dict(shape=(8,), block=(4,), halo=(1,))),
        "input-only"),
    "stream_on_input": (lambda p: _spec(p, "bad_in", grid=(2,), x=dict(
        shape=(8,), block=(4,), stream=True), y=dict(shape=(8,), block=(4,))),
        "output-only"),
    "shard_not_reduce": (lambda p: _sharded(p, lambda q: q.ShardAxis(
        "sp", axis=0, extent=2), _ACC), "is not a reduce axis"),
    "shard_unknown_tile": (lambda p: _sharded(p, lambda q: q.ShardAxis(
        "sp", axis=1, extent=2, rotate=("k",)), _ACC), "unknown input tiles"),
    "non_trailing_reduce": (lambda p: _spec(
        p, "bad_axis", grid=(2, 2), reduce_axes=(0,),
        x=dict(shape=(8, 8), block=(4, 4)), y=dict(shape=(8, 8), block=(4, 4))),
        "trailing"),
    "semantics_length": (lambda p: _spec(
        p, "sem_len", dimension_semantics=("parallel",) * 2),
        "dimension_semantics"),
}


def _table(pkg, *, dtype="int32", block=(1,)):
    return pkg.Spec(
        "bad_table", grid=(4,),
        inputs=[pkg.Tile("t", (4,), dtype, block=block,
                         index=lambda i: (i // block[0],)),
                pkg.Tile("x", (16,), "float32", block=(4,),
                         index=lambda i: (0,), index_tile=("t", 0))],
        outputs=[pkg.Tile("y", (16,), "float32", block=(4,))],
        body=lambda ctx, t, x, y: y.__setitem__(Ellipsis, x[...]))


BAD["table_dtype"] = (lambda p: _table(p, dtype="float32"), {"BOUNDS_TABLE"})
BAD["table_block"] = (lambda p: _table(p, block=(2,)), {"BOUNDS_TABLE"})


def _raised(build):
    with pytest.raises(ValueError) as ei:
        build()
    return ei.value


@pytest.mark.parametrize("case", sorted(BAD))
def test_rejected_specs_give_the_jax_verdict(case):
    make, want = BAD[case]
    errs = [_raised(lambda: jcore.Device("jnp").build_kernel(
        lambda D: make(jcore), {}))]
    errs += [_raised(lambda: _cpu(be).build_kernel(lambda D: make(tcore), {}))
             for be in PORT]
    for e in errs:
        if isinstance(want, set):
            assert {f.code for f in e.findings} == want, str(e)
        else:
            assert want in str(e), str(e)
    if isinstance(want, set):                  # the same messages as JAX
        assert [str(f) for f in errs[1].findings] == \
            [str(f) for f in errs[0].findings]
        assert isinstance(errs[1], tcore.AnalysisError)


def test_parallel_reduce_axis_with_carried_state_rejected_at_build():
    def make(pkg, xp):
        def body(ctx, x, out):
            acc, = ctx.scratch

            @ctx.when(ctx.is_first)
            def _init():
                acc[...] = (jnp.zeros((1,), jnp.float32) if xp is jnp else
                            torch.zeros(1))

            acc[...] += x[...].sum() * (jnp.ones((1,)) if xp is jnp else
                                        torch.ones((1,)))

            @ctx.when(ctx.is_last)
            def _flush():
                out[...] = acc[...]

        return pkg.Spec(
            "badsem", grid=(4,), reduce_axes=(0,),
            dimension_semantics=("parallel",),
            scratch=[pkg.Scratch((1,), "float32")],
            inputs=[pkg.Tile("x", (16,), "float32", block=(4,),
                             index=lambda r: (r,))],
            outputs=[pkg.Tile("out", (1,), "float32", block=(1,),
                              index=lambda r: (0,))],
            body=body)

    errs = [_raised(lambda: jcore.Device("jnp").build_kernel(
        lambda D: make(jcore, jnp), {}))]
    errs += [_raised(lambda: _cpu(be).build_kernel(
        lambda D: make(tcore, torch), {})) for be in PORT]
    for e in errs:
        assert {f.code for f in e.findings} == {"SEMANTICS_PARALLEL_CARRIED"}
    assert str(errs[1]) == str(errs[0])


def test_analyzer_messages_name_the_cell_axis_and_window():
    e = _raised(lambda: _cpu().build_kernel(lambda D: BAD["oob_output"][0](
        tcore), {}))
    assert "cell (3,)" in str(e) and "axis 0" in str(e) and \
        "block index 4" in str(e)
    e = _raised(lambda: _cpu().build_kernel(lambda D: _spec(
        tcore, "h", grid=(2, 4), x=dict(shape=(8, 16), block=(4, 4),
                                        halo=(0, 17)),
        y=dict(shape=(8, 16), block=(4, 4))), {}))
    assert "halo radius 17 on axis 1" in str(e) and "extent 16" in str(e)
    f = e.findings[0]
    assert f.severity == "error" and f.subject == "x"
    rep = tcore.Report("h", list(e.findings))
    with pytest.raises(tcore.AnalysisError):
        rep.emit("error")
    with pytest.warns(tcore.AnalysisWarning, match="BOUNDS_HALO"):
        rep.emit("warn")
    rep.emit("off")
    assert not rep.ok and rep.errors == list(e.findings)
    assert tcore.ANALYZE_MODES == jcore.ANALYZE_MODES
    from repro.core import analyze as janalyze
    # the footprint's code names the H100's shared memory, not the TPU's
    # VMEM; every other code and severity is the JAX analyzer's
    assert tcore.SEVERITY == {k.replace("VMEM_", "SMEM_"): v
                              for k, v in janalyze.SEVERITY.items()}


def test_language_modules_import_no_jax_or_repro():
    import ast
    import os

    core = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "src", "repro_torch", "core")
    for name in ("analyze", "cuda", "device", "kernel", "lang", "memory"):
        tree = ast.parse(open(os.path.join(core, name + ".py")).read())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
        mods += [n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert not [m for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "repro")], name
