"""The port's cost model (``repro_torch.core.analyze``: shared-memory
footprint, device-memory bytes, FLOPs) against the JAX package's
(tests/test_cost.py): the golden costs of matmul, flash_decode and
lm_head_ce, and every builder's costs at its op's example defines, equal
to JAX's ``estimate_cost`` (footprint, bytes, FLOPs; the one difference,
listed: the attention backwards write dk and dv summed over each kv
head's group, as ``flash_bwd`` does, so their output bytes are the group
sum's). Then the budget and its override, the seeded defects, the cost
model's pruning on the torch backend (never changes the winner under a
timer that follows the model; a pruned candidate is never built), and
winner hygiene: ``tune_cli --lint`` flags, and adoption skips, a winner
whose spec overflows the current budget."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 -- registers the JAX ops
from repro.core import estimate_cost as jax_cost
from repro.core import registered_ops as jax_ops
from repro.kernels.flash_attention import kernel as jk
from repro.kernels.lm_head import kernel as jl

from repro_torch import tune_cli
from repro_torch.core import (AnalysisError, DEFAULT_SMEM_BUDGET, Device,
                              Spec, Tile, autotune, check_built_spec,
                              defines_namespace, estimate_cost, get_op,
                              prune_by_cost, registered_ops, smem_budget,
                              smem_footprint, target_key, to_tensors)
from repro_torch.core import tune as tune_mod
from repro_torch.kernels.flash_attention import kernel as tk
from repro_torch.kernels.lm_head import kernel as tl
from repro_torch.kernels.matmul import matmul_builder
from repro_torch.launch import tuning

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("REPRO_SMEM_BUDGET", raising=False)


def _ns(d):
    return defines_namespace(d)


# ---------------------------------------------------------------------------
# golden costs, equal to JAX's
# ---------------------------------------------------------------------------

def _matmul_defines(n=64, b=32):
    return dict(M=n, K=n, N=n, bm=b, bk=b, bn=b, dtype="float32")


def test_matmul_golden_cost():
    # closed forms (tests/test_cost.py): 2 M N K + M N (K / bk) FLOPs, a
    # and b fetched once per j / per i, c written once, 3 double-buffered
    # blocks + the f32 scratch
    D = _matmul_defines()
    rep = estimate_cost(matmul_builder(_ns(D)), _ns(D))
    assert rep.flops == 2 * 64**3 + 64 * 64 * 2 == 532480
    assert rep.bytes_in == 4 * 64**3 // 32 * 2 == 65536
    assert rep.bytes_out == 4 * 64 * 64 == 16384
    assert rep.smem_bytes == 3 * 2 * 32 * 32 * 4 + 32 * 32 * 4 == 28672
    assert rep.hbm_bytes == rep.bytes_in + rep.bytes_out
    assert rep.intensity == pytest.approx(rep.flops / rep.hbm_bytes)
    assert rep.findings == []


def test_flash_decode_golden_cost():
    D = dict(b=1, h=4, hk=2, skv=512, d=32, dv=32, block_kv=128,
             window=None, sm_scale=float(1 / np.sqrt(32)), dtype="float32")
    rep = estimate_cost(tk.flash_decode_builder(_ns(D)), _ns(D))
    assert (rep.smem_bytes, rep.bytes_in, rep.bytes_out, rep.flops) == (
        68228, 532996, 512, 273616)
    assert rep.findings == []


def test_lm_head_ce_golden_cost():
    """JAX's golden numbers; at 723,968 B its tiles overflow the H100's
    shared memory a block (a TPU core has 16 MB of VMEM)."""
    D = dict(R=256, d=128, V=512, vocab=500, block_r=128, block_v=256,
             block_k=128, emit_logits=False, dtype="float32")
    rep = estimate_cost(tl.lm_head_builder(_ns(D)), _ns(D))
    assert (rep.smem_bytes, rep.bytes_in, rep.bytes_out, rep.flops) == (
        723968, 656384, 2048, 34344448)
    assert [f.code for f in rep.findings] == ["SMEM_OVERFLOW"]


_AUX = {"flash_attention": [(tk.flash_delta_builder, jk.flash_delta_builder),
                            (tk.flash_bwd_builder, jk.flash_bwd_builder)],
        "ring_flash": [(tk.ring_flash_bwd_builder,
                        jk.ring_flash_bwd_builder)],
        "lm_head_ce": [(tl.lm_head_bwd_builder, jl.lm_head_bwd_builder)]}
# the specs whose output bytes differ from JAX's, and why
_GROUP_SUMMED = {"flash_attention_bwd", "ring_flash_bwd"}


@pytest.mark.parametrize("name", sorted(jax_ops()))
def test_every_builder_costs_what_jax_does(name):
    op = get_op(name)
    args, params = to_tensors(*op.example(np.random.RandomState(0)), "cpu")
    _, params = op._resolve(params)
    D = op.derive_defines(args, params)
    for tb, jb in [(op.builder, jax_ops()[name].builder)] + _AUX.get(name,
                                                                     []):
        got = estimate_cost(tb(_ns(D)), _ns(D))
        want = jax_cost(jb(_ns(D)), _ns(D))
        assert got.smem_bytes == want.vmem_bytes, got.spec
        assert got.bytes_in == want.bytes_in, got.spec
        assert got.flops == want.flops and got.flops, got.spec
        if got.spec in _GROUP_SUMMED:
            b, h, hk = D["b"], D["h"], D["hk"]
            # dq as JAX's; dk, dv f32 at hk heads, not h
            per_head = b * D["skv"] * (D["d"] + D["dv"]) * 4
            assert want.bytes_out - got.bytes_out == (h - hk) * per_head
        else:
            assert got.bytes_out == want.bytes_out, got.spec


# ---------------------------------------------------------------------------
# the budget, its override, and the seeded defects
# ---------------------------------------------------------------------------

def _whole_array_builder(D):
    """One grid cell, whole-array tiles: footprint 2 n n 4 bytes."""
    def body(ctx, x, y):
        y[...] = x[...] * 2.0
    n = D.n
    return Spec("whole", grid=(1,),
                inputs=[Tile("x", (n, n), "float32", block=(n, n),
                             index=lambda i: (0, 0))],
                outputs=[Tile("y", (n, n), "float32", block=(n, n),
                              index=lambda i: (0, 0))],
                body=body)


def test_smem_budget_env_override(monkeypatch):
    assert smem_budget() == DEFAULT_SMEM_BUDGET == 232448
    from repro_torch.kernels.apps._common import SMEM_MAX
    assert DEFAULT_SMEM_BUDGET == SMEM_MAX
    for raw, want in (("128M", 128 * 2**20), ("2G", 2 * 2**30),
                      ("4096", 4096), ("64K", 64 * 2**10)):
        monkeypatch.setenv("REPRO_SMEM_BUDGET", raw)
        assert smem_budget() == want
    for bad in ("garbage", "-1", "0", "1.5M"):
        monkeypatch.setenv("REPRO_SMEM_BUDGET", bad)
        with pytest.raises(ValueError):
            smem_budget()


@pytest.mark.parametrize("backend", ["torch", "loops"])
def test_seeded_smem_overflow_rejected_on_build(backend, monkeypatch):
    # 200 x 200 f32 = 160 KB a tile, 320 KB resident > 227 KB
    total, detail = smem_footprint(_whole_array_builder(SimpleNamespace(
        n=200)))
    assert total == 2 * 200 * 200 * 4 and set(detail) == {"x", "y"}
    with pytest.raises(AnalysisError, match="SMEM_OVERFLOW"):
        Device(backend, device="cpu").build_kernel(_whole_array_builder,
                                                   dict(n=200))
    monkeypatch.setenv("REPRO_SMEM_BUDGET", "1M")    # a raised budget admits it
    out, = Device(backend, device="cpu").build_kernel(
        _whole_array_builder, dict(n=200)).run(torch.ones(200, 200))
    assert float(out[0, 0]) == 2.0


def test_cuda_builds_report_the_footprint_without_raising():
    """The cuda backend's hook keeps the footprint finding in its report
    (the binding's own limits gate the build); torch and loops raise."""
    D = SimpleNamespace(n=200)
    spec = _whole_array_builder(D)
    rep = check_built_spec(spec, D, gate_footprint=False)
    assert [f.code for f in rep.findings] == ["SMEM_OVERFLOW"]
    with pytest.raises(AnalysisError, match="SMEM_OVERFLOW"):
        check_built_spec(spec, D)


def test_seeded_redundant_fetch_flagged():
    """A reduce sweep kk = 0..3 whose input map revisits block kk % 2 (0, 1,
    0, 1: four runs over two blocks): flagged and costed."""
    def builder(D):
        def body(ctx, x, y):
            y[...] = x[...][:1]
        return Spec("refetch", grid=(2, 4), reduce_axes=(1,),
                    inputs=[Tile("x", (8, 4), "float32", block=(2, 4),
                                 index=lambda i, kk: (kk % 2, 0))],
                    outputs=[Tile("y", (2, 4), "float32", block=(1, 4),
                                  index=lambda i, kk: (i, 0))],
                    body=body)

    rep = estimate_cost(builder(SimpleNamespace()), flops=False)
    assert "REDUNDANT_FETCH" in [f.code for f in rep.findings]
    assert rep.bytes_in == 8 * 2 * 4 * 4


# ---------------------------------------------------------------------------
# pruning on the torch backend: the winner never changes
# ---------------------------------------------------------------------------

@pytest.fixture
def model_timer(monkeypatch):
    """Times a candidate by its spec's cost terms (a dominated candidate,
    >= on both and > on one, times strictly worse), recording builds."""
    built = []
    real_build = Device.build_kernel

    def build(self, builder, defines=None, **kw):
        k = real_build(self, builder, defines, **kw)
        built.append(k)
        return k

    def timed(fn, device, *, warmup, repeats):
        out = fn()
        k = built[-1]
        rep = estimate_cost(k.spec, _ns(k.defines))
        return (rep.hbm_bytes + rep.flops) * 1e-12, out

    monkeypatch.setattr(Device, "build_kernel", build)
    monkeypatch.setattr(tune_mod, "_time", timed)
    return built


def test_dominated_candidates_are_never_built(model_timer):
    rng = np.random.RandomState(0)
    a, b = (torch.from_numpy(rng.standard_normal((64, 64)).astype(
        np.float32)) for _ in range(2))
    defines = _matmul_defines()
    sweep = dict(bm=[32, 64], bn=[32, 64], bk=[32, 64])
    dev = Device("torch", device="cpu")

    def run(knobs):
        return dev.build_kernel(matmul_builder,
                                dict(defines, **knobs)).run(a, b)

    kw = dict(sweep=sweep, device=CPU, target=target_key(CPU, "torch"),
              name="matmul", ref=lambda: a @ b, repeats=1)
    r = autotune(run, defines, prune=lambda d, s: prune_by_cost(
        matmul_builder, d, s), **kw)
    # as in JAX: bk = 32 adds accumulate FLOPs at equal bytes, bm = bn = 32
    # moves more bytes: 5 of 8 dominated; the three ties are all timed
    assert r["bk"] == 64 and 64 in (r["bm"], r["bn"])
    assert len(r.pruned) == 5 and len(r.trials) == 3
    assert all("prune[DOMINATED]" in why for _, why in r.pruned)
    assert dev.stats.builds == 3
    everything = autotune(run, defines, **kw)
    assert len(everything.trials) == 8
    assert {k: everything[k] for k in sweep} == {k: r[k] for k in sweep}


def test_op_tune_prunes_on_torch_same_winner(model_timer):
    op = get_op("fd2d")
    rng = np.random.RandomState(1)
    u1, u2 = (torch.from_numpy(rng.standard_normal((64, 64)).astype(
        np.float32)) for _ in range(2))
    kw = dict(weights=(1.0, -2.0, 1.0), dx=0.1, dt=0.01)
    sweep = dict(bh=[8, 16, 32], bw=[32, 64])
    r = op.tune((u1, u2), sweep=sweep, cache=False, repeats=1, **kw)
    r2 = op.tune((u1, u2), sweep=sweep, cache=False, repeats=1, prune=False,
                 **kw)
    assert r.pruned and not r2.pruned and len(r2.trials) == 6
    assert {k: r[k] for k in sweep} == {k: r2[k] for k in sweep}


# ---------------------------------------------------------------------------
# winner hygiene under the budget
# ---------------------------------------------------------------------------

def _fd_tuned(op):
    rng = np.random.RandomState(2)
    args = tuple(torch.from_numpy(rng.standard_normal((32, 32)).astype(
        np.float32)) for _ in range(2))
    kw = dict(weights=(1.0, -2.0, 1.0), dx=0.1, dt=0.01)
    r = op.tune(args, sweep=dict(bh=[32], bw=[32]), repeats=1, **kw)
    assert (r["bh"], r["bw"]) == (32, 32)
    return args, kw


def test_lint_evicts_an_overflowing_winner(tmp_path, monkeypatch, capsys):
    _fd_tuned(get_op("fd2d"))
    root = tmp_path / "autotune_torch"
    assert len(list(root.glob("*.json"))) == 1
    assert tune_cli.main(["--lint"]) == 0            # fits: clean
    monkeypatch.setenv("REPRO_SMEM_BUDGET", "8K")     # it needs 12,816 B
    capsys.readouterr()
    assert tune_cli.main(["--lint"]) == 1
    assert "SMEM_OVERFLOW" in capsys.readouterr().out
    assert tune_cli.main(["--lint", "--evict"]) == 0
    assert list(root.glob("*.json")) == []


def test_adoption_skips_an_overflowing_winner(monkeypatch):
    op = get_op("fd2d")
    args, kw = _fd_tuned(op)
    r = op.tune(args, repeats=1, **kw)       # the op's own sweep: adoptable
    metas = tuple(torch.empty(a.shape, dtype=a.dtype, device="meta")
                  for a in args)
    probes = {"fd2d": (metas, kw)}
    assert tuning.adopt_winners(probes, device="cpu") == {
        "fd2d": {"bh": r["bh"], "bw": r["bw"]}}
    # every tile of a 32 x 32 field needs more than 4 KB
    monkeypatch.setenv("REPRO_SMEM_BUDGET", "4K")
    got = tuning.adopt_winners(probes, device="cpu")
    assert got == {} and "shared memory" in got.refused["fd2d"]


def test_registry_examples_fit_the_budget():
    """Every registered op's example defines pass the cost model with no
    finding: the examples' tiles fit the H100's shared memory a block."""
    for name, op in sorted(registered_ops().items()):
        args, params = to_tensors(*op.example(np.random.RandomState(0)),
                                  "cpu")
        _, params = op._resolve(params)
        D = op.derive_defines(args, params)
        rep = estimate_cost(op.builder(_ns(D)), _ns(D))
        assert rep.findings == [], (name, rep.findings)
