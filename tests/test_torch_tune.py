"""Autotuning in the port (``repro_torch.core.tune``, ``Op.tune``,
``launch.tuning``, ``tune_cli``) on the CPU, where a sweep times the
spec's torch expansion and is keyed ``backend="torch"``,
``device="cpu"``. Mirrors the
JAX package's tests of its persisted cache (tests/test_define_op.py),
adoption (tests/test_flash_unified_bwd_decode.py, tests/test_lm_head.py),
the apps' winners (tests/test_apps.py) and pruning and linting
(tests/test_cost.py), at reduced f32 shapes."""

import json
import shutil

import numpy as np
import pytest
import torch

from repro_torch import tune_cli
from repro_torch.apps import dg_swe, fd2d as fd_app, sem as sem_app
from repro_torch.configs import get_config, reduced
from repro_torch.core import (SCHEMA_VERSION, autotune, get_op,
                              prune_candidates, target_key, to_tensors,
                              tune_cache_key)
from repro_torch.core import tune as tune_mod
from repro_torch.kernels import _build
from repro_torch.launch import tuning
from repro_torch.launch.serve import apply_tuned_winners, generate
from repro_torch.launch.train import TrainLoop
from repro_torch.models import LM
from repro_torch.serving import Engine

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    return tmp_path / "autotune_torch"


def _fd_args(h=32, w=32, seed=0):
    rng = np.random.RandomState(seed)
    u1, u2 = (torch.from_numpy(rng.standard_normal((h, w)).astype("float32"))
              for _ in range(2))
    return (u1, u2), dict(weights=(1.0, -2.0, 1.0), dx=0.1, dt=0.01)


def _meta(args):
    return tuple(torch.empty(a.shape, dtype=a.dtype, device="meta")
                 for a in args)


def _entries(cache):
    return sorted(cache.glob("*.json")) if cache.is_dir() else []


def test_warm_cache_skips_the_sweep_and_the_plain_version(cache,
                                                          monkeypatch):
    op = get_op("fd2d")
    args, kw = _fd_args()
    sweep = {"bh": [8, 16], "bw": [32]}
    calls = {"n": 0}
    real = op.tune_ref          # the plain version a candidate is held to

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(op, "tune_ref", counting)
    r1 = op.tune(args, sweep=sweep, repeats=1, **kw)
    # on the torch expansion the cost model may prune a dominated tile
    # (bh = 8 fetches more halo rows than bh = 16 for the same FLOPs)
    assert not r1.cached and r1.skipped == r1.pruned
    assert len(r1.trials) + len(r1.pruned) == 2 and r1.trials
    assert r1["h"] == 32 and r1["bw"] == 32     # winner over the defines
    (path,) = _entries(cache)
    saved = json.loads(path.read_text())
    assert saved["op"] == "fd2d" and saved["schema"] == SCHEMA_VERSION
    assert saved["backend"] == "torch" and saved["device"] == "cpu"
    assert saved["winner"] == {"bh": r1["bh"], "bw": 32}
    n = calls["n"]
    with monkeypatch.context() as m:
        m.setattr(tune_mod, "_time", None)        # a timing would raise
        r2 = op.tune(args, sweep=sweep, repeats=1, **kw)
    assert r2.cached and r2.trials == [] and calls["n"] == n
    assert {k: r2[k] for k in sweep} == {k: r1[k] for k in sweep}
    # another shape, and a narrower sweep, are other problems
    assert not op.tune(_fd_args(16, 32)[0], sweep=sweep, repeats=1,
                       **kw).cached
    r4 = op.tune(args, sweep={"bh": [16], "bw": [32]}, repeats=1, **kw)
    assert not r4.cached and r4["bh"] == 16


def test_validation_skips_a_wrong_candidate():
    """Each candidate is held against the plain version: a wrong one is
    skipped with its reason, never chosen; a lone wrong one raises. The
    plain version is required: no candidate answers for itself."""
    x = torch.zeros(16)

    def run(knobs):
        return x + (1.0 if knobs["bn"] == 4 else 0.0)   # bn=4 is wrong

    kw = dict(sweep={"bn": [4, 8]}, device=CPU,
              target=target_key(CPU, "torch"), name="toy", repeats=1)
    r = autotune(run, dict(n=16), ref=lambda: x, **kw)
    assert r["bn"] == 8 and len(r.trials) == 1
    ((cand, reason),) = r.skipped
    assert cand["bn"] == 4 and reason.startswith("validation:")
    with pytest.raises(ValueError, match="no valid candidate"):
        autotune(run, dict(n=16), ref=lambda: x,
                 **dict(kw, sweep={"bn": [4]}))
    with pytest.raises(TypeError, match="ref"):
        autotune(run, dict(n=16), **dict(kw, sweep={"bn": [4]}))


def test_cpu_winners_never_answer_for_the_card(cache):
    op = get_op("fd2d")
    args, kw = _fd_args()
    sweep = {"bh": [8], "bw": [32]}
    op.tune(args, sweep=sweep, repeats=1, **kw)
    defines = op.derive_defines(args, dict(op.defaults, **kw))
    cpu = target_key(CPU, "torch", op.sources)
    card = dict(cpu, backend="cuda", device="NVIDIA H100 80GB HBM3",
                build_hash=_build.source_hash(*op.sources))
    assert tune_mod.cached_winner("fd2d", defines, sweep, cpu) is not None
    assert tune_mod.cached_winner("fd2d", defines, sweep, card) is None
    assert (tune_cache_key("fd2d", defines, sweep, cpu)[0]
            != tune_cache_key("fd2d", defines, sweep, card)[0])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        op.cached_winner(_meta(args), device="cpu", backend="cuda",
                         sweep=sweep, **kw)


def test_an_edited_kernel_source_is_another_problem(tmp_path, monkeypatch):
    """The card's key holds the build hash of the op's sources: an edited
    .cu (or shared header) must not answer with the old winner."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", str(src))
    before = target_key(CPU, "cuda", ("fd2d",))
    assert before["build_hash"] == _build.source_hash("fd2d")
    with open(src / "fd2d.cu", "a") as f:
        f.write("\n// edited\n")
    after = target_key(CPU, "cuda", ("fd2d",))
    assert after["build_hash"] != before["build_hash"]
    sweep, d = {"bh": [8]}, dict(h=8, w=8, r=1, dtype="float32")
    assert tune_cache_key("fd2d", d, sweep, before)[0] != tune_cache_key(
        "fd2d", d, sweep, after)[0]
    assert target_key(CPU, "torch", ("fd2d",))["build_hash"] is None


def test_cached_winner_is_a_pure_lookup(monkeypatch):
    op = get_op("sem_apply")
    args, kw = to_tensors(*op.example(np.random.RandomState(0)), "cpu")
    kw.pop("eb")
    assert op.cached_winner(args, **kw) is None
    r = op.tune(args, repeats=1, **kw)

    def boom(*a, **k):
        raise AssertionError("a lookup ran something")

    for name in ("builder", "ref", "tune_ref"):
        monkeypatch.setattr(op, name, boom)
    monkeypatch.setattr(tune_mod, "_time", boom)
    assert op.cached_winner(_meta(args), device="cpu") == {"eb": r["eb"]}


@pytest.mark.parametrize("fault", ["corrupt", "schema", "payload",
                                   "winner"])
def test_unusable_entries_are_evicted(cache, fault):
    op = get_op("fd2d")
    args, kw = _fd_args()
    sweep = {"bh": [8, 16], "bw": [32]}
    op.tune(args, sweep=sweep, repeats=1, **kw)
    (path,) = _entries(cache)
    entry = json.loads(path.read_text())
    if fault == "corrupt":
        path.write_text("{not json")
    else:
        if fault == "schema":
            entry["schema"] = SCHEMA_VERSION + 1
        elif fault == "payload":
            entry["defines"]["h"] = 999
        else:
            del entry["winner"]["bh"]
        path.write_text(json.dumps(entry))
    assert op.cached_winner(args, sweep=sweep, **kw) is None
    assert not path.exists()
    assert not op.tune(args, sweep=sweep, repeats=1, **kw).cached


def test_every_candidate_pruned_is_a_clear_error(monkeypatch):
    op = get_op("fd2d")
    args, kw = _fd_args()
    common = __import__("sys").modules["repro_torch.kernels.apps._common"]
    with monkeypatch.context() as m:
        # on the CPU the torch expansion is pruned by the spec's footprint
        # against the shared-memory budget (a smaller card)
        m.setenv("REPRO_SMEM_BUDGET", "1024")
        with pytest.raises(ValueError, match="statically pruned"):
            op.tune(args, cache=False, **kw)
    wide, _ = _fd_args(32, 512)         # the tile is clipped to the field
    defines = op.derive_defines(wide, dict(op.defaults, **kw))
    monkeypatch.setattr(common, "SMEM_MAX", op.smem(dict(defines, bh=8,
                                                         bw=32)))
    kept, pruned = prune_candidates(defines, {"bh": [8], "bw": [32, 256]},
                                    op.smem)
    assert [c["bw"] for c in kept] == [32]
    ((cand, reason),) = pruned
    assert cand["bw"] == 256 and reason.startswith("prune[SMEM_OVERFLOW]")


def test_lint_evicts_a_winner_the_wrapper_now_refuses(cache, monkeypatch,
                                                      capsys):
    op = get_op("fd2d")
    args, kw = _fd_args()
    op.tune(args, sweep={"bh": [16], "bw": [32]}, repeats=1, **kw)
    assert tune_cli.main(["--lint"]) == 0
    fd_mod = __import__("sys").modules["repro_torch.kernels.apps.fd2d"]
    monkeypatch.setattr(fd_mod, "SMEM_MAX", 1024)   # a smaller card
    capsys.readouterr()
    assert tune_cli.main(["--lint"]) == 1
    assert "refuses the winner" in capsys.readouterr().out
    assert tune_cli.main(["--lint", "--evict"]) == 0
    assert _entries(cache) == []


def test_adoption_never_takes_a_refused_winner(monkeypatch):
    op = get_op("fd2d")
    args, kw = _fd_args()
    r = op.tune(args, repeats=1, **kw)
    probes = {"fd2d": (_meta(args), kw)}
    got = tuning.adopt_winners(probes, device="cpu")
    assert got == {"fd2d": {"bh": r["bh"], "bw": r["bw"]}}
    assert got.knob("fd2d", "bh") == r["bh"]
    assert tuning.adopt_winners(probes, device="cpu", ops=()) == {}
    fd_mod = __import__("sys").modules["repro_torch.kernels.apps.fd2d"]
    monkeypatch.setattr(fd_mod, "SMEM_MAX", 1024)
    got = tuning.adopt_winners(probes, device="cpu")
    assert got == {} and "fd2d" in got.refused
    assert got.knob("fd2d", "bh") is None


def _reduced_llama():
    return reduced(get_config("llama3_2_1b"))


def _record_splits(monkeypatch):
    """The ``split`` each paged and static decode attention call of the
    model is given (on the CPU the wrappers run the plain versions)."""
    from repro_torch.layers import attention

    seen = {"paged": [], "static": []}
    for name, key in (("paged_decode_attention", "paged"),
                      ("flash_decode", "static")):
        real = getattr(attention, name)

        def rec(*a, _real=real, _key=key, **k):
            seen[_key].append(k.get("split"))
            return _real(*a, **k)
        monkeypatch.setattr(attention, name, rec)
    return seen


def test_serve_warmup_adopts_a_persisted_winner(monkeypatch):
    """A paged-decode winner tuned at the engine's probe shapes is adopted
    by the engine at construction and passed to every paged decode call
    of its step, and by generate; the engine looks up no other op's
    winner, and with ``use_tuned=False`` none; the static loop passes
    ``flash_decode``'s winner; a probe outside the kernel's domain is
    skipped and named."""
    cfg = _reduced_llama()
    b, plen, max_len = 2, 8, 64
    assert apply_tuned_winners(cfg, b, plen, max_len, device="cpu") == {}
    gen = torch.Generator().manual_seed(0)
    won = {}
    for name in ("flash_decode_paged", "flash_decode"):
        op = get_op(name)
        metas, params = tuning.serving_probes(cfg, b, plen, max_len)[name]
        real, params = tune_cli._materialize(
            metas, params, vocab=cfg.vocab_size, gen=gen, device=CPU)
        won[name] = {"split": op.tune(real, repeats=1, **params)["split"]}
    model = LM(cfg, device="cpu")
    params_m = model.init(torch.Generator().manual_seed(0))
    seen = _record_splits(monkeypatch)
    eng = Engine(model, params_m, batch=b, max_len=max_len)
    assert eng.tuned == {"flash_decode_paged": won["flash_decode_paged"]}
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (b, plen))
    _, stats = generate(model, params_m, prompts, gen_tokens=4,
                        max_len=max_len)
    assert stats["tuned"] == eng.tuned
    assert seen["paged"] and set(seen["paged"]) == {
        won["flash_decode_paged"]["split"]}
    seen["paged"].clear()
    plain = Engine(model, params_m, batch=b, max_len=max_len,
                   use_tuned=False)
    assert plain.tuned == {}
    plain.submit(prompts[0].tolist(), 2)
    plain.drain()
    assert seen["paged"] and set(seen["paged"]) == {None}
    _, stats = generate(model, params_m, prompts, gen_tokens=4,
                        max_len=max_len, engine="static")
    assert stats["tuned"] == {"flash_decode": won["flash_decode"]}
    assert set(seen["static"]) == {won["flash_decode"]["split"]}
    # the head dim 112 paged probe is outside the paged kernel's domain
    import dataclasses
    wide = dataclasses.replace(cfg, head_dim=112)
    got = apply_tuned_winners(wide, b, plen, max_len, device="cpu")
    assert "flash_decode_paged" in got.skipped and "head dim" in \
        got.skipped["flash_decode_paged"]


def test_decode_probes_take_measured_lengths():
    """The decode probes hold every cache full (the JAX package's probes);
    the paged one takes the live lengths the caller measured instead: one
    engine step's, an idle slot (0) reading the null page as the
    engine's do."""
    cfg = _reduced_llama()
    full = tuning.serving_probes(cfg, 2, 8, 64)
    _, kw = full["flash_decode_paged"]
    assert kw["kv_len"].tolist() == [64, 64]
    assert "kv_len" not in full["flash_decode"][1]
    got = tuning.serving_probes(cfg, 2, 8, 64, page_size=16,
                                paged_lens=[0, 40])
    _, kw = got["flash_decode_paged"]
    assert kw["kv_len"].tolist() == [1, 40]
    assert kw["block_table"][0].tolist() == [0, 0, 0, 0]
    pos = kw["pos_pages"]
    assert (pos[0] == -1).all()
    live = pos[kw["block_table"][1].long()].reshape(-1)
    assert live[:40].tolist() == list(range(40))
    assert int(((live >= 0) & (live < 40)).sum()) == 40
    with pytest.raises(ValueError, match="paged_lens"):
        tuning.serving_probes(cfg, 2, 8, 64, paged_lens=[10])


def test_train_warmup_adopts_before_its_step(monkeypatch):
    """TrainLoop looks up the winners of its train probes before it builds
    its step and returns them. (No op on the train path has a knob on
    Hopper yet, so the probes are given one that has.)"""
    cfg = _reduced_llama()
    op = get_op("fd2d")
    args, kw = _fd_args()
    r = op.tune(args, repeats=1, **kw)
    order = []
    real_probes = tuning.train_probes

    def probes(c, global_batch, seq_len):
        order.append(("probes", global_batch, seq_len))
        return dict(real_probes(c, global_batch, seq_len),
                    fd2d=(_meta(args), kw))

    monkeypatch.setattr(tuning, "train_probes", probes)
    from repro_torch.launch import train as train_mod
    real_build = train_mod.build_train_step
    monkeypatch.setattr(train_mod, "build_train_step", lambda *a, **k: (
        order.append(("build",)), real_build(*a, **k))[1])
    out = TrainLoop(model=LM(cfg, device="cpu"), global_batch=2, seq_len=16,
                    steps=1, verbose=False).run()
    assert order == [("probes", 2, 16), ("build",)]
    assert out["tuned"] == {"fd2d": {"bh": r["bh"], "bw": r["bw"]}}


def test_tune_cli_list_and_arch(cache, capsys):
    assert tune_cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "flash_decode_paged: sweep={'split'" in out
    assert "matmul: sweep=(none" in out
    argv = ["--arch", "llama3_2_1b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--max-len", "64",
            "--serve", "--repeats", "1"]
    code, results = tune_cli.run(argv)
    out = capsys.readouterr().out
    assert code == 0
    assert "[tune] flash_decode_paged: winner {'split':" in out
    assert "[tune] flash_decode: winner" in out and "5 trials" in out
    assert sorted(n for n, _ in results) == ["flash_decode",
                                             "flash_decode_paged"]
    assert len(_entries(cache)) == 2
    # a second run is all cache hits, and warmup adopts both
    code, again = tune_cli.run(argv)
    assert all(r.cached and r.trials == [] for _, r in again)
    got = apply_tuned_winners(_reduced_llama(), 2, 8, 64, device="cpu")
    assert sorted(got) == ["flash_decode", "flash_decode_paged"]


def _small_apps_argv():
    return ["--apps", "--device", "cpu", "--repeats", "1", "--fd-size", "32",
            "--fd-radius", "1", "--sem-elems", "2", "--sem-n", "1",
            "--dg-nx", "4", "--dg-n", "1"]


def test_the_app_drivers_adopt_apps_winners(monkeypatch):
    """``tune_cli --apps`` probes the drivers' own shapes, so the drivers
    built at those shapes with block=None / eb=None adopt the winners (the
    sweeps pinned to one candidate off each default, so adoption shows);
    an explicit knob still pins."""
    for name, sweep in (("fd2d", dict(bh=[8], bw=[16])),
                        ("sem_apply", dict(eb=[2])),
                        ("dg_volume", dict(eb=[4])),
                        ("dg_surface", dict(eb=[16]))):
        monkeypatch.setattr(get_op(name), "sweep", sweep)
    code, results = tune_cli.run(_small_apps_argv())
    assert code == 0 and [n for n, _ in results] == [
        "fd2d", "sem_apply", "dg_volume", "dg_surface"]
    fd = fd_app.FDWave(width=32, height=32, radius=1, device="cpu")
    assert fd.block == (8, 16) and fd.tuned == {"bh": 8, "bw": 16}
    op = sem_app.SEMOperator(ex=2, ey=2, ez=2, n=1, device="cpu")
    assert op.eb == 2 and op.tuned == {"eb": 2}
    assert sem_app.SEMOperator(ex=2, ey=2, ez=2, n=1, eb=4,
                               device="cpu").eb == 4
    assert sem_app.SEMOperator(ex=3, ey=2, ez=2, n=1, device="cpu").tuned \
        is None                                   # another E: the default
    sol = dg_swe.SWESolver(nx=4, ny=4, n=1, device="cpu")
    assert (sol.eb, sol.surf_eb) == (4, 16)
    pinned = dg_swe.SWESolver(nx=4, ny=4, n=1, eb=2, device="cpu")
    assert (pinned.eb, pinned.surf_eb, pinned.surf_tuned) == (2, 2, None)
    again = tune_cli.run(_small_apps_argv())[1]
    assert all(r.cached for _, r in again)
