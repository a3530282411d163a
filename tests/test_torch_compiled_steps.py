"""The port's serve steps (``parallel.build_serve_step`` and
``build_paged_serve_step``) on the CPU, where a step is the model's method
run eagerly: against the JAX package's jitted model methods (``jax.jit`` of
``LM.greedy_step``/``decode_step``/``paged_greedy_step``, not JAX's
``build_serve_step``, whose mesh path fails on this JAX version) on four
static programs (dense, a rolling window that wraps, sinusoidal positions,
MLA) and the paged one; the cache's device position; the overflow guards;
and the CUDA-graph step's host bookkeeping (``GraphStep``: eager first
call, capture, replay, the refusal of another (params, cache) pair, the
host overflow count, the launch counts), with the capture stubbed, since
only the card captures.

Tolerances, all f32: 1e-4 for logits (sums in another order); tokens and
launch counts exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import LM as JaxLM
from repro.serving import Engine as JaxEngine

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import (add_launches, flash_decode, launch_counts,
                                 launch_state, launches_since, reset_launches,
                                 rmsnorm)
from repro_torch.launch import serve
from repro_torch.models import LM, from_jax_params
from repro_torch.parallel import (GraphStep, build_paged_serve_step,
                                  build_serve_step)
from repro_torch.parallel import steps as steps_mod
from repro_torch.serving import Engine

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _pair(arch, **changes):
    """(torch LM, torch params, JAX LM, JAX params) on the reduced ``arch``
    with ``changes``, the port's weights converted from the JAX init."""
    jm = JaxLM(dataclasses.replace(jax_reduced(jax_get_config(arch)),
                                   **changes))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = LM(dataclasses.replace(reduced(get_config(arch)), **changes),
            device="cpu")
    return tm, from_jax_params(jax.tree.map(np.asarray, jp),
                               device="cpu"), jm, jp


def _assert_pos(cache, want):
    pos = cache["pos"]
    assert torch.is_tensor(pos) and pos.dim() == 0
    assert pos.dtype == torch.int32 and pos.device.type == "cpu"
    assert int(pos) == want


# (arch, config changes, prompt length, max_len): dense GQA; a rolling
# window of 8 slots that wraps during the steps; musicgen's sinusoidal
# positions; deepseek's MLA (with MoE layers)
PROGRAMS = [("llama3_2_1b", {}, 7, 20),
            ("llama3_2_1b", dict(window=8), 6, 20),
            ("musicgen_medium", {}, 5, 16),
            ("deepseek_v2_lite", {}, 5, 16)]


@pytest.mark.parametrize("arch,changes,plen,max_len", PROGRAMS,
                         ids=["dense", "window", "sinusoidal", "mla"])
def test_serve_step_matches_jax(arch, changes, plen, max_len):
    """Seven greedy steps give jitted JAX ``greedy_step``'s tokens and
    logits; seven sampled-path steps (``greedy=False``, fed the same
    tokens) give jitted ``decode_step``'s logits. The position is the
    cache's 0-dim int32 tensor, advanced in place, after every step."""
    tm, tp, jm, jp = _pair(arch, **changes)
    rng = np.random.default_rng(len(arch) + plen)
    prompts = rng.integers(1, tm.cfg.vocab_size, (2, plen))
    for greedy in (True, False):
        step, info = build_serve_step(tm, batch=2, greedy=greedy)
        assert info == {"greedy": greedy, "cuda_graph": False}
        jstep = jax.jit(jm.greedy_step if greedy else jm.decode_step)
        tl, tc = tm.prefill(tp, _t(prompts), max_len=max_len)
        jl, jc = jm.prefill(jp, jnp.asarray(prompts, jnp.int32),
                            max_len=max_len)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
        _assert_pos(tc, plen)
        pos = tc["pos"]
        tok = np.asarray(jm.greedy_token(jl))[:, None]
        for i in range(7):
            if greedy:
                tn, tl, tc2 = step(tp, tc, _t(tok))
                jn, jl, jc = jstep(jp, jnp.asarray(tok), jc)
                np.testing.assert_array_equal(_np(tn), np.asarray(jn))
                tok = np.asarray(jn)[:, None]
            else:
                tl, tc2 = step(tp, tc, _t(tok))
                jl, jc = jstep(jp, jnp.asarray(tok), jc)
                tok = rng.integers(1, tm.cfg.vocab_size, (2, 1))
            np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL,
                                       err_msg=f"greedy={greedy} step {i}")
            assert tc2 is tc and tc["pos"] is pos
            _assert_pos(tc, plen + 1 + i)
        assert int(tc["pos"]) == int(jc["pos"])
    if changes.get("window"):                 # the rolling cache wrapped
        assert plen + 7 > tc["stacks"][0]["k"].shape[3]


def test_init_cache_position_is_a_device_scalar():
    tm = LM(reduced(get_config("llama3_2_1b")), device="cpu")
    tp = tm.init(torch.Generator().manual_seed(3))
    cache = tm.init_cache(2, 8)
    _assert_pos(cache, 0)
    step, _ = build_serve_step(tm, batch=2, greedy=False)
    step(tp, cache, torch.zeros((2, 1), dtype=torch.long))
    _assert_pos(cache, 1)


def test_paged_serve_step_matches_jax():
    """From the same admitted state (both engines admit two prompts and
    step once), four ``build_paged_serve_step`` steps give jitted JAX
    ``paged_greedy_step``'s tokens and logits; the sampled-path step gives
    ``paged_decode_step``'s logits."""
    tm, tp, jm, jp = _pair("llama3_2_1b")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, tm.cfg.vocab_size, 3).tolist()
               for _ in range(2)]
    engines = []
    for cls, model, params in ((JaxEngine, jm, jp), (Engine, tm, tp)):
        eng = cls(model, params, batch=2, max_len=32, page_size=8)
        for p in prompts:
            eng.submit(p, 16)
        eng.step()
        engines.append(eng)
    jeng, teng = engines
    np.testing.assert_array_equal(teng._pending, jeng._pending)
    step, info = build_paged_serve_step(tm, batch=2)
    assert info == {"greedy": True, "cuda_graph": False}
    jstep = jax.jit(jm.paged_greedy_step)
    tok, jc = teng._pending.reshape(2, 1), jeng.cache
    for i in range(4):
        tn, tl, tc = step(tp, teng.cache, _t(tok))
        jn, jl, jc = jstep(jp, jnp.asarray(tok, jnp.int32), jc)
        assert tc is teng.cache
        np.testing.assert_array_equal(_np(tn), np.asarray(jn))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL,
                                   err_msg=f"step {i}")
        tok = _np(tn)[:, None]
    step, info = build_paged_serve_step(tm, batch=2, greedy=False)
    tl, _ = step(tp, teng.cache, _t(tok))
    jl, _ = jax.jit(jm.paged_decode_step)(jp, jnp.asarray(tok, jnp.int32),
                                          jc)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    assert not info["greedy"]


def test_paged_serve_step_refuses_unpageable_models():
    tm = LM(dataclasses.replace(reduced(get_config("llama3_2_1b")),
                                window=8), device="cpu")
    with pytest.raises(ValueError, match="not pageable"):
        build_paged_serve_step(tm, batch=2)


def test_sampling_engine_steps_through_paged_decode_step(monkeypatch):
    """A sampling engine builds its step with ``greedy=False``, as the JAX
    engine picks ``paged_decode_step``, and calls no fused argmax; its
    tokens equal those sampled, from the same generator seed, off
    ``paged_greedy_step``'s logits (the same LM-head pass)."""
    tm = LM(reduced(get_config("llama3_2_1b")), device="cpu")
    tp = tm.init(torch.Generator().manual_seed(11))
    rng = np.random.default_rng(12)
    traffic = [(rng.integers(0, tm.cfg.vocab_size, n).tolist(), g)
               for n, g in ((4, 6), (9, 3), (2, 7))]
    runs = []
    for fused in (False, True):
        if not fused:
            def refuse(*a):
                raise AssertionError("a sampling engine ran the argmax step")
            monkeypatch.setattr(tm, "paged_greedy_step", refuse)
        eng = Engine(tm, tp, batch=2, max_len=24, page_size=8, greedy=False,
                     temperature=0.7, rng=torch.Generator().manual_seed(13))
        if fused:
            def step(p, c, t):
                return tm.paged_greedy_step(p, t, c)[1:]
            eng._step = step
        rids = [eng.submit(p, g) for p, g in traffic]
        res = eng.drain()
        runs.append([res[r] for r in rids])
        monkeypatch.undo()
    assert runs[0] == runs[1]
    assert [len(t) for t in runs[0]] == [g for _, g in traffic]


def test_overflow_raises_from_the_step_and_generate():
    tm = LM(reduced(get_config("llama3_2_1b")), device="cpu")
    tp = tm.init(torch.Generator().manual_seed(4))
    toks = torch.randint(0, tm.cfg.vocab_size, (1, 4),
                         generator=torch.Generator().manual_seed(5))
    _, cache = tm.prefill(tp, toks, max_len=5)
    step, _ = build_serve_step(tm, batch=1)
    step(tp, cache, toks[:, :1])                      # position 4: fits
    with pytest.raises(ValueError, match="cache overflow"):
        step(tp, cache, toks[:, :1])                  # position 5
    assert int(cache["pos"]) == 5                     # nothing written
    with pytest.raises(ValueError, match="cache overflow"):
        serve.generate(tm, tp, toks.numpy(), gen_tokens=4, max_len=6,
                       engine="static")


def test_generate_static_serves_through_the_built_step(monkeypatch):
    """``_generate_static`` builds its step once, after the prefill, with
    its greedy flag and the adopted split (none persisted here), and calls
    it once a token."""
    tm = LM(reduced(get_config("musicgen_medium")), device="cpu")
    tp = tm.init(torch.Generator().manual_seed(6))
    built, calls = [], []

    def spy(model, **kw):
        step, info = build_serve_step(model, **kw)
        built.append(kw)

        def counted(params, cache, tokens):
            calls.append(int(cache["pos"]))
            return step(params, cache, tokens)
        return counted, info

    monkeypatch.setattr(serve, "build_serve_step", spy)
    prompts = np.random.RandomState(7).randint(0, tm.cfg.vocab_size, (2, 5))
    for greedy in (True, False):
        built.clear()
        calls.clear()
        out, stats = serve.generate(tm, tp, prompts, gen_tokens=6,
                                    greedy=greedy)
        assert not stats["engine"] and out.shape == (2, 6)
        assert built == [dict(batch=2, greedy=greedy, split=None)]
        assert calls == [5, 6, 7, 8, 9, 10]


# ---------------------------------------------------------------------------
# the CUDA-graph step's host bookkeeping, with the capture stubbed
# ---------------------------------------------------------------------------

def test_launch_bookkeeping_round_trips():
    reset_launches()
    before = launch_state()
    rmsnorm.launches += 3
    rmsnorm.routes["vec"] += 2
    rmsnorm.routes["elem"] += 1
    flash_decode.launches += 1
    moved = launches_since(before)
    assert moved == {"rmsnorm": (3, {"vec": 2, "elem": 1}),
                     "flash_decode": (1, {})}
    add_launches(moved, -1)
    assert launch_state() == before
    add_launches(moved, 4)
    assert launch_counts()["rmsnorm"] == 12 and rmsnorm.routes == {
        "vec": 8, "elem": 4}
    assert launch_counts()["flash_decode"] == 4
    reset_launches()


class _StubDecode:
    """A decode method whose "kernels" are launch counts: three rmsnorm
    launches on the vector route and one flash_decode a step. It advances
    the cache's position like a model's step and returns (next, cache)."""

    def __init__(self):
        self.calls = 0

    def __call__(self, params, tokens, cache):
        self.calls += 1
        rmsnorm.launches += 3
        rmsnorm.routes["vec"] += 3
        flash_decode.launches += 1
        cache["pos"].add_(1)
        return tokens[:, 0] + 1, cache


@pytest.fixture
def stub_capture(monkeypatch):
    """``steps.capture`` as a stub: it runs fn's Python once, as a capture
    does, and its replay only counts itself (the card runs the graph)."""
    replays = []

    def fake(fn):
        return (lambda: replays.append(1)), fn()

    monkeypatch.setattr(steps_mod, "capture", fake)
    return replays


def _cache(pos):
    return {"pos": torch.tensor(pos, dtype=torch.int32), "stacks": []}


def test_graph_step_eager_first_then_replays_with_exact_counts(stub_capture):
    fn, replays = _StubDecode(), stub_capture
    step = GraphStep(fn, batch=2, device=torch.device("cpu"))
    params, cache = {}, _cache(3)
    reset_launches()
    tok = torch.ones((2, 1), dtype=torch.long)
    for _ in range(5):
        out = step(params, cache, tok)
    # one eager call, one capture (its Python ran once), four replays
    assert fn.calls == 2 and len(replays) == 4 and step.captures == 1
    assert out[1] is cache
    assert launch_counts()["rmsnorm"] == 15 and rmsnorm.routes["vec"] == 15
    assert launch_counts()["flash_decode"] == 5
    # another cache or params object raises: the graph holds the first
    # pair's addresses; nothing runs, replays or counts
    for p, c in ((params, _cache(0)), ({}, cache)):
        with pytest.raises(ValueError, match="first call"):
            step(p, c, tok)
    assert fn.calls == 2 and len(replays) == 4 and step.captures == 1
    assert launch_counts()["flash_decode"] == 5
    with pytest.raises(ValueError, match=r"\(2, 1\)"):
        step(params, cache, torch.ones((3, 1), dtype=torch.long))
    step(params, cache, tok)             # the first pair still replays
    assert len(replays) == 5 and int(cache["pos"]) == 5
    reset_launches()


def test_graph_step_counts_positions_on_the_host(stub_capture):
    """A replay that would pass the capacity raises the eager step's
    overflow error: the position is read once, at capture."""
    fn = _StubDecode()
    step = GraphStep(fn, batch=1, device=torch.device("cpu"),
                     capacity=lambda cache: 6)
    params, cache = {}, _cache(2)
    tok = torch.zeros((1, 1), dtype=torch.long)
    step(params, cache, tok)               # eager, at position 2
    for _ in range(3):                     # capture at 3, replays at 3, 4, 5
        step(params, cache, tok)
    with pytest.raises(ValueError, match="cache overflow: decode at position "
                                         "6 but the cache holds 6"):
        step(params, cache, tok)
    reset_launches()


def test_engine_and_static_loop_build_their_steps_on_the_cpu_eagerly():
    """On the CPU the built steps are the model's methods (no graph)."""
    tm = LM(reduced(get_config("llama3_2_1b")), device="cpu")
    tp = tm.init(torch.Generator().manual_seed(8))
    eng = Engine(tm, tp, batch=2, max_len=16, page_size=8)
    assert not isinstance(eng._step, GraphStep)
    step, info = build_serve_step(tm, batch=2)
    assert not isinstance(step, GraphStep) and not info["cuda_graph"]
