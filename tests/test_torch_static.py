"""The port's static decode path against the JAX package, on the CPU:
the plain ``flash_decode`` (``decode_ref``) against the JAX decode op in
Pallas interpret mode, the windowed prefill, windowed ``gqa_decode`` across
the wrap, musicgen's conditioning prefix, ``generate(engine="static")``
against an eagerly composed JAX loop (``LM.prefill`` + ``greedy_step``, no
mesh: the JAX ``_generate_static`` fails in its mesh on this JAX version),
sampling and the overflow guards.

Tolerances: 1e-5 for the decode oracle (one softmax over f32 scores),
1e-4 for layer and model outputs (f32 sums in another order), tokens
exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.flash_attention import (decode_attention as jax_decode,
                                           decode_ref as jax_decode_ref,
                                           flash_attention_fwd as jax_flash_fwd,
                                           mha_ref as jax_mha_ref,
                                           rolling_slot_pos as jax_rolling)
from repro.layers import attention as jax_attn
from repro.layers.common import use_kernel_backend
from repro.models import LM as JaxLM

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels.flash_attention import (decode_ref, flash_attention,
                                                 flash_attention_fwd,
                                                 flash_decode,
                                                 rolling_slot_pos)
from repro_torch.launch.serve import _generate_static, generate
from repro_torch.layers import attention as attn
from repro_torch.models import LM, from_jax_params
from repro_torch.serving import Engine, sample

EW = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


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
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return tm, tp, jm, jp


@pytest.fixture(scope="module")
def musicgen():
    return _pair("musicgen_medium")


@pytest.fixture(scope="module")
def windowed():
    return _pair("llama3_2_1b", window=8)


# ---------------------------------------------------------------------------
# the decode kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,t", [(8, 0), (8, 5), (8, 8), (8, 21),
                                      (5, 40)])
def test_rolling_slot_pos_matches_jax(window, t):
    np.testing.assert_array_equal(_np(rolling_slot_pos(window, t)),
                                  jax_rolling(window, t))


# (skv, kv_len, window, rotated after t tokens, h, hk, block_kv)
DECODE_CASES = [
    (40, 40, None, None, 4, 4, 16),        # full positional cache, MHA
    (40, 17, None, None, 8, 2, 16),        # partial kv_len, GQA g = 4
    (48, 30, 5, None, 4, 1, 16),           # window < block, MQA
    (32, 20, 32, 20, 4, 2, 16),            # rolling cache before the wrap
    (32, 45, 32, 45, 8, 2, 16),            # after the wrap
    (16, 77, 24, 77, 4, 2, 8),             # cache shorter than the window
]


@pytest.mark.parametrize("skv,kv_len,window,t,h,hk,bkv", DECODE_CASES)
def test_flash_decode_plain_matches_jax(skv, kv_len, window, t, h, hk, bkv):
    rng = np.random.default_rng(skv + kv_len)
    b, d = 2, 32
    q = rng.standard_normal((b, h, 1, d), np.float32)
    k = rng.standard_normal((b, hk, skv, d), np.float32)
    v = rng.standard_normal((b, hk, skv, d), np.float32)
    sp = None if t is None else jax_rolling(skv, t)
    got = _np(flash_decode(_t(q), _t(k), _t(v), kv_len=kv_len, window=window,
                           slot_pos=None if sp is None else _t(sp)))
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jsp = None if sp is None else jnp.asarray(sp)
    np.testing.assert_allclose(got, np.asarray(jax_decode_ref(
        jq, jk, jv, window=window, kv_len=kv_len, slot_pos=jsp)), **EW)
    np.testing.assert_allclose(got, np.asarray(jax_decode(
        jq, jk, jv, window=window, kv_len=kv_len, slot_pos=jsp,
        block_kv=bkv, backend="pallas")), **EW)


def test_flash_decode_row_without_live_slot_is_zero():
    q = torch.randn(1, 4, 1, 32)
    k = torch.randn(1, 2, 16, 32)
    sp = torch.full((16,), -1, dtype=torch.int32)
    assert (flash_decode(q, k, k, kv_len=5, slot_pos=sp) == 0).all()
    assert (decode_ref(q, k, k, kv_len=0) == 0).all()


@pytest.mark.parametrize("sq,skv,window", [(12, 12, 5), (7, 20, 4),
                                           (16, 16, 16)])
def test_windowed_prefill_plain_matches_jax(sq, skv, window):
    rng = np.random.default_rng(sq + window)
    q = rng.standard_normal((2, 4, sq, 32), np.float32)
    k = rng.standard_normal((2, 2, skv, 32), np.float32)
    v = rng.standard_normal((2, 2, skv, 32), np.float32)
    o, lse = flash_attention_fwd(_t(q), _t(k), _t(v), window=window)
    jo, jlse = jax_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             window=window, block_q=8, block_kv=8,
                             backend="pallas")
    np.testing.assert_allclose(_np(o), np.asarray(jo), **TOL)
    np.testing.assert_allclose(_np(lse), np.asarray(jlse), **EW)


def test_windowed_attention_gradients_match_jax():
    """On the CPU a windowed ``flash_attention`` differentiates its plain
    version: the gradients equal ``jax.vjp`` of the JAX oracle's."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 9, 32), np.float32)
    k = rng.standard_normal((1, 2, 9, 32), np.float32)
    v = rng.standard_normal((1, 2, 9, 32), np.float32)
    go = rng.standard_normal((1, 4, 9, 32), np.float32)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    got = torch.autograd.grad(flash_attention(tq, tk, tv, window=3),
                              (tq, tk, tv), _t(go))
    _, vjp = jax.vjp(lambda a, b_, c: jax_mha_ref(a, b_, c, window=3),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, b_ in zip(got, vjp(jnp.asarray(go))):
        np.testing.assert_allclose(_np(a), np.asarray(b_), **TOL)


# ---------------------------------------------------------------------------
# windowed layers and caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("s", [6, 13])
def test_gqa_decode_windowed_across_wrap_matches_jax(windowed, backend, s):
    """Prefill s tokens into a W = 8 rolling cache (s = 13 fills it by
    rotation), then 10 decode steps through the wrap: outputs, cache and
    slot map match the JAX layer step for step."""
    tm, tp, jm, jp = windowed
    cfg = tm.cfg
    jparams = jax.tree.map(lambda a: a[0], jp["stacks"][0]["attn"])
    tparams = {k: v[0] for k, v in tp["stacks"][0]["attn"].items()}
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model), np.float32)
    steps = rng.standard_normal((10, 2, 1, cfg.d_model), np.float32)
    with use_kernel_backend(backend):
        _, (k, v) = jax_attn.gqa_forward(jparams, jnp.asarray(x), jm.cfg,
                                         return_kv=True)
        jc = jax_attn.gqa_prefill_cache(
            jax_attn.gqa_cache_init(jm.cfg, 2, 32, jnp.float32), k, v,
            jm.cfg)
        jys = []
        for xt in steps:
            yt, jc = jax_attn.gqa_decode(jparams, jnp.asarray(xt), jc,
                                         jm.cfg)
            jys.append(np.asarray(yt))
    _, (k, v) = attn.gqa_forward(tparams, _t(x), cfg, return_kv=True)
    tc = attn.gqa_prefill_cache(
        attn.gqa_cache_init(cfg, 2, 32, torch.float32, "cpu"), k, v, cfg)
    for i, xt in enumerate(steps):
        yt, tc = attn.gqa_decode(tparams, _t(xt), tc, cfg, pos=s + i)
        np.testing.assert_allclose(_np(yt), jys[i], **TOL,
                                   err_msg=f"step {i}")
    np.testing.assert_array_equal(_np(tc["slot_pos"]),
                                  np.asarray(jc["slot_pos"]))
    np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), **TOL)


def test_windowed_model_prefill_decode_matches_jax(windowed):
    tm, tp, jm, jp = windowed
    rng = np.random.default_rng(4)
    toks = rng.integers(1, tm.cfg.vocab_size, (2, 13))
    jl, jc = jm.prefill(jp, jnp.asarray(toks, jnp.int32), max_len=20)
    tl, tc = tm.prefill(tp, _t(toks), max_len=20)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    assert tm.cache_capacity(tc) is None and tc["stacks"][0]["k"].shape[3] == 8
    for step in range(10):
        t = rng.integers(1, tm.cfg.vocab_size, (2, 1))
        jn, jl, jc = jm.greedy_step(jp, jnp.asarray(t, jnp.int32), jc)
        tn, tl, tc = tm.greedy_step(tp, _t(t), tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(_np(tn), np.asarray(jn))
    assert tc["pos"] == int(jc["pos"]) == 23


# ---------------------------------------------------------------------------
# musicgen: sinusoidal positions and the conditioning prefix
# ---------------------------------------------------------------------------

def test_sinusoidal_embedding_matches_jax():
    from repro.layers.rope import sinusoidal_embedding as jax_sin

    from repro_torch.layers.rope import sinusoidal_embedding

    pos = np.arange(5, 40)
    np.testing.assert_allclose(_np(sinusoidal_embedding(_t(pos), 64)),
                               np.asarray(jax_sin(jnp.asarray(pos), 64)),
                               **EW)


def test_musicgen_forward_with_prefix_matches_jax(musicgen):
    tm, tp, jm, jp = musicgen
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 11))
    pre = rng.standard_normal((2, tm.cfg.num_prefix_embeddings,
                               tm.cfg.d_model), np.float32)
    jl, _ = jm.forward(jp, jnp.asarray(toks), prefix_embeddings=jnp.asarray(pre))
    tl, aux = tm.forward(tp, _t(toks), prefix_embeddings=_t(pre))
    assert tl.shape == (2, 8 + 11, tm.vpad)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    jl, _ = jm.forward(jp, jnp.asarray(toks))
    np.testing.assert_allclose(_np(tm.forward(tp, _t(toks))[0]),
                               np.asarray(jl), **TOL)


def test_musicgen_loss_with_prefix_matches_jax(musicgen):
    tm, tp, jm, jp = musicgen
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 9))
    pre = rng.standard_normal((2, 8, tm.cfg.d_model), np.float32)
    jt, _ = jm.loss(jp, {"tokens": jnp.asarray(toks),
                         "prefix_embeddings": jnp.asarray(pre)})
    tt, _ = tm.loss(tp, {"tokens": _t(toks), "prefix_embeddings": _t(pre)})
    np.testing.assert_allclose(float(tt), float(jt), **TOL)


def test_musicgen_prefill_decode_matches_jax(musicgen):
    tm, tp, jm, jp = musicgen
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 10))
    pre = rng.standard_normal((2, 8, tm.cfg.d_model), np.float32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks),
                        prefix_embeddings=jnp.asarray(pre), max_len=30)
    tl, tc = tm.prefill(tp, _t(toks), prefix_embeddings=_t(pre), max_len=30)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    assert tc["pos"] == int(jc["pos"]) == 18
    assert tm.cache_capacity(tc) == 30 and not tm.pageable
    for step in range(6):
        t = rng.integers(0, tm.cfg.vocab_size, (2, 1))
        jl, jc = jm.decode_step(jp, jnp.asarray(t), jc)
        tl, tc = tm.decode_step(tp, _t(t), tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL,
                                   err_msg=f"step {step}")


# ---------------------------------------------------------------------------
# generate(engine="static") against the eagerly composed JAX loop
# ---------------------------------------------------------------------------

def _jax_static_loop(jm, jp, prompts, gen_tokens, max_len):
    """The JAX ``_generate_static`` loop without its mesh: prefill, then one
    greedy step per token, the first token from the prefill's argmax."""
    logits, cache = jm.prefill(jp, jnp.asarray(prompts, jnp.int32),
                               max_len=max_len)
    tok = np.asarray(jm.greedy_token(logits))
    out = np.zeros((prompts.shape[0], gen_tokens), np.int32)
    for t in range(gen_tokens):
        out[:, t] = tok
        nxt, _, cache = jm.greedy_step(jp, jnp.asarray(tok[:, None]), cache)
        tok = np.asarray(nxt)
    return out


@pytest.mark.parametrize("arch,changes,plen,gen", [
    ("musicgen_medium", {}, 9, 7),
    ("falcon_mamba_7b", {}, 9, 7),
    ("llama3_2_1b", dict(window=8), 11, 12),   # prompt and decode wrap W
])
def test_generate_static_tokens_match_jax_loop(arch, changes, plen, gen):
    tm, tp, jm, jp = _pair(arch, **changes)
    prompts = np.random.RandomState(plen).randint(
        0, tm.cfg.vocab_size, (3, plen)).astype(np.int32)
    want = _jax_static_loop(jm, jp, prompts, gen, plen + gen)
    out, stats = generate(tm, tp, prompts, gen_tokens=gen)
    assert not stats["engine"] and not tm.pageable
    np.testing.assert_array_equal(out, want)


def test_static_tokens_equal_engine_tokens_llama():
    tm, tp, jm, jp = _pair("llama3_2_1b")
    prompts = np.random.RandomState(3).randint(
        0, tm.cfg.vocab_size, (3, 7)).astype(np.int32)
    static, st = generate(tm, tp, prompts, gen_tokens=9, engine="static")
    paged, pt = generate(tm, tp, prompts, gen_tokens=9, engine="paged",
                         page_size=4)
    assert not st["engine"] and pt["engine"]
    np.testing.assert_array_equal(static, paged)
    np.testing.assert_array_equal(static,
                                  _jax_static_loop(jm, jp, prompts, 9, 16))


def test_generate_static_pads_after_eos(musicgen):
    tm, tp, _, _ = musicgen
    prompts = np.random.RandomState(4).randint(
        0, tm.cfg.vocab_size, (2, 5)).astype(np.int32)
    base, _ = generate(tm, tp, prompts, gen_tokens=6)
    eos = int(base[0, 2])
    out, _ = generate(tm, tp, prompts, gen_tokens=6, eos_id=eos, pad_id=0)
    stop = int(np.argmax(out[0] == eos))
    assert out[0, stop] == eos and (out[0, stop + 1:] == 0).all()
    with pytest.raises(ValueError, match="pageable"):
        generate(tm, tp, prompts, gen_tokens=2, engine="paged")
    with pytest.raises(ValueError, match="engine must be"):
        generate(tm, tp, prompts, gen_tokens=2, engine="fast")


def test_static_path_launches_no_kernel_on_the_cpu(musicgen):
    tm, tp, _, _ = musicgen
    reset_launches()
    generate(tm, tp, np.ones((2, 4), np.int32), gen_tokens=3)
    assert set(launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_sample_follows_softmax_over_temperature():
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0, 5.0]]).repeat(40000, 1)
    for temp in (0.5, 1.0, 2.0):
        gen = torch.Generator().manual_seed(0)
        draws = sample(logits, 4, temp, gen)      # the last column is pad
        freq = np.bincount(_np(draws), minlength=4) / draws.numel()
        want = _np(torch.softmax(logits[0, :4] / temp, -1))
        assert draws.max() < 4
        # 40000 draws: one standard error is <= 0.0025
        np.testing.assert_allclose(freq, want, atol=0.01)


def test_sampled_generate_reproduces_and_cools_to_greedy(musicgen):
    tm, tp, _, _ = musicgen
    prompts = np.random.RandomState(5).randint(
        0, tm.cfg.vocab_size, (2, 5)).astype(np.int32)
    greedy, _ = generate(tm, tp, prompts, gen_tokens=5)
    runs = [generate(tm, tp, prompts, gen_tokens=5, greedy=False,
                     rng=torch.Generator().manual_seed(9),
                     temperature=1.5)[0] for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    cold, _ = generate(tm, tp, prompts, gen_tokens=5, greedy=False,
                       rng=torch.Generator().manual_seed(0),
                       temperature=1e-4)
    np.testing.assert_array_equal(cold, greedy)
    for t in (0.0, -1.0):
        with pytest.raises(ValueError, match="temperature"):
            generate(tm, tp, prompts, gen_tokens=2, greedy=False,
                     temperature=t)


def test_sampled_engine_reproduces_and_cools_to_greedy():
    tm, tp, _, _ = _pair("llama3_2_1b")
    prompts = np.random.RandomState(6).randint(
        0, tm.cfg.vocab_size, (2, 5)).astype(np.int32)
    greedy, _ = generate(tm, tp, prompts, gen_tokens=5, page_size=4)
    runs = [generate(tm, tp, prompts, gen_tokens=5, greedy=False,
                     rng=torch.Generator().manual_seed(3), temperature=2.0,
                     page_size=4)[0] for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    cold, _ = generate(tm, tp, prompts, gen_tokens=5, greedy=False,
                       temperature=1e-4, page_size=4)
    np.testing.assert_array_equal(cold, greedy)
    with pytest.raises(ValueError, match="temperature"):
        Engine(tm, tp, batch=2, max_len=16, temperature=0.0)


# ---------------------------------------------------------------------------
# cache overflow is an explicit error (the JAX package's
# tests/test_window_decode.py guards)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    tm = LM(reduced(get_config("llama3_2_1b")), device="cpu")
    return tm, tm.init(torch.Generator().manual_seed(5))


def test_prefill_longer_than_max_len_raises(tiny):
    tm, tp = tiny
    toks = torch.from_numpy(np.random.RandomState(6).randint(
        0, tm.cfg.vocab_size, (1, 8)))
    with pytest.raises(ValueError, match="cache overflow"):
        tm.prefill(tp, toks, max_len=4)


def test_decode_past_capacity_raises_eagerly(tiny):
    tm, tp = tiny
    rng = np.random.RandomState(7)
    toks = torch.from_numpy(rng.randint(0, tm.cfg.vocab_size, (1, 4)))
    _, cache = tm.prefill(tp, toks, max_len=5)
    assert tm.cache_capacity(cache) == 5
    tok = torch.from_numpy(rng.randint(0, tm.cfg.vocab_size, (1, 1)))
    _, cache = tm.decode_step(tp, tok, cache)       # pos 4 -> 5: fits
    with pytest.raises(ValueError, match="cache overflow"):
        tm.decode_step(tp, tok, cache)              # pos 5 >= cap 5
    # rolling-window archs are exempt: the cache rotates, never overflows
    wm = LM(dataclasses.replace(tm.cfg, window=4), device="cpu")
    wp = wm.init(torch.Generator().manual_seed(8))
    _, wcache = wm.prefill(wp, toks, max_len=5)
    assert wm.cache_capacity(wcache) is None
    for _ in range(4):                              # well past max_len
        _, wcache = wm.decode_step(wp, tok, wcache)
    assert wcache["pos"] == 8


def test_generate_overflow_guard(tiny):
    tm, tp = tiny
    prompts = np.random.RandomState(9).randint(
        0, tm.cfg.vocab_size, (1, 4)).astype(np.int32)
    for engine in ("paged", "static"):
        with pytest.raises(ValueError, match="cache overflow"):
            generate(tm, tp, prompts, gen_tokens=4, max_len=6,
                     engine=engine)
    with pytest.raises(ValueError, match="cache overflow"):
        _generate_static(tm, tp, prompts, gen_tokens=4, max_len=6)
