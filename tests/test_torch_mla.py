"""The port's MLA (deepseek-v2's latent attention) against the JAX
package, on the CPU: the plain ``flash_attention`` at d_qk != d_v (48 / 32,
reduced deepseek's, and 192 / 128, the full model's) against the JAX op in
Pallas interpret mode, with its gradients; ``mla_forward``,
``mla_prefill_cache`` and the absorbed ``mla_decode`` step by step; and
reduced ``deepseek_v2_lite`` (a dense first layer, then MoE with a shared
expert): prefill logits, 8 static greedy tokens for both dispatches, the
cache's capacity, and the loss with every gradient.

Tolerances, all f32: 1e-5 for ops, 1e-4 for layer and model outputs (sums
in another order); tokens exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import mha_ref as jax_mha_ref
from repro.layers import attention as jax_attn
from repro.layers.common import use_kernel_backend

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_fwd)
from repro_torch.launch.serve import generate
from repro_torch.layers import attention as attn
from repro_torch.models.lm import _layer

from test_torch_moe import _jax_static_loop, _pair, assert_loss_and_grads

EW = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def deepseek():
    return _pair("deepseek_v2_lite")


# ---------------------------------------------------------------------------
# flash attention at d_qk != d_v
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dqk,dv,sq,skv", [(48, 32, 13, 13), (48, 32, 5, 21),
                                           (192, 128, 9, 9),
                                           (192, 128, 16, 40)])
def test_flash_attention_unequal_head_dims_match_jax(dqk, dv, sq, skv):
    """o against the JAX op in Pallas interpret mode and its oracle (lse
    too), and dq, dk, dv against ``jax.vjp`` of the oracle."""
    rng = np.random.default_rng(dqk + sq)
    q = rng.standard_normal((2, 4, sq, dqk), np.float32)
    k = rng.standard_normal((2, 4, skv, dqk), np.float32)
    v = rng.standard_normal((2, 4, skv, dv), np.float32)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o, lse = flash_attention_fwd(_t(q), _t(k), _t(v), causal=True)
    assert o.shape == (2, 4, sq, dv)
    with use_kernel_backend("pallas"):
        jo = jax_flash(jq, jk, jv, causal=True, block_q=8, block_kv=8,
                       backend="pallas")
    np.testing.assert_allclose(_np(o), np.asarray(jo), **TOL)
    jref, vjp = jax.vjp(lambda a, b, c: jax_mha_ref(a, b, c, causal=True),
                        jq, jk, jv)
    np.testing.assert_allclose(_np(o), np.asarray(jref), **TOL)
    do = rng.standard_normal(o.shape, np.float32)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    grads = torch.autograd.grad(flash_attention(tq, tk, tv), (tq, tk, tv),
                                _t(do))
    for got, want in zip(grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the MLA layer
# ---------------------------------------------------------------------------

def test_mla_forward_matches_jax(deepseek):
    tm, tp, jm, jp = deepseek
    lp = jax.tree.map(lambda a: a[0], jp["stacks"][0]["attn"])
    tl = _layer(tp["stacks"][0], 0)["attn"]
    x = np.random.default_rng(1).standard_normal((2, 11, tm.cfg.d_model),
                                                 np.float32)
    want, (jc, jr) = jax_attn.mla_forward(lp, jnp.asarray(x), jm.cfg,
                                          return_latent=True)
    got, (tc, tr) = attn.mla_forward(tl, _t(x), tm.cfg, return_latent=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), **TOL)
    np.testing.assert_allclose(_np(tr), np.asarray(jr), **TOL)


def test_mla_prefill_cache_and_decode_match_jax(deepseek):
    """The latent cache after a prefill of 7 tokens into 12 slots, then
    five absorbed decode steps: outputs and the caches each step."""
    tm, tp, jm, jp = deepseek
    cfg = tm.cfg
    lp = jax.tree.map(lambda a: a[0], jp["stacks"][0]["attn"])
    tl = _layer(tp["stacks"][0], 0)["attn"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, cfg.d_model), np.float32)
    _, jlat = jax_attn.mla_forward(lp, jnp.asarray(x), jm.cfg,
                                   return_latent=True)
    _, tlat = attn.mla_forward(tl, _t(x), cfg, return_latent=True)
    jcache = jax_attn.mla_prefill_cache(
        jax_attn.mla_cache_init(jm.cfg, 2, 12, jnp.float32), jlat, jm.cfg)
    tcache = attn.mla_prefill_cache(
        attn.mla_cache_init(cfg, 2, 12, torch.float32, "cpu"), tlat, cfg)
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(_np(tcache[key]), np.asarray(jcache[key]),
                                   **TOL)
    for step in range(5):
        xt = rng.standard_normal((2, 1, cfg.d_model), np.float32)
        jy, jcache = jax_attn.mla_decode(lp, jnp.asarray(xt), jcache, jm.cfg)
        ty, tcache = attn.mla_decode(tl, _t(xt), tcache, cfg, pos=7 + step)
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL,
                                   err_msg=f"step {step}")
        for key in ("ckv", "krope"):
            np.testing.assert_allclose(_np(tcache[key]),
                                       np.asarray(jcache[key]), **TOL)


# ---------------------------------------------------------------------------
# reduced deepseek: prefill, greedy tokens, cache capacity, loss
# ---------------------------------------------------------------------------

def test_deepseek_prefill_logits_and_cache_match_jax(deepseek):
    tm, tp, jm, jp = deepseek
    assert [s.kind for s in tm.program] == ["dense", "moe"]
    toks = np.random.default_rng(3).integers(0, 512, (2, 10)).astype(
        np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=16)
    tl, tc = tm.prefill(tp, _t(toks), max_len=16)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    assert tm.cache_capacity(tc) == jm.cache_capacity(jc) == 16
    for ts, js in zip(tc["stacks"], jc["stacks"]):
        for key in ("ckv", "krope"):
            np.testing.assert_allclose(_np(ts[key]), np.asarray(js[key]),
                                       **TOL)
    with pytest.raises(ValueError, match="overflow"):
        tm.prefill(tp, _t(toks), max_len=8)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_deepseek_static_tokens_match_jax_loop(dispatch):
    tm, tp, jm, jp = _pair("deepseek_v2_lite", dispatch)
    prompts = np.random.RandomState(4).randint(0, 512, (3, 9)).astype(
        np.int32)
    want = _jax_static_loop(jm, jp, prompts, 8, 17)
    out, stats = generate(tm, tp, prompts, gen_tokens=8)
    assert not stats["engine"] and not tm.pageable and not jm.pageable
    np.testing.assert_array_equal(out, want)


def test_deepseek_decode_past_capacity_raises(deepseek):
    tm, tp, _, _ = deepseek
    toks = _t(np.random.default_rng(5).integers(0, 512, (1, 4)))
    logits, cache = tm.prefill(tp, toks, max_len=5)
    nxt = tm.greedy_token(logits)[:, None]
    _, _, cache = tm.greedy_step(tp, nxt, cache)
    with pytest.raises(ValueError, match="overflow"):
        tm.greedy_step(tp, nxt, cache)


def test_deepseek_loss_and_grads_match_jax():
    """MLA attention, a dense first layer, a shared expert: total, ce, both
    aux terms and every gradient (the router's and the latent's among
    them)."""
    assert_loss_and_grads("deepseek_v2_lite", "einsum")


def test_mla_needs_no_window_or_paging(deepseek):
    """MLA models take the static path (the latent cache is not paged),
    as in JAX; asking for the engine raises."""
    tm, tp, jm, _ = deepseek
    assert tm.pageable is jm.pageable is False
    with pytest.raises(ValueError, match="paged decode"):
        tm.init_paged_cache(2, 5, 4, 2)
    prompts = np.zeros((1, 3), np.int32)
    with pytest.raises(ValueError):
        generate(tm, tp, prompts, gen_tokens=2, engine="paged")


def test_deepseek_decode_logits_match_jax(deepseek):
    """decode_step logits after the prefill, step by step."""
    tm, tp, jm, jp = deepseek
    toks = np.random.default_rng(6).integers(0, 512, (2, 6)).astype(np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=12)
    tl, tc = tm.prefill(tp, _t(toks), max_len=12)
    for step in range(4):
        t = np.asarray(jm.greedy_token(jl))[:, None].astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(t), jc)
        tl, tc = tm.decode_step(tp, _t(t), tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL,
                                   err_msg=f"step {step}")
    assert tc["pos"] == 10 == int(jc["pos"])
    assert dataclasses.asdict(tm.cfg)["attn_type"] == "mla"
