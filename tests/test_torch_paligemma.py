"""The port's paligemma path against the JAX package, on the CPU: the
embedding's sqrt(d_model) scale (bit-equal in bf16, where JAX rounds the
scale to bf16 before the product), the prefix length that reaches every
attention layer only when ``prefix_lm`` is set, the plain flash forward
and backward under the prefix-LM mask against the JAX oracle, its
``jax.grad`` and the Pallas kernel in interpret mode, and reduced
``paligemma_3b`` (2 layers, MQA, 8 vision-stub prefix embeddings): the
parameter tree, forward and prefill logits with the prefix, the loss with
every gradient, greedy decode after a prefix prefill, and ``generate`` on
the engine and on the static path. A variant at the published head dim
256 with 8 query heads over the one KV head runs d = 256 and group 8
through the plain versions.

Tolerances, all f32: 1e-4 (sums in another order); tokens exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import mha_ref as jax_mha_ref
from repro.layers.common import use_kernel_backend
from repro.models import LM as JaxLM
from repro.serving import Engine as JaxEngine

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_fwd,
                                                 flash_bwd_ref, flash_delta_ref,
                                                 flash_fwd_ref)
from repro_torch.launch.serve import generate
from repro_torch.models import LM, from_jax_params
from repro_torch.tree import leaves, leaves_with_path, unflatten

from test_torch_moe import _jax_static_loop

TOL = dict(rtol=1e-4, atol=1e-4)
# the published attention shape: MQA, 8 query heads of 256 over 1 KV head
D256 = dict(n_heads=8, n_kv_heads=1, head_dim=256)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _pair(**changes):
    """(torch LM, torch params, JAX LM, JAX params) of reduced paligemma_3b
    with ``changes``, the port's weights converted from the JAX init."""
    jm = JaxLM(dataclasses.replace(jax_reduced(jax_get_config("paligemma_3b")),
                                   **changes))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = LM(dataclasses.replace(reduced(get_config("paligemma_3b")),
                                **changes), device="cpu")
    return tm, from_jax_params(jax.tree.map(np.asarray, jp),
                               device="cpu"), jm, jp


@pytest.fixture(scope="module")
def pali():
    return _pair()


@pytest.fixture(scope="module")
def pali256():
    return _pair(**D256)


def _prefix(seed, b, cfg):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.num_prefix_embeddings, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# the prefix-LM mask in the plain flash forward and backward
# ---------------------------------------------------------------------------

FLASH_CASES = [  # sq, skv, prefix_len, window
    (12, 12, 5, None),      # inside the sequence, off the 4-row tile
    (6, 14, 10, None),      # Sq < Skv: the prefix reaches past the first q
    (9, 9, 30, None),       # past Sq and Skv: every key visible
    (16, 16, 8, 3),         # a window, and two whole tiles of prefix
]


@pytest.mark.parametrize("sq,skv,prefix,window", FLASH_CASES)
def test_flash_prefix_mask_forward_and_grads_match_jax(sq, skv, prefix,
                                                       window):
    """``flash_fwd_ref`` (o and lse) and ``flash_bwd_ref`` with
    ``prefix_len`` against JAX ``mha_ref`` and its ``jax.grad``, GQA 4
    over 2; the port's op (``flash_attention``, the plain forward and
    backward on the CPU) differentiated by autograd against the same; and
    the JAX Pallas kernel in interpret mode."""
    rng = np.random.default_rng(sq * 31 + skv + prefix)
    q = rng.standard_normal((2, 4, sq, 32), np.float32)
    k = rng.standard_normal((2, 2, skv, 32), np.float32)
    v = rng.standard_normal((2, 2, skv, 32), np.float32)
    do = rng.standard_normal((2, 4, sq, 32), np.float32)
    kw = dict(causal=True, window=window, prefix_len=prefix)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)

    want, vjp = jax.vjp(lambda q, k, v: jax_mha_ref(q, k, v, **kw),
                        jq, jk, jv)
    jg = vjp(jnp.asarray(do))
    o, lse = flash_fwd_ref(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(_np(o), np.asarray(want), **TOL)
    with use_kernel_backend("pallas"):
        jo = jax_flash(jq, jk, jv, block_q=4, block_kv=4, backend="pallas",
                       **kw)
    np.testing.assert_allclose(_np(o), np.asarray(jo), **TOL)

    dq, dk, dv = flash_bwd_ref(_t(q), _t(k), _t(v), _t(do), lse,
                               flash_delta_ref(_t(do), o), **kw)
    for got, ref in zip((dq, dk, dv), jg):
        np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)

    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, **kw)
    grads = torch.autograd.grad((out * _t(do)).sum(), (tq, tk, tv))
    np.testing.assert_allclose(_np(out), np.asarray(want), **TOL)
    for got, ref in zip(grads, jg):
        np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


def test_flash_prefix_is_not_the_causal_mask():
    """Queries inside the prefix see the prefix keys past their diagonal:
    the prefix output differs from the causal one exactly on the rows
    before ``prefix_len - 1`` and equals it on the rows after."""
    rng = np.random.default_rng(7)
    q, k, v = (_t(rng.standard_normal((1, 2, 10, 32), np.float32))
               for _ in range(3))
    pre = flash_attention_fwd(q, k, v, prefix_len=6)[0]
    causal = flash_attention_fwd(q, k, v)[0]
    assert not torch.allclose(pre[:, :, :5], causal[:, :, :5])
    torch.testing.assert_close(pre[:, :, 5:], causal[:, :, 5:])
    with pytest.raises(ValueError, match="prefix_len"):
        flash_attention_fwd(q, k, v, prefix_len=-1)


# ---------------------------------------------------------------------------
# the embedding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_prefix", [False, True])
def test_embed_matches_jax(pali, with_prefix):
    """Token embeddings times sqrt(d_model), then the prefix embeddings in
    front, unscaled."""
    tm, tp, jm, jp = pali
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, (2, 7))
    pre = _prefix(2, 2, tm.cfg) if with_prefix else None
    want = jm._embed(jp, jnp.asarray(toks),
                     None if pre is None else jnp.asarray(pre))
    got = tm._embed(tp, _t(toks), None if pre is None else _t(pre))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    p = 0 if pre is None else pre.shape[1]
    assert got.shape == (2, p + 7, tm.cfg.d_model)
    if pre is not None:
        np.testing.assert_array_equal(_np(got[:, :p]), pre)


def test_embed_bf16_is_bit_equal_to_jax():
    """At paligemma's d_model 2048 in bf16: JAX multiplies the bf16 array
    by sqrt(2048) rounded to bf16 (45.25); the port's product equals it
    bit for bit (a product by the unrounded f32 scale differs)."""
    cfg = dataclasses.replace(get_config("paligemma_3b"), vocab_size=4096)
    jcfg = dataclasses.replace(jax_get_config("paligemma_3b"),
                               vocab_size=4096)
    rng = np.random.default_rng(3)
    table = rng.standard_normal((4096, 2048)).astype(np.float32)
    toks = rng.integers(0, 4096, (2, 48))
    pre = rng.standard_normal((2, 5, 2048)).astype(np.float32)
    tm = LM(cfg, device="cpu")
    emb = _t(table).to(torch.bfloat16)
    got = tm._embed({"embed": emb}, _t(toks), _t(pre))
    want = JaxLM(jcfg)._embed({"embed": jnp.asarray(table, jnp.bfloat16)},
                              jnp.asarray(toks), jnp.asarray(pre))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_np(got.float()),
                                  np.asarray(want, np.float32))
    naive = emb[_t(toks)] * 2048 ** 0.5
    assert not torch.equal(naive, got[:, 5:])


# ---------------------------------------------------------------------------
# reduced paligemma_3b
# ---------------------------------------------------------------------------

def test_paligemma_3b_program_matches_jax():
    """The whole paligemma_3b builds: 18 dense layers, pageable, as the JAX
    LM builds it, with the prefix reaching attention only under
    ``prefix_lm``."""
    tm = LM(get_config("paligemma_3b"), device="cpu")
    jm = JaxLM(jax_get_config("paligemma_3b"))
    assert [(s.kind, s.n) for s in tm.program] == [("dense", 18)]
    assert [(s.kind, s.n) for s in jm.program] == [("dense", 18)]
    assert tm.pageable and jm.pageable
    assert tm.embed_scale == 45.25
    pre = torch.zeros((1, 256, 2048))
    assert tm._prefix_len(pre) == 256 and tm._prefix_len(None) == 0
    off = LM(dataclasses.replace(tm.cfg, prefix_lm=False), device="cpu")
    assert off._prefix_len(pre) == 0


def test_params_convert_with_no_new_leaves(pali):
    """``from_jax_params`` carries paligemma's tree as it is: the untied
    head and the dense stack, no frontend parameters; the port's own init
    has the JAX tree's every path, shape and dtype."""
    tm, tp, jm, jp = pali
    assert sorted(tp) == sorted(jp) == ["embed", "final_norm", "head",
                                        "stacks"]
    init = tm.init(torch.Generator().manual_seed(0))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for tree in (tp, init):
        tflat = list(leaves_with_path(tree))
        assert len(tflat) == len(jflat)
        for (path, want), (key, got) in zip(jflat, tflat):
            assert jax.tree_util.keystr(path) == key
            assert tuple(got.shape) == want.shape, key
            assert str(got.dtype).split(".")[-1] == str(want.dtype), key
    for (path, want), (_, got) in zip(jflat, leaves_with_path(tp)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert tm.param_count(tp) == jm.param_count(jp)


@pytest.mark.parametrize("variant", ["reduced", "d256"])
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_forward_and_prefill_with_prefix_match_jax(pali, pali256, variant,
                                                   backend):
    """``forward`` logits over 8 prefix embeddings and 9 tokens, and
    ``prefill``'s last logits and its KV cache, against the JAX LM under
    both kernel backends (Pallas in interpret mode)."""
    tm, tp, jm, jp = pali if variant == "reduced" else pali256
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 9))
    pre = _prefix(5, 2, tm.cfg)
    with use_kernel_backend(backend):
        jl, _ = jm.forward(jp, jnp.asarray(toks), jnp.asarray(pre))
        jlp, jc = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(pre),
                             max_len=24)
    reset_launches()
    tl, aux = tm.forward(tp, _t(toks), _t(pre))
    tlp, tc = tm.prefill(tp, _t(toks), _t(pre), max_len=24)
    assert not any(launch_counts().values())        # the CPU launches none
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(_np(tlp), np.asarray(jlp), **TOL)
    assert float(aux.abs().sum()) == 0.0 and tc["pos"] == 17
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc["stacks"][0][key]),
                                   np.asarray(jc["stacks"][0][key]), **TOL)


def test_prefix_changes_the_output(pali):
    """The same weights and inputs with ``prefix_lm=False`` (the prefix
    attended causally) give other logits at the prefix positions and after
    them: the mask reaches the layers."""
    tm, tp, _, _ = pali
    toks = _t(np.random.default_rng(6).integers(0, 512, (2, 5)))
    pre = _t(_prefix(7, 2, tm.cfg))
    causal = LM(dataclasses.replace(tm.cfg, prefix_lm=False), device="cpu")
    lm_on, _ = tm.forward(tp, toks, pre)
    lm_off, _ = causal.forward(tp, toks, pre)
    assert not torch.allclose(lm_on[:, 0], lm_off[:, 0], **TOL)
    assert not torch.allclose(lm_on[:, -1], lm_off[:, -1], **TOL)


@pytest.mark.parametrize("variant", ["reduced", "d256"])
def test_loss_and_grads_with_prefix_match_jax(pali, pali256, variant):
    """``LM.loss`` over 8 prefix embeddings and 11 tokens, and every
    parameter's gradient, against ``jax.value_and_grad`` of the JAX loss
    under the Pallas backend."""
    tm, tp, jm, jp = pali if variant == "reduced" else pali256
    rng = np.random.default_rng(8)
    toks = rng.integers(0, 512, (2, 11)).astype(np.int32)
    pre = _prefix(9, 2, tm.cfg)
    with use_kernel_backend("pallas"):
        (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
            jp, {"tokens": jnp.asarray(toks),
                 "prefix_embeddings": jnp.asarray(pre)})
    tp = unflatten(tp, [p.detach().clone().requires_grad_()
                        for p in leaves(tp)])
    loss, met = tm.loss(tp, {"tokens": _t(toks),
                             "prefix_embeddings": _t(pre)})
    grads = unflatten(tp, torch.autograd.grad(loss, leaves(tp)))
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    np.testing.assert_allclose(float(met["ce"].detach()), float(jmet["ce"]),
                               **TOL)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    tflat = list(leaves_with_path(grads))
    assert len(jflat) == len(tflat)
    for (path, a), (key, b) in zip(jflat, tflat):
        assert jax.tree_util.keystr(path) == key
        np.testing.assert_allclose(_np(b), np.asarray(a), **TOL,
                                   err_msg=f"grad {key}")


@pytest.mark.parametrize("variant", ["reduced", "d256"])
def test_greedy_steps_after_a_prefix_prefill_match_jax(pali, pali256,
                                                       variant):
    """A prefill over 8 prefix embeddings and 6 tokens, then 6 greedy
    steps: the tokens equal the JAX LM's, and the last step's logits agree
    within 1e-4."""
    tm, tp, jm, jp = pali if variant == "reduced" else pali256
    toks = np.random.default_rng(10).integers(0, 512, (2, 6))
    pre = _prefix(11, 2, tm.cfg)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(pre), max_len=24)
    tl, tc = tm.prefill(tp, _t(toks), _t(pre), max_len=24)
    jt = np.asarray(jm.greedy_token(jl))
    tt = tm.greedy_token(tl)
    np.testing.assert_array_equal(_np(tt), jt)
    for step in range(6):
        jn, jlog, jc = jm.greedy_step(jp, jnp.asarray(jt[:, None]), jc)
        tn, tlog, tc = tm.greedy_step(tp, tt[:, None], tc)
        jt, tt = np.asarray(jn), tn
        np.testing.assert_array_equal(_np(tt), jt, err_msg=f"step {step}")
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
    assert tc["pos"] == 8 + 6 + 6


@pytest.mark.parametrize("variant", ["reduced", "d256"])
def test_generate_tokens_match_jax_on_both_paths(pali, pali256, variant):
    """``generate`` with no prefix (as the JAX ``generate`` serves): the
    default path is the engine (paligemma is pageable), whose tokens equal
    the JAX ``Engine``'s; ``engine="static"`` gives the JAX static loop's
    tokens (that loop without its mesh: the JAX ``_generate_static`` hits
    a ShardingTypeError under this JAX version); and the two paths agree."""
    tm, tp, jm, jp = pali if variant == "reduced" else pali256
    prompts = np.random.RandomState(12).randint(
        0, tm.cfg.vocab_size, (3, 9)).astype(np.int32)
    paged, ps = generate(tm, tp, prompts, gen_tokens=7, page_size=8)
    static, ss = generate(tm, tp, prompts, gen_tokens=7, engine="static")
    assert ps["engine"] and not ss["engine"]
    jeng = JaxEngine(jm, jp, batch=3, max_len=16, page_size=8)
    rids = [jeng.submit(p.tolist(), 7) for p in prompts]
    jout = jeng.drain(max_steps=500)
    np.testing.assert_array_equal(paged, np.array([jout[r] for r in rids]))
    np.testing.assert_array_equal(static,
                                  _jax_static_loop(jm, jp, prompts, 7, 16))
    np.testing.assert_array_equal(static, paged)

