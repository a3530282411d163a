"""The port's mixture-of-experts against the JAX package, on the CPU:
``_capacity`` over a grid, the router (expert choices exactly, gates and
aux losses close, ties broken toward the lower expert), both dispatches
with a router skewed so that capacity drops choices, ``moe_forward`` with a
shared expert and past one dispatch group, and reduced ``mixtral_8x22b``:
the parameter tree, forward, prefill and 8 static greedy tokens for both
dispatches, the paged engine (``window=None``) against the JAX ``Engine``,
``loss`` with its aux terms and every gradient, and
``active_param_count``.

Tolerances, all f32: 1e-5 for ops, 1e-4 for model outputs (sums in
another order); expert choices and tokens exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.layers import moe as jax_moe
from repro.layers.common import use_kernel_backend
from repro.models import LM as JaxLM
from repro.serving import Engine as JaxEngine

from repro_torch.configs import get_config, reduced
from repro_torch.launch.serve import generate
from repro_torch.layers import moe
from repro_torch.models import LM, from_jax_params
from repro_torch.models.lm import _layer
from repro_torch.serving import Engine
from repro_torch.tree import leaves, leaves_with_path, unflatten

EW = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _cfgs(arch, **changes):
    return (dataclasses.replace(reduced(get_config(arch)), **changes),
            dataclasses.replace(jax_reduced(jax_get_config(arch)), **changes))


def _pair(arch, dispatch="einsum", **changes):
    """(torch LM, torch params, JAX LM, JAX params): the port's weights
    converted from the JAX init of the reduced ``arch``."""
    tc, jc = _cfgs(arch, **changes)
    jm = JaxLM(jc, moe_dispatch=dispatch)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = LM(tc, device="cpu", moe_dispatch=dispatch)
    return tm, from_jax_params(jax.tree.map(np.asarray, jp),
                               device="cpu"), jm, jp


@pytest.fixture(scope="module")
def mixtral():
    return _pair("mixtral_8x22b")


def _moe_params(cfg, seed, skew=0.0):
    """One MoE layer's weights in the JAX tree as numpy arrays; ``skew``
    adds to the router's column of expert 0, so tokens whose features have
    a positive mean pick it."""
    jp = jax_moe.moe_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    jp = jax.tree.map(np.asarray, jp)
    jp["router"] = jp["router"].copy()
    jp["router"][:, 0] += skew
    return jp


def _torch_tree(jp):
    return from_jax_params(jp, device="cpu")


# ---------------------------------------------------------------------------
# capacity and router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,k,e,factor", [
    (1, 2, 8, 1.25), (64, 2, 8, 1.25), (512, 6, 64, 1.25),
    (1024, 2, 8, 1.0), (37, 6, 64, 2.0), (3, 1, 4, 0.5)])
def test_capacity_matches_jax(t, k, e, factor):
    tc, jc = _cfgs("mixtral_8x22b", n_experts=e, n_experts_per_tok=k,
                   capacity_factor=factor)
    assert moe._capacity(t, tc) == jax_moe._capacity(t, jc)


def test_router_matches_jax():
    """Expert choices exactly, gates and both aux losses close; rows of
    zeros (uniform probabilities: a tie over every expert) route as
    ``jax.lax.top_k`` routes them, lowest experts first."""
    tc, jc = _cfgs("deepseek_v2_lite")
    jp = _moe_params(jc, 1)
    x = np.random.default_rng(0).standard_normal((3, 11, tc.d_model),
                                                 np.float32)
    x[1, :4] = 0.0
    jg, ji, jaux = jax_moe._router(jp, jnp.asarray(x), jc)
    tg, ti, taux = moe._router(_torch_tree(jp), _t(x), tc)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    assert (_np(ti[1, :4]) == np.arange(tc.n_experts_per_tok)).all()
    np.testing.assert_allclose(_np(tg), np.asarray(jg), **EW)
    for key in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), **EW)


# ---------------------------------------------------------------------------
# dispatches and the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_dispatch_drops_past_capacity_like_jax(dispatch):
    """A router skewed toward expert 0 overflows its capacity: the dropped
    choices add nothing and the surviving gates are not renormalised, on
    both sides."""
    tc, jc = _cfgs("mixtral_8x22b")
    jp = _moe_params(jc, 2, skew=0.1)
    x = np.random.default_rng(1).standard_normal((2, 24, tc.d_model),
                                                 np.float32) + 1.0
    gate, idx, _ = jax_moe._router(jp, jnp.asarray(x), jc)
    drops = (np.asarray(idx) == 0).sum(axis=(1, 2)) > moe._capacity(24, tc)
    assert drops.all(), "the skew must overflow expert 0 in every group"
    fn = {"einsum": (jax_moe._dispatch_einsum, moe._dispatch_einsum),
          "gather": (jax_moe._dispatch_gather, moe._dispatch_gather)}
    jfn, tfn = fn[dispatch]
    want = jfn(jp, jnp.asarray(x), gate, idx, jc)
    got = tfn(_torch_tree(jp), _t(x), _t(gate), _t(idx).long(), tc)
    np.testing.assert_allclose(_np(got), np.asarray(want), **EW)


@pytest.mark.parametrize("arch,s,dispatch", [
    ("deepseek_v2_lite", 9, "einsum"),        # a shared expert
    ("deepseek_v2_lite", 9, "gather"),
    ("mixtral_8x22b", 1100, "einsum"),        # S > 1024: groups of 550
    ("mixtral_8x22b", 1100, "gather")])
def test_moe_forward_matches_jax(arch, s, dispatch):
    tc, jc = _cfgs(arch)
    jp = _moe_params(jc, 3)
    x = np.random.default_rng(s).standard_normal((2, s, tc.d_model),
                                                 np.float32)
    jy, jaux = jax_moe.moe_forward(jp, jnp.asarray(x), jc, dispatch=dispatch)
    ty, taux = moe.moe_forward(_torch_tree(jp), _t(x), tc, dispatch=dispatch)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    for key in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), **EW)


# ---------------------------------------------------------------------------
# reduced mixtral: the tree, forward, prefill, greedy tokens, the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", ["mixtral_8x22b", "deepseek_v2_lite"])
def test_init_tree_matches_jax(arch, full):
    """The port's ``init`` gives the JAX ``LM.init`` tree: the same paths,
    shapes and dtypes (the moe subtree, MLA's attention keys), on the
    reduced configs and, as shapes only (JAX's ``eval_shape``, the port's
    meta device), on the published ones."""
    tc, jc = _cfgs(arch) if not full else (get_config(arch),
                                           jax_get_config(arch))
    jp = jax.eval_shape(JaxLM(jc).init, jax.random.PRNGKey(0))
    tm = LM(tc, device="cpu")
    if full:
        tm.device = torch.device("meta")
    tp = tm.init(torch.Generator().manual_seed(0))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = list(leaves_with_path(tp))
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [
        k for k, _ in tflat]
    for (path, a), (key, b) in zip(jflat, tflat):
        assert tuple(b.shape) == tuple(a.shape), key
        assert str(b.dtype).split(".")[-1] == str(a.dtype), key


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_mixtral_forward_and_prefill_match_jax(dispatch):
    tm, tp, jm, jp = _pair("mixtral_8x22b", dispatch)
    toks = np.random.default_rng(4).integers(0, 512, (2, 13)).astype(
        np.int32)
    jl, jaux = jm.forward(jp, jnp.asarray(toks))
    tl, taux = tm.forward(tp, _t(toks))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(_np(taux), np.asarray(jaux), **TOL)
    jl, _ = jm.prefill(jp, jnp.asarray(toks), max_len=20)
    tl, _ = tm.prefill(tp, _t(toks), max_len=20)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)


def _jax_static_loop(jm, jp, prompts, gen_tokens, max_len):
    """The JAX ``_generate_static`` loop without its mesh: prefill, then one
    greedy step per token, the first token from the prefill's argmax."""
    logits, cache = jm.prefill(jp, jnp.asarray(prompts, jnp.int32),
                               max_len=max_len)
    tok = np.asarray(jm.greedy_token(logits))
    out = np.zeros((prompts.shape[0], gen_tokens), np.int32)
    step = jax.jit(jm.greedy_step)          # one trace for every step
    for t in range(gen_tokens):
        out[:, t] = tok
        nxt, _, cache = step(jp, jnp.asarray(tok[:, None]), cache)
        tok = np.asarray(nxt)
    return out


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_mixtral_static_tokens_match_jax_loop(dispatch):
    tm, tp, jm, jp = _pair("mixtral_8x22b", dispatch)
    prompts = np.random.RandomState(5).randint(0, 512, (3, 9)).astype(
        np.int32)
    want = _jax_static_loop(jm, jp, prompts, 8, 17)
    out, stats = generate(tm, tp, prompts, gen_tokens=8)
    assert not stats["engine"] and not tm.pageable
    np.testing.assert_array_equal(out, want)


def test_mixtral_without_window_engine_matches_jax_engine():
    """Without its window mixtral is pageable, as in JAX, and the port's
    ``Engine`` emits the JAX ``Engine``'s tokens (more requests than
    slots, so slots refill mid-flight)."""
    tm, tp, jm, jp = _pair("mixtral_8x22b", window=None)
    assert tm.pageable and jm.pageable
    rng = np.random.RandomState(6)
    traffic = [(rng.randint(0, 512, n).tolist(), g)
               for n, g in ((5, 6), (9, 4), (3, 7), (12, 5))]
    outs = []
    for cls, model, params in ((JaxEngine, jm, jp), (Engine, tm, tp)):
        eng = cls(model, params, batch=2, max_len=32, page_size=8)
        rids = [eng.submit(p, m) for p, m in traffic]
        res = eng.drain(max_steps=200)
        outs.append([res[r] for r in rids])
    assert outs[0] == outs[1]
    assert all(len(r) == g for r, (_, g) in zip(outs[1], traffic))


# ---------------------------------------------------------------------------
# loss, aux and every gradient; active parameters
# ---------------------------------------------------------------------------

def assert_loss_and_grads(arch, dispatch):
    """``LM.loss`` (total, ce, moe_lb, moe_z) and every leaf's gradient of
    the reduced ``arch`` against ``jax.value_and_grad`` of the JAX loss
    under the Pallas backend."""
    tm, tp, jm, jp = _pair(arch, dispatch)
    toks = np.random.default_rng(7).integers(0, 512, (2, 17)).astype(
        np.int32)
    with use_kernel_backend("pallas"):
        (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
            jp, {"tokens": jnp.asarray(toks)})
    tp = unflatten(tp, [p.requires_grad_() for p in leaves(tp)])
    loss, met = tm.loss(tp, {"tokens": _t(toks)})
    grads = unflatten(tp, torch.autograd.grad(loss, leaves(tp)))
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    for key in ("ce", "moe_lb", "moe_z"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]), **TOL)
    assert float(met["moe_lb"]) > 0 and float(loss) != float(met["ce"])
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    tflat = list(leaves_with_path(grads))
    assert len(jflat) == len(tflat)
    for (path, a), (key, b) in zip(jflat, tflat):
        assert jax.tree_util.keystr(path) == key
        np.testing.assert_allclose(_np(b), np.asarray(a), **TOL,
                                   err_msg=f"grad {key}")


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_mixtral_loss_and_grads_match_jax(dispatch):
    assert_loss_and_grads("mixtral_8x22b", dispatch)


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "deepseek_v2_lite",
                                  "llama3_2_1b"])
def test_active_param_count_matches_jax(arch):
    tm, tp, jm, jp = _pair(arch)
    assert tm.param_count(tp) == jm.param_count(jp)
    assert tm.active_param_count(tp) == jm.active_param_count(jp)


def test_moe_block_returns_aux_like_jax(mixtral):
    """A MoE block's forward returns the JAX block's aux vector."""
    from repro.layers import blocks as jax_blocks

    from repro_torch.layers import blocks

    tm, tp, jm, jp = mixtral
    x = np.random.default_rng(8).standard_normal((2, 7, tm.cfg.d_model),
                                                 np.float32)
    lp = jax.tree.map(lambda a: a[0], jp["stacks"][0])
    jy, jaux = jax_blocks.tblock_forward(lp, jnp.asarray(x), jm.cfg, moe=True)
    ty, taux = blocks.tblock_forward(_layer(tp["stacks"][0], 0), _t(x),
                                     tm.cfg, moe=True)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(taux), np.asarray(jaux), **EW)
