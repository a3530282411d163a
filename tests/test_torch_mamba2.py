"""The port's mamba2 (SSD) path and the zamba2 hybrid against the JAX
package, on the CPU: ``ssd_ref`` and ``ssd_chunked`` (with h0, at a chunk
that must shrink); the plain selective scan at state size 64 against the
JAX ``ssm_scan`` op, its final state viewed per head against the SSD
state; ``mamba2_forward`` on its kernel route against the JAX layer under
both kernel backends; the mamba2 block's prefill cache (and a prompt
shorter than the conv) and ``mamba2_decode`` step by step; the plain flash
attention at zamba2's head dim 112; and reduced ``zamba2_7b`` at state 64
with a mamba2 tail (two groups of two layers and the shared block, then
one layer): the parameter tree, forward, loss with every gradient, prefill
logits and caches, and 8 greedy tokens of a prefill + ``greedy_step`` loop.

Tolerances, all f32: 1e-5 for the SSD forms and ops (f32 recurrences and
sums in the same or a close order), 1e-4 for layer and model outputs and
gradients (sums in another order), 2e-3 where the port's kernel route
meets the JAX SSD form at model level (as the JAX package holds its own
two routes, ``test_mamba2_pallas_kernel_route_matches_ssd``); tokens
exactly."""

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
from repro.kernels.ssm_scan import ssm_scan_pallas as jax_scan_pallas
from repro.layers import blocks as jax_blocks
from repro.layers import mamba as jax_mamba
from repro.layers.common import use_kernel_backend
from repro.models import LM as JaxLM

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.ssm_scan import ssm_scan_fwd
from repro_torch.launch.serve import generate
from repro_torch.layers import blocks, mamba
from repro_torch.models import LM, from_jax_params
from repro_torch.models.lm import _layer
from repro_torch.tree import leaves, leaves_with_path, unflatten

from test_torch_moe import _jax_static_loop

EW = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
ROUTE = dict(rtol=2e-3, atol=2e-3)
# reduced zamba2 at its published state size, with a mamba2 tail
CHANGES = dict(n_layers=5, ssm_state=64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def zamba():
    """(torch LM, torch params, JAX LM, JAX params): the port's weights
    converted from the JAX init."""
    jm = JaxLM(dataclasses.replace(jax_reduced(jax_get_config("zamba2_7b")),
                                   **CHANGES))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = LM(dataclasses.replace(reduced(get_config("zamba2_7b")), **CHANGES),
            device="cpu")
    return tm, from_jax_params(jax.tree.map(np.asarray, jp),
                               device="cpu"), jm, jp


def _group_layer(tree, i, j):
    return _layer(_layer(tree, i), j)


def _ssd_inputs(seed, b, L, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, L, h, p), np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, L, h)))) * 0.1).astype(
        np.float32)
    A = -(np.abs(rng.standard_normal((h,))) + 0.5).astype(np.float32)
    Bm = rng.standard_normal((b, L, n), np.float32)
    Cm = rng.standard_normal((b, L, n), np.float32)
    h0 = rng.standard_normal((b, h, p, n), np.float32)
    return x, dt, A, Bm, Cm, h0


# ---------------------------------------------------------------------------
# the SSD forms and the scan at state size 64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,chunk", [(30, 8), (16, 128), (7, 4)])
def test_ssd_forms_match_jax(L, chunk):
    """``ssd_ref`` and ``ssd_chunked`` (y and the final state, from a
    carried-in h0) against the JAX functions; 30 steps at chunk 8 shrink
    it to 6, 7 at 4 to 1."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(L, 2, L, 3, 4, 64)
    j = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    np.testing.assert_allclose(
        _np(mamba.ssd_ref(*map(_t, (x, dt, A, Bm, Cm)))),
        np.asarray(jax_mamba.ssd_ref(*j)), **EW)
    y, S = mamba.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), chunk=chunk,
                             h0=_t(h0))
    jy, jS = jax_mamba.ssd_chunked(*j, chunk=chunk, h0=jnp.asarray(h0))
    np.testing.assert_allclose(_np(y), np.asarray(jy), **EW)
    np.testing.assert_allclose(_np(S), np.asarray(jS), **EW)


@pytest.mark.parametrize("b,L,h,p", [(2, 33, 3, 8), (1, 140, 2, 16)])
def test_scan_at_state_64_is_the_ssd_recurrence(b, L, h, p):
    """The plain scan (the CPU side of ``ssm_scan_fwd``) at n = 64 with
    mamba2's inputs (dt and A repeated over each head's p channels, A
    broadcast along n, D per channel): y and hT against the JAX
    ``ssm_scan`` op in Pallas interpret mode, and hT viewed as (B, H, P,
    N) against the final state of JAX ``ssd_chunked``, whose y plus the D
    skip is the scan's y."""
    n = 64
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(L + p, b, L, h, p, n)
    D = np.random.default_rng(1).standard_normal((h,), np.float32)
    xc = x.reshape(b, L, h * p)
    dt_ch = np.repeat(dt, p, axis=-1)
    A_ch = np.broadcast_to(np.repeat(A, p)[:, None], (h * p, n)).copy()
    D_ch = np.repeat(D, p)
    h0c = h0.reshape(b, h * p, n)
    y, hT = ssm_scan_fwd(*map(_t, (xc, dt_ch, A_ch, Bm, Cm, D_ch)),
                         h0=_t(h0c))
    jy, jhT = jax_scan_pallas(*map(jnp.asarray,
                                   (xc, dt_ch, A_ch, Bm, Cm, D_ch)),
                              h0=jnp.asarray(h0c), chunk=32)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **EW)
    np.testing.assert_allclose(_np(hT), np.asarray(jhT), **EW)
    sy, sS = jax_mamba.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                   h0=jnp.asarray(h0))
    np.testing.assert_allclose(_np(hT.view(b, h, p, n)), np.asarray(sS),
                               **EW)
    sy = np.asarray(sy) + D[:, None] * x
    np.testing.assert_allclose(_np(y), sy.reshape(b, L, h * p), **EW)


# ---------------------------------------------------------------------------
# the mamba2 layer and block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_mamba2_forward_kernel_route_matches_jax(zamba, backend):
    """The port's mamba2 mixer (the kernel route on either device) against
    the JAX layer under the SSD form (``jnp``) and its own kernel route
    (``pallas``, interpret mode)."""
    tm, tp, jm, jp = zamba
    lp = jax.tree.map(lambda a: a[0, 0], jp["stacks"][0])["mixer"]
    x = np.random.default_rng(2).standard_normal((2, 19, tm.cfg.d_model),
                                                 np.float32)
    with use_kernel_backend(backend):
        want = jax_mamba.mamba2_forward(lp, jnp.asarray(x), jm.cfg)
    got = mamba.mamba2_forward(_group_layer(tp["stacks"][0], 0, 0)["mixer"],
                               _t(x), tm.cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **ROUTE)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("L", [7, 2, 1])
def test_mamba2_block_prefill_and_decode_match_jax(zamba, L):
    """The block's prefill (output, the raw pre-conv xBC tail and the final
    SSD state (B, H, P, N)) and then six decode steps of the conv window
    and state, the cache compared at each step. A prompt shorter than the
    conv's K - 1 = 3 taps: the JAX tail holds its L rows, the port's the
    same rows after zeros (as the causal conv pads), which is the window
    the JAX decode cannot start from, so the decode steps run at L = 7
    only."""
    tm, tp, jm, jp = zamba
    lp = jax.tree.map(lambda a: a[1, 0], jp["stacks"][0])
    tl = _group_layer(tp["stacks"][0], 1, 0)
    rng = np.random.default_rng(3 + L)
    x = rng.standard_normal((2, L, tm.cfg.d_model), np.float32)
    jy, _, jc = jax_blocks.mamba_block_prefill(lp, jnp.asarray(x), jm.cfg)
    ty, tc = blocks.mamba_block_prefill(tl, _t(x), tm.cfg)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(tc["h"]), np.asarray(jc["h"]), **TOL)
    kc, cdim = tm.cfg.ssm_conv, tm.cfg.resolved_d_inner + 2 * 64
    assert tc["conv"].shape == (2, kc - 1, cdim)
    assert tc["h"].shape == (2, 256 // 32, 32, 64) == jc["h"].shape
    rows = min(L, kc - 1)
    np.testing.assert_allclose(_np(tc["conv"][:, -rows:]),
                               np.asarray(jc["conv"]), **TOL)
    assert (tc["conv"][:, :kc - 1 - rows] == 0).all()
    if L < kc - 1:
        return
    for step in range(6):
        xt = rng.standard_normal((2, 1, tm.cfg.d_model), np.float32)
        jy, jc = jax_blocks.mamba_block_decode(lp, jnp.asarray(xt), jc,
                                               jm.cfg)
        ty, tc = blocks.mamba_block_decode(tl, _t(xt), tc, tm.cfg)
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL,
                                   err_msg=f"step {step}")
        for key in ("conv", "h"):
            np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]),
                                       **TOL, err_msg=f"{key} step {step}")


@pytest.mark.parametrize("where", ["group", "tail"])
def test_mamba2_decode_continues_the_forward(zamba, where):
    """Decoding token by token from an empty cache gives the full-sequence
    forward's outputs (the state update is the scan's recurrence), for a
    layer of a zamba group and for the mamba2 tail's layer."""
    tm, tp, _, _ = zamba
    tl = (_group_layer(tp["stacks"][0], 0, 1) if where == "group"
          else _layer(tp["stacks"][1], 0))
    x = _t(np.random.default_rng(4).standard_normal(
        (2, 9, tm.cfg.d_model), np.float32))
    full = blocks.mamba_block_forward(tl, x, tm.cfg)
    cache = blocks.mamba_block_cache_init(tm.cfg, 2, torch.float32, "cpu")
    steps = [blocks.mamba_block_decode(tl, x[:, t:t + 1], cache, tm.cfg)[0]
             for t in range(9)]
    np.testing.assert_allclose(_np(torch.cat(steps, dim=1)), _np(full), **TOL)


@pytest.mark.parametrize("sq,skv", [(13, 13), (5, 21), (64, 64)])
def test_flash_attention_head_dim_112_matches_jax(sq, skv):
    """The plain flash forward at zamba2's head dim 112 (sm_scale
    1/sqrt(112)) against the JAX op in Pallas interpret mode and its
    oracle, lse against the scores' logsumexp in numpy."""
    rng = np.random.default_rng(sq + skv)
    q = rng.standard_normal((2, 4, sq, 112), np.float32)
    k = rng.standard_normal((2, 4, skv, 112), np.float32)
    v = rng.standard_normal((2, 4, skv, 112), np.float32)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o, lse = flash_attention_fwd(_t(q), _t(k), _t(v), causal=True)
    with use_kernel_backend("pallas"):
        jo = jax_flash(jq, jk, jv, causal=True, block_q=8, block_kv=8,
                       backend="pallas")
    np.testing.assert_allclose(_np(o), np.asarray(jo), **TOL)
    np.testing.assert_allclose(
        _np(o), np.asarray(jax_mha_ref(jq, jk, jv, causal=True)), **TOL)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(112.0)
    qpos = np.arange(sq)[:, None] + skv - sq
    s = np.where(np.arange(skv)[None, :] <= qpos, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(_np(lse), want, **TOL)


# ---------------------------------------------------------------------------
# reduced zamba2_7b
# ---------------------------------------------------------------------------

def test_zamba2_7b_program_matches_jax():
    """The whole zamba2_7b: 13 groups of 6 mamba2 layers, each followed by
    the shared block, then a tail of 3, not pageable, as the JAX LM
    builds it."""
    tm = LM(get_config("zamba2_7b"), device="cpu")
    jm = JaxLM(jax_get_config("zamba2_7b"))
    want = [("zamba_group", 13, 6), ("mamba2", 3, 0)]
    assert [(s.kind, s.n, s.group) for s in tm.program] == want
    assert [(s.kind, s.n, s.group) for s in jm.program] == want
    assert not tm.pageable and not jm.pageable


def test_params_convert_with_the_nested_stacks(zamba):
    """``from_jax_params`` carries the (groups, group, ...) mamba2 leaves,
    the tail stack and ``shared_attn`` across with their values; the port's
    own init has the JAX tree's every path, shape and dtype."""
    tm, tp, jm, jp = zamba
    assert sorted(tp) == sorted(jp) == ["embed", "final_norm", "head",
                                        "shared_attn", "stacks"]
    assert tp["stacks"][0]["mixer"]["in_xbc"].shape == (2, 2, 128, 384)
    assert tp["stacks"][1]["mixer"]["A_log"].shape == (1, 8)
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


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_zamba_forward_matches_jax(zamba, backend):
    tm, tp, jm, jp = zamba
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab_size, (2, 12))
    with use_kernel_backend(backend):
        jl, _ = jm.forward(jp, jnp.asarray(toks))
    reset_launches()
    tl, aux = tm.forward(tp, _t(toks))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **ROUTE)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    assert float(aux.abs().sum()) == 0.0
    assert not any(launch_counts().values())        # the CPU launches none


def test_zamba_loss_and_grads_match_jax(zamba):
    """``LM.loss`` and every leaf's gradient (the shared block's summed
    over its two applications) against ``jax.value_and_grad`` of the JAX
    loss under the Pallas backend."""
    tm, tp, jm, jp = zamba
    toks = np.random.default_rng(6).integers(0, 512, (2, 13)).astype(
        np.int32)
    with use_kernel_backend("pallas"):
        (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
            jp, {"tokens": jnp.asarray(toks)})
    tp = unflatten(tp, [p.detach().clone().requires_grad_()
                        for p in leaves(tp)])
    loss, met = tm.loss(tp, {"tokens": _t(toks)})
    grads = unflatten(tp, torch.autograd.grad(loss, leaves(tp)))
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    np.testing.assert_allclose(float(met["ce"].detach()), float(jmet["ce"]), **TOL)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    tflat = list(leaves_with_path(grads))
    assert len(jflat) == len(tflat)
    for (path, a), (key, b) in zip(jflat, tflat):
        assert jax.tree_util.keystr(path) == key
        np.testing.assert_allclose(_np(b), np.asarray(a), **TOL,
                                   err_msg=f"grad {key}")


def _tree_close(got, want, tol, where=""):
    """Leaf by leaf; the JAX attention cache's per-layer ``pos`` scalar has
    no counterpart (the port keeps the position once, ``cache["pos"]``)."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(k for k in want if k != "pos"), where
        for k in got:
            _tree_close(got[k], want[k], tol, f"{where}[{k!r}]")
        return
    if isinstance(got, list):
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            _tree_close(g, w, tol, f"{where}[{i}]")
        return
    assert tuple(got.shape) == np.asarray(want).shape, where
    np.testing.assert_allclose(_np(got), np.asarray(want), **tol,
                               err_msg=where)


def test_zamba_prefill_matches_jax(zamba):
    """Last-token logits and every cache leaf: per group the mamba2 conv
    tails (2, 2, B, 3, di + 2N) and SSD states (2, 2, B, H, P, N), one
    KV cache per application of the shared block (2, B, Hk, max_len, hd),
    the tail's mamba2 cache; the cache's capacity and position."""
    tm, tp, jm, jp = zamba
    toks = np.random.default_rng(7).integers(0, 512, (2, 11))
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=20)
    tl, tc = tm.prefill(tp, _t(toks), max_len=20)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    _tree_close(tc["stacks"], jc["stacks"], TOL)
    assert tc["pos"] == int(jc["pos"]) == 11
    assert tm.cache_capacity(tc) == jm.cache_capacity(jc) == 20
    assert tm.has_positional_cache and jm.has_positional_cache
    ic, jic = tm.init_cache(2, 20), jm.init_cache(2, 20)
    _tree_close(ic["stacks"], jic["stacks"], TOL)


def test_zamba_greedy_tokens_match_jax_loop(zamba):
    """8 greedy tokens of the port's static ``generate`` against the JAX
    ``LM.prefill`` + ``greedy_step`` loop (the JAX ``generate`` static path
    runs under a mesh, which fails on this package's reference), and the
    decode steps' logits against JAX's through the same caches."""
    tm, tp, jm, jp = zamba
    prompts = np.random.RandomState(8).randint(0, 512, (3, 9)).astype(
        np.int32)
    want = _jax_static_loop(jm, jp, prompts, 8, 17)
    out, stats = generate(tm, tp, prompts, gen_tokens=8)
    assert not stats["engine"] and not tm.pageable and not jm.pageable
    np.testing.assert_array_equal(out, want)
    jl, jc = jm.prefill(jp, jnp.asarray(prompts), max_len=17)
    tl, tc = tm.prefill(tp, _t(prompts), max_len=17)
    for step in range(3):
        t = np.asarray(want[:, step:step + 1])
        jn, jl, jc = jm.greedy_step(jp, jnp.asarray(t), jc)
        tn, tl, tc = tm.greedy_step(tp, _t(t.astype(np.int64)), tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(_np(tn), np.asarray(jn))
    _tree_close(tc["stacks"], jc["stacks"], TOL)
