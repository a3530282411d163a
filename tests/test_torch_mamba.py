"""The port's mamba1 path against the JAX package, on the CPU: the plain
selective scan (y and hT) against the JAX ``ssm_scan`` in Pallas interpret
mode and its oracle, its gradients against ``jax.vjp``, the mamba1 layer
pieces, and reduced ``falcon_mamba_7b``'s forward (JAX under both kernel
backends), prefill and decode.

Tolerances: 1e-5 for the scan and elementwise pieces (f32 recurrences in
the same order), 1e-4 for layer and model outputs and gradients (f32 sums
in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.ssm_scan import selective_scan_assoc as jax_scan_assoc
from repro.kernels.ssm_scan import selective_scan_ref as jax_scan_ref
from repro.kernels.ssm_scan import ssm_scan_pallas as jax_scan_pallas
from repro.layers import blocks as jax_blocks
from repro.layers import mamba as jax_mamba
from repro.layers.common import softplus as jax_softplus
from repro.layers.common import use_kernel_backend
from repro.models import LM as JaxLM

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_fwd, ssm_scan_state
from repro_torch.layers import blocks, mamba
from repro_torch.layers.common import softplus
from repro_torch.models import LM, from_jax_params
from repro_torch.models.lm import _layer

EW = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def falcon():
    jm = JaxLM(jax_reduced(jax_get_config("falcon_mamba_7b")))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = LM(reduced(get_config("falcon_mamba_7b")), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return tm, tp, jm, jp


def _scan_inputs(seed, bt, L, dm, n, h0=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bt, L, dm), np.float32)
    delta = (np.log1p(np.exp(rng.standard_normal((bt, L, dm))))
             * 0.1).astype(np.float32)
    A = -(np.abs(rng.standard_normal((dm, n))) + 0.1).astype(np.float32)
    B = rng.standard_normal((bt, L, n), np.float32)
    C = rng.standard_normal((bt, L, n), np.float32)
    D = rng.standard_normal((dm,), np.float32)
    hz = rng.standard_normal((bt, dm, n), np.float32) if h0 else None
    return (x, delta, A, B, C, D), hz


# ---------------------------------------------------------------------------
# the scan's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bt,L,dm,n,chunk", [(2, 48, 16, 4, 16),
                                             (1, 37, 24, 8, 37),
                                             (3, 300, 8, 16, 60)])
def test_plain_scan_matches_jax_interpret(bt, L, dm, n, chunk):
    """y and hT of the plain chunked scan (the CPU side of ``ssm_scan_fwd``)
    against the JAX op in Pallas interpret mode and its sequential oracle,
    with a carried-in state h0; L = 300 spans three of the plain version's
    128-step chunks, the last one partial."""
    args, h0 = _scan_inputs(L, bt, L, dm, n)
    y, hT = ssm_scan_fwd(*map(_t, args), h0=_t(h0))
    jargs = [jnp.asarray(a) for a in args]
    jy, jhT = jax_scan_pallas(*jargs, h0=jnp.asarray(h0), chunk=chunk)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **EW)
    np.testing.assert_allclose(_np(hT), np.asarray(jhT), **EW)
    ry, rhT = jax_scan_ref(*jargs, h0=jnp.asarray(h0))
    np.testing.assert_allclose(_np(y), np.asarray(ry), **EW)
    np.testing.assert_allclose(_np(hT), np.asarray(rhT), **EW)


@pytest.mark.parametrize("with_state", [False, True])
def test_scan_gradients_match_jax_vjp(with_state):
    """``ssm_scan`` (y) and ``ssm_scan_state`` (y and hT, from a given h0)
    differentiate their plain version, as the JAX op's OpVJP differentiates
    the associative-scan oracle."""
    args, h0 = _scan_inputs(3, 2, 20, 8, 4, h0=with_state)
    rng = np.random.default_rng(4)
    gy = rng.standard_normal((2, 20, 8), np.float32)
    leaves = [_t(a).requires_grad_() for a in args]
    jargs = [jnp.asarray(a) for a in args]
    if with_state:
        leaves.append(_t(h0).requires_grad_())
        ghT = rng.standard_normal((2, 8, 4), np.float32)
        y, hT = ssm_scan_state(*leaves[:6], h0=leaves[6])
        got = torch.autograd.grad((y, hT), leaves, (_t(gy), _t(ghT)))
        _, vjp = jax.vjp(lambda *a: jax_scan_assoc(*a[:6], h0=a[6]),
                         *jargs, jnp.asarray(h0))
        want = vjp((jnp.asarray(gy), jnp.asarray(ghT)))
    else:
        got = torch.autograd.grad(ssm_scan(*leaves), leaves, _t(gy))
        _, vjp = jax.vjp(lambda *a: jax_scan_assoc(*a)[0], *jargs)
        want = vjp(jnp.asarray(gy))
    for name, a, b in zip("x delta A B C D h0".split(), got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL,
                                   err_msg=name)


def test_scan_fwd_refuses_gradients_and_cpu_counts_nothing():
    args, _ = _scan_inputs(5, 1, 6, 4, 4, h0=False)
    x = _t(args[0]).requires_grad_()
    with pytest.raises(RuntimeError, match="no autograd graph"):
        ssm_scan_fwd(x, *map(_t, args[1:]))
    # delta is mamba's f32 softplus output; a bf16 one is refused, not
    # rounded into exp(delta A)
    with pytest.raises(ValueError, match="delta must be float32"):
        ssm_scan_fwd(_t(args[0]), _t(args[1]).bfloat16(),
                     *map(_t, args[2:]))
    reset_launches()
    ssm_scan(*map(_t, args))
    assert launch_counts()["ssm_scan"] == 0


# ---------------------------------------------------------------------------
# the mamba1 layer
# ---------------------------------------------------------------------------

def test_layer_pieces_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 12), np.float32) * 5
    w = rng.standard_normal((4, 12), np.float32)
    b = rng.standard_normal((12,), np.float32)
    np.testing.assert_allclose(
        _np(mamba._causal_conv(_t(x), _t(w), _t(b))),
        np.asarray(jax_mamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b))), **EW)
    np.testing.assert_allclose(_np(mamba._rms_nw(_t(x))),
                               np.asarray(jax_mamba._rms_nw(jnp.asarray(x))),
                               **EW)
    z = np.concatenate([x.ravel(), [30.0, -30.0, 0.0]]).astype(np.float32)
    np.testing.assert_allclose(_np(softplus(_t(z))),
                               np.asarray(jax_softplus(jnp.asarray(z))), **EW)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_mamba1_forward_matches_jax(falcon, backend):
    tm, tp, jm, jp = falcon
    lp = jax.tree.map(lambda a: a[0], jp["stacks"][0])
    x = np.random.default_rng(7).standard_normal((2, 11, tm.cfg.d_model),
                                                 np.float32)
    with use_kernel_backend(backend):
        want, _ = jax_blocks.mamba_block_forward(lp, jnp.asarray(x), jm.cfg)
    got = blocks.mamba_block_forward(_layer(tp["stacks"][0], 0), _t(x),
                                     tm.cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_mamba1_prefill_and_decode_match_jax(falcon):
    """The block's prefill (forward + final state + conv tail) and then six
    decode steps of the conv window and state, cache compared each step."""
    tm, tp, jm, jp = falcon
    lp = jax.tree.map(lambda a: a[0], jp["stacks"][0])
    tl = _layer(tp["stacks"][0], 0)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 7, tm.cfg.d_model), np.float32)
    jy, _, jc = jax_blocks.mamba_block_prefill(lp, jnp.asarray(x), jm.cfg)
    ty, tc = blocks.mamba_block_prefill(tl, _t(x), tm.cfg)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    for key in ("conv", "h"):
        np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]), **TOL)
    for step in range(6):
        xt = rng.standard_normal((2, 1, tm.cfg.d_model), np.float32)
        jy, jc = jax_blocks.mamba_block_decode(lp, jnp.asarray(xt), jc,
                                               jm.cfg)
        ty, tc = blocks.mamba_block_decode(tl, _t(xt), tc, tm.cfg)
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(_np(tc["h"]), np.asarray(jc["h"]), **TOL)


def test_mamba1_prefill_is_differentiable(falcon):
    """The prefill's scan keeps its graph: its output's gradients equal the
    forward's, for every mixer weight (the scan's inputs among them)."""
    tm, tp, _, _ = falcon
    x = _t(np.random.default_rng(10).standard_normal(
        (2, 9, tm.cfg.d_model), np.float32))
    grads = []
    for run in (lambda p: blocks.mamba_block_prefill(p, x, tm.cfg)[0],
                lambda p: blocks.mamba_block_forward(p, x, tm.cfg)):
        p = {k: (v.detach().clone().requires_grad_() if k == "norm" else
                 {n: w.detach().clone().requires_grad_()
                  for n, w in v.items()})
             for k, v in _layer(tp["stacks"][0], 0).items()}
        leaves = [p["norm"], *p["mixer"].values()]
        grads.append(torch.autograd.grad(run(p).square().sum(), leaves))
    for a, b in zip(*grads):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_short_prefill_pads_the_conv_tail(falcon):
    """A prompt shorter than the conv's K - 1 = 3 taps leaves zeros in
    front of its tail, as the causal conv pads."""
    tm, tp, _, _ = falcon
    x = torch.randn(1, 2, tm.cfg.d_model)
    _, c = blocks.mamba_block_prefill(_layer(tp["stacks"][0], 0), x, tm.cfg)
    assert c["conv"].shape == (1, 3, tm.cfg.resolved_d_inner)
    assert (c["conv"][:, 0] == 0).all()


# ---------------------------------------------------------------------------
# reduced falcon_mamba_7b
# ---------------------------------------------------------------------------

def test_params_convert_with_the_mamba_leaves(falcon):
    tm, tp, _, jp = falcon
    mixer = tp["stacks"][0]["mixer"]
    assert sorted(mixer) == sorted(jp["stacks"][0]["mixer"]) == sorted(
        ["in_x", "in_z", "conv_w", "conv_b", "x_proj", "dt_w", "dt_bias",
         "A_log", "D", "out_proj"])
    assert sorted(tp["stacks"][0]) == ["mixer", "norm"]
    init = tm.init(torch.Generator().manual_seed(0))
    for path, want in jax.tree_util.tree_leaves_with_path(jp):
        got = init
        for key in path:
            got = got[getattr(key, "key", getattr(key, "idx", None))]
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_falcon_forward_matches_jax(falcon, backend):
    tm, tp, jm, jp = falcon
    toks = np.random.default_rng(9).integers(0, tm.cfg.vocab_size, (2, 12))
    with use_kernel_backend(backend):
        jl, _ = jm.forward(jp, jnp.asarray(toks))
    tl, aux = tm.forward(tp, _t(toks))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    assert float(aux.abs().sum()) == 0.0


def test_falcon_prefill_decode_match_jax(falcon):
    tm, tp, jm, jp = falcon
    rng = np.random.default_rng(10)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 9))
    jl, jc = jm.prefill(jp, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, _t(toks))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    assert tm.cache_capacity(tc) is None and not tm.has_positional_cache
    assert not tm.pageable
    for step in range(8):                  # past the prompt: O(1) state
        t = rng.integers(0, tm.cfg.vocab_size, (2, 1))
        jn, jl, jc = jm.greedy_step(jp, jnp.asarray(t), jc)
        tn, tl, tc = tm.greedy_step(tp, _t(t), tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(_np(tn), np.asarray(jn))
    assert tc["pos"] == int(jc["pos"]) == 17


def test_falcon_init_cache_matches_jax_layout(falcon):
    tm, _, jm, _ = falcon
    tc, jc = tm.init_cache(3, 16), jm.init_cache(3, 16)
    assert tc["pos"] == 0
    for key in ("conv", "h"):
        assert tuple(tc["stacks"][0][key].shape) == \
            jc["stacks"][0][key].shape
    assert tc["stacks"][0]["h"].dtype == torch.float32
