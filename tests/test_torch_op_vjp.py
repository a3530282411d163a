"""The ops' backward passes in the port (``repro_torch.core.op``'s
``OpVJP`` and ``oracle_vjp``) against ``jax.vjp`` of the JAX ops, on the
same numpy inputs and cotangents, f32 at tiny shapes, on the CPU (the
port's torch backend; the JAX ops on their jnp expansion):
flash_attention (the delta and fused backward builders), lm_head_ce (the
CE backward builder), ssm_scan (through ``selective_scan_assoc``), and
rmsnorm and the app ops (their plain versions by ``torch.func.vjp``).
Also ``selective_scan_assoc`` against JAX's, and the scan wrapper's
``_SSMScan.backward`` against the JAX op's gradient. Limit: 2e-5 of the
largest |gradient| (1e-5 for the elementwise ops)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.kernels  # noqa: F401 -- registers the JAX ops
from repro.core import registered_ops as jax_ops
from repro.kernels.ssm_scan.ref import selective_scan_assoc as jax_assoc

from repro_torch.core import get_op, to_tensors
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.kernels.ssm_scan.ref import selective_scan_assoc


def _close(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=rel * scale, err_msg=what)


def _grads(name, args, params, diff, *, rel, seed=0):
    """The port op's gradients and the JAX op's (backend jnp) for one
    cotangent, w.r.t. the args at positions ``diff``."""
    op, jop = get_op(name), jax_ops()[name]
    ts, tparams = to_tensors(args, params, "cpu")
    ts = [t.requires_grad_() if i in diff else t for i, t in enumerate(ts)]
    out = op(*ts, **tparams)
    g = np.random.RandomState(seed).standard_normal(tuple(out.shape)).astype(
        np.float32)
    got = torch.autograd.grad(out, [ts[i] for i in diff],
                              torch.from_numpy(g))
    jparams = {k: v for k, v in params.items() if k in jop.defaults}

    def f(*xs):
        full = list(args)
        for i, x in zip(diff, xs):
            full[i] = x
        return jop(*full, backend="jnp", **jparams)

    want_out, pull = jax.vjp(f, *(jnp.asarray(args[i]) for i in diff))
    _close(out.detach().numpy(), want_out, 1e-5, f"{name} forward")
    want = pull(jnp.asarray(g))
    for i, a, b in zip(diff, got, want):
        _close(a.numpy(), b, rel, f"{name} d(arg {i})")


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("masks", [dict(causal=True),
                                   dict(causal=True, window=6, prefix_len=3)],
                         ids=["causal", "window_prefix"])
def test_flash_attention_grads_match_jax(masks):
    rng = np.random.RandomState(0)
    args = (_rand(rng, 1, 4, 16, 8), _rand(rng, 1, 2, 16, 8),
            _rand(rng, 1, 2, 16, 8))
    _grads("flash_attention", args, dict(masks, block_q=8, block_kv=8),
           (0, 1, 2), rel=2e-5)


def test_lm_head_ce_grads_match_jax():
    rng = np.random.RandomState(1)
    # 20 rows pad to a block of 8 (the pre hook), 30 of 32 columns live
    args = (_rand(rng, 20, 16), _rand(rng, 16, 32),
            rng.randint(0, 30, (20, 1)).astype(np.int32))
    _grads("lm_head_ce", args, dict(vocab=30, block_r=8, block_v=16,
                                    block_k=8), (0, 1), rel=2e-5)


def _scan_args(rng, bt=1, L=8, dm=8, n=4):
    x = _rand(rng, bt, L, dm)
    delta = (np.log1p(np.exp(_rand(rng, bt, L, dm))) * 0.1).astype(np.float32)
    A = -(np.abs(_rand(rng, dm, n)) + 0.1).astype(np.float32)
    return (x, delta, A, _rand(rng, bt, L, n), _rand(rng, bt, L, n),
            _rand(rng, dm))


def test_ssm_scan_grads_match_jax():
    args = _scan_args(np.random.RandomState(2))
    _grads("ssm_scan", args, dict(chunk=4, d_block=4), tuple(range(6)),
           rel=2e-5)
    # the wrapper's backward (_SSMScan, the models' entry) on the same
    # inputs and cotangent
    jop = jax_ops()["ssm_scan"]
    g = np.random.RandomState(0).standard_normal(args[0].shape).astype(
        np.float32)
    _, pull = jax.vjp(lambda *a: jop(*a, backend="jnp"),
                      *(jnp.asarray(a) for a in args))
    for i, (a, b) in enumerate(zip(_wrapper_grads(args, g, 8),
                                   pull(jnp.asarray(g)))):
        _close(a.numpy(), b, 2e-5, f"the wrapper's d(arg {i})")


def test_rmsnorm_grads_match_jax():
    rng = np.random.RandomState(3)
    args = (_rand(rng, 3, 5, 16), _rand(rng, 16))
    _grads("rmsnorm", args, dict(eps=1e-6, block_rows=5), (0, 1), rel=1e-5)


@pytest.mark.parametrize("name", ["fd2d", "sem_apply", "dg_volume",
                                  "dg_surface"])
def test_app_op_grads_match_jax(name):
    op = get_op(name)
    args, params = op.example(np.random.RandomState(4))
    diff = tuple(i for i, a in enumerate(args)
                 if np.issubdtype(np.asarray(a).dtype, np.floating))
    _grads(name, args, params, diff, rel=1e-5)


def test_array_params_are_refused_on_the_differentiable_call():
    op = get_op("ssm_scan")
    args, _ = to_tensors(_scan_args(np.random.RandomState(5)), {}, "cpu")
    h0 = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="not differentiable"):
        op(*args, h0=h0)
    y, hT = op.raw(*args, h0=h0)                 # the functional entry
    assert tuple(hT.shape) == (1, 8, 4)


# ---------------------------------------------------------------------------
# the associative scan and the scan wrapper's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [1, 13])
def test_selective_scan_assoc_matches_jax(L):
    rng = np.random.RandomState(6)
    args = _scan_args(rng, bt=2, L=L, dm=6, n=4)
    h0 = _rand(rng, 2, 6, 4)
    y, hT = selective_scan_assoc(*(torch.from_numpy(a) for a in args),
                                 h0=torch.from_numpy(h0))
    jy, jhT = jax_assoc(*(jnp.asarray(a) for a in args),
                        h0=jnp.asarray(h0))
    _close(y.numpy(), jy, 1e-5, "y")
    _close(hT.numpy(), jhT, 1e-5, "hT")


def _wrapper_grads(args, g, step):
    """``ssm_scan``'s gradients, the wrapper called on blocks of ``step``
    channels: the scan is independent per channel, so dx, ddelta, dA and
    dD come a block at a time and dB, dC are summed over the blocks."""
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    gt = torch.from_numpy(g)
    dm = args[0].shape[-1]
    for c0 in range(0, dm, step):
        cs = slice(c0, c0 + step)
        x, delta, A, B, C, D = ts
        y = scan_ops.ssm_scan(x[..., cs].contiguous(),
                              delta[..., cs].contiguous(),
                              A[cs].contiguous(), B, C, D[cs].contiguous())
        y.backward(gt[..., cs])
    return [t.grad for t in ts]


def test_ssm_scan_wrapper_backward_matches_jax_in_channel_blocks():
    """``ssm_scan``'s ``_SSMScan.backward`` (autograd through the plain
    version's time loop), over the whole width and in blocks of four
    channels, gives the JAX op's gradient (jax.vjp of JAX's
    ``selective_scan_assoc``)."""
    args = _scan_args(np.random.RandomState(7), dm=12)
    g = np.random.RandomState(8).standard_normal(args[0].shape).astype(
        np.float32)
    _, pull = jax.vjp(lambda *a: jax_assoc(*a)[0],
                      *(jnp.asarray(a) for a in args))
    want = pull(jnp.asarray(g))
    for step in (12, 4):
        for i, (a, b) in enumerate(zip(_wrapper_grads(args, g, step), want)):
            _close(a.numpy(), b, 2e-5, f"d(arg {i}) in blocks of {step}")
