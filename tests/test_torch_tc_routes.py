"""The tensor-core routes of ``matmul`` and the CE-head backward, and the
ring's up-front refusal of gradients it has no kernel for, on the CPU.

* The route rules (``matmul.ops.route``, ``lm_head.ops.bwd_route``) are pure
  functions of dtype, strides and alignment: held here on CPU tensors'
  metadata.
* The CE backward's tensor-core route keeps dl = g (p - onehot) as two bf16
  planes, hi = bf16(dl) and lo = bf16(dl - hi), and sums both planes'
  products in f32 (``lm_head_bwd_split_ref``): held against the f32-dl
  ``lm_head_bwd_ref`` and the JAX ``lm_head_bwd`` (Pallas, interpret mode, as
  ``tests/test_torch_train.py`` runs it) on the same seeded inputs rounded to
  bf16.
* ``ring_flash_attention`` still differentiates on the CPU at head dim 128
  (against the JAX local ring), and its refusal of an f32 d = 128 gradient
  on the card comes before any launch (the device test stubbed out); a bf16
  one is not refused (the tensor-core backward takes d = 128).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ring as jax_ring
from repro.kernels.lm_head import lm_head_ce as jax_ce

from repro_torch.kernels.flash_attention import ring as ring_mod
from repro_torch.kernels.flash_attention import ring_flash_attention
from repro_torch.kernels.flash_attention.ops import RING_BWD_HEAD_DIMS
from repro_torch.kernels.lm_head import (bwd_route, lm_head_bwd_ref,
                                         lm_head_bwd_split_ref,
                                         lm_head_ce_stats_ref, split_hi_lo)
from repro_torch.kernels.matmul.ops import route

BF = torch.bfloat16


def _np(t):
    return t.detach().cpu().numpy()


def _bf(*shape):
    return torch.zeros(shape, dtype=BF)


# ---------------------------------------------------------------------------
# the route rules
# ---------------------------------------------------------------------------

MATMUL_ROUTES = {
    "bf16, aligned rows": (lambda: (_bf(64, 128), _bf(128, 72)), "wgmma"),
    "bf16, ragged M": (lambda: (_bf(67, 128), _bf(128, 72)), "wgmma"),
    "f32": (lambda: (_bf(64, 128).float(), _bf(128, 72).float()), "simt"),
    "bf16, K = 70 (a's rows 140 bytes)": (
        lambda: (_bf(64, 70), _bf(70, 72)), "simt"),
    "bf16, N = 70 (b's rows 140 bytes)": (
        lambda: (_bf(64, 128), _bf(128, 70)), "simt"),
    "bf16, a's base 2 bytes off": (
        lambda: (_bf(64 * 128 + 1)[1:].view(64, 128), _bf(128, 72)), "simt"),
    "bf16, a a view of wider rows": (
        lambda: (_bf(64, 136)[:, :128], _bf(128, 72)), "wgmma"),
    "bf16, b transposed (column-major)": (
        lambda: (_bf(64, 128), _bf(72, 128).T), "simt"),
}


@pytest.mark.parametrize("case", list(MATMUL_ROUTES))
def test_matmul_route_rule(case):
    make, want = MATMUL_ROUTES[case]
    assert route(*make()) == want


BWD_ROUTES = {
    "bf16, tied head embed.T": (lambda: (_bf(67, 96), _bf(200, 96).T),
                                "wgmma"),
    "bf16, untied (d, V) head": (lambda: (_bf(67, 96), _bf(96, 200)),
                                 "wgmma"),
    "f32, tied head": (lambda: (_bf(67, 96).float(),
                                _bf(200, 96).float().T), "simt"),
    "bf16, d = 50 (rows 100 bytes)": (lambda: (_bf(67, 50), _bf(200, 50).T),
                                      "simt"),
    "bf16, untied V = 100 (rows 200 bytes)": (
        lambda: (_bf(67, 96), _bf(96, 100)), "simt"),
    "bf16, x's base 2 bytes off": (
        lambda: (_bf(67 * 96 + 1)[1:].view(67, 96), _bf(200, 96).T), "simt"),
    "bf16, w strided both ways": (lambda: (_bf(67, 96), _bf(200, 192)[:, ::2]
                                           .T), "simt"),
}


@pytest.mark.parametrize("case", list(BWD_ROUTES))
def test_lm_head_bwd_route_rule(case):
    make, want = BWD_ROUTES[case]
    assert bwd_route(*make()) == want


# ---------------------------------------------------------------------------
# the hi/lo split of the f32 dl
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e4])
def test_split_hi_lo_reconstructs_within_2_pow_minus_16(scale):
    """Each rounding keeps 8 significant bits and t - hi is exact in f32, so
    |hi + lo - t| <= 2^-16 |t| elementwise (summed in f64: exact)."""
    t = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, 257)).astype(np.float32) * scale)
    t[0, :5] = torch.tensor([0.0, 1.0, -1.0, 2 ** -20, 3.0000002])
    hi, lo = split_hi_lo(t)
    assert hi.dtype == lo.dtype == BF
    err = (hi.double() + lo.double() - t.double()).abs()
    assert (err <= 2.0 ** -16 * t.double().abs()).all(), float(err.max())


def _bwd_inputs(R, d, V, vocab, tied, seed):
    """x, the head w (tied: a transposed (V, d) view), labels, lse, g: x and w
    rounded to bf16 and handed over as f32, as the card's bf16 operands are
    exact in f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, d), np.float32)
    w = rng.standard_normal((V, d) if tied else (d, V), np.float32)
    x, w = (torch.from_numpy(a).to(BF).float() for a in (x, w))
    labels = torch.from_numpy(rng.integers(0, vocab, (R, 1)).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((R, 1), np.float32))
    head = w.T if tied else w
    lse, _ = lm_head_ce_stats_ref(x, head, labels, vocab=vocab)
    return x, w, head, labels, lse, g


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


SPLIT_CASES = [(13, 16, 96, 70, False), (24, 16, 64, 64, True),
               (67, 96, 200, 190, True), (67, 96, 200, 190, False)]


@pytest.mark.parametrize("R,d,V,vocab,tied", SPLIT_CASES)
def test_split_products_match_f32_dl_and_jax(R, d, V, vocab, tied):
    """hi w^T + lo w^T and x^T hi + x^T lo against the f32-dl products of
    lm_head_bwd_ref and of the JAX op's backward: within 2^-14 of the largest
    magnitude (the split's 2^-16 on each dl term plus f32 sums in another
    order). Rounding dl once to bf16 instead misses that by far (its 2^-9
    lands on the label column's g (p - 1), the largest term)."""
    x, w, head, labels, lse, g = _bwd_inputs(R, d, V, vocab, tied, R + V)
    dx, dw = lm_head_bwd_split_ref(x, head, labels, lse, g, vocab=vocab)
    rdx, rdw = lm_head_bwd_ref(x, head, labels, lse, g, vocab=vocab)
    assert dx.shape == (R, d) and dw.shape == (d, V)
    for got, ref in ((dx, rdx), (dw, rdw)):
        assert _rel(got, ref) <= 2.0 ** -14

    jw = jnp.asarray(_np(head))
    args = (jnp.asarray(_np(x)), jw, jnp.asarray(_np(labels)))
    _, vjp = jax.vjp(lambda x_, w_: jax_ce(x_, w_, args[2], vocab=vocab,
                                           block_r=8, block_v=16, block_k=8,
                                           backend="pallas"), *args[:2])
    jdx, jdw = vjp(jnp.asarray(_np(g)[:, 0]))
    assert _rel(dx, torch.from_numpy(np.array(jdx))) <= 2.0 ** -14
    assert _rel(dw, torch.from_numpy(np.array(jdw))) <= 2.0 ** -14

    # one rounding of dl to bf16: the error the split avoids
    cols = torch.arange(V)
    p = torch.where(cols < vocab, torch.exp(x @ head - lse), 0.0)
    dl = (p - ((labels.long() == cols) & (cols < vocab)).float()) * g
    dw_once = torch.matmul(x.T, dl.to(BF).float())
    assert _rel(dw_once, rdw) > 16 * _rel(dw, rdw)


# ---------------------------------------------------------------------------
# ring attention at head dim 128: the CPU differentiates, the card refuses
# up front
# ---------------------------------------------------------------------------

def _qkv128(seed, s=64, h=4, hk=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, n, s, 128).astype("float32") for n in (h, hk, hk)]


@pytest.mark.parametrize("n,extra", [(2, {}), (4, dict(window=24))])
def test_ring_d128_differentiates_on_cpu_like_jax(n, extra):
    """The local ring's o and q/k/v gradients of (o ** 2).sum() at d = 128
    on CPU tensors (plain versions) against the JAX local ring (jnp), 1e-4."""
    arrays = _qkv128(11 + n)
    jkw = dict(causal=True, block_q=32, block_kv=16, backend="jnp", **extra)
    fn = lambda *a: jax_ring.ring_flash_attention(*a, ring_steps=n, **jkw)
    want = [fn(*arrays)] + list(jax.grad(
        lambda *a: (fn(*a) ** 2).sum(), argnums=(0, 1, 2))(*arrays))
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    o = ring_flash_attention(*ts, ring_steps=n, causal=True, **extra)
    got = [o] + list(torch.autograd.grad((o ** 2).sum(), ts))
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.fixture
def card_stub(monkeypatch):
    """ring.py as it runs on the card, with the step kernel replaced by a
    stub that records its calls: the refusal must come before any."""
    calls = []

    def launched(*args, **kwargs):
        calls.append(args)
        raise AssertionError("ring_flash_fwd launched")

    monkeypatch.setattr(ring_mod, "on_cpu", lambda name, *ts: False)
    monkeypatch.setattr(ring_mod, "ring_flash_fwd", launched)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("grad,d,refused", [(True, 128, True),
                                            (False, 128, False),
                                            (True, 64, False)])
def test_ring_refuses_card_gradients_before_launch(card_stub, grad, d,
                                                   refused, dtype):
    """f32 inputs take the CUDA-core backward (head dims 32, 64): a d = 128
    gradient is refused before any launch. bf16 inputs with 16-byte rows
    take the tensor-core backward, which has d = 128 too: never refused."""
    q, k, v = (torch.randn(1, h, 32, d).to(dtype).requires_grad_(grad)
               for h in (4, 2, 2))
    assert 128 not in RING_BWD_HEAD_DIMS["simt"]
    assert 64 in RING_BWD_HEAD_DIMS["simt"]
    assert {64, 128} <= set(RING_BWD_HEAD_DIMS["wgmma"])
    refused = refused and dtype == torch.float32
    if refused:
        with pytest.raises(NotImplementedError, match="head dim 128"):
            ring_flash_attention(q, k, v, ring_steps=2)
        assert card_stub == []
        with torch.no_grad():               # no gradient: the forward runs
            with pytest.raises(AssertionError, match="launched"):
                ring_flash_attention(q, k, v, ring_steps=2)
    else:
        with pytest.raises(AssertionError, match="launched"):
            ring_flash_attention(q, k, v, ring_steps=2)
    assert len(card_stub) == 1
