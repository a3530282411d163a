"""The port's Hopper kernels against their plain PyTorch versions on the
card, at small f32 shapes and their edge cases (tolerance 1e-4: f32 math
with sums in another order). Marked ``cuda``; without a card every test
skips. Run them on the card with

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels import KERNELS, launch_counts, reset_launches
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_fwd,
                                                 flash_bwd, flash_bwd_ref,
                                                 flash_delta, flash_delta_ref,
                                                 flash_fwd_ref, mha_ref,
                                                 paged_decode_attention,
                                                 paged_decode_ref)
from repro_torch.kernels.lm_head import (lm_head_bwd, lm_head_bwd_ref,
                                         lm_head_ce, lm_head_ce_stats_ref,
                                         lm_head_logits, lm_head_logits_ref)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref

pytestmark = pytest.mark.cuda
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rnd(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel(dev, dtype):
    x = _rnd(dev, 5, 3, 2048).to(dtype)
    w = _rnd(dev, 2048, seed=1)
    tol = TOL if dtype == torch.float32 else dict(atol=1e-6, rtol=2 ** -7)
    torch.testing.assert_close(rmsnorm(x, w, eps=1e-5),
                               rmsnorm_ref(x, w, eps=1e-5), **tol)


@pytest.mark.parametrize("sq,skv,hk,d", [(5, 5, 2, 32), (9, 9, 1, 64),
                                         (70, 70, 4, 64), (4, 11, 2, 32),
                                         (130, 200, 2, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_kernel(dev, sq, skv, hk, d, causal):
    q = _rnd(dev, 2, sq, 4, d).transpose(1, 2)          # strided view
    k, v = _rnd(dev, 2, hk, skv, d, seed=1), _rnd(dev, 2, hk, skv, d, seed=2)
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = flash_fwd_ref(q, k, v, causal=causal)
    torch.testing.assert_close(o, ro, **TOL)
    torch.testing.assert_close(lse, rlse, **TOL)


def test_flash_fwd_rejects_unsupported_head_dim(dev):
    q = _rnd(dev, 1, 2, 4, 48)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("g,page", [(1, 4), (4, 5), (4, 352)])
def test_paged_decode_kernel_idle_slot_is_zero(dev, g, page):
    b, hk, d, nsp = 3, 2, 64, 4
    npages = b * nsp + 1
    q = _rnd(dev, b, hk * g, 1, d)
    kp, vp = _rnd(dev, npages, hk, page, d, seed=1), \
        _rnd(dev, npages, hk, page, d, seed=2)
    table = (torch.randperm(npages - 1) + 1)[:b * nsp].reshape(b, nsp)
    table = table.to(torch.int32)
    table[2] = 0
    kv_len = torch.tensor([3 * page + 2, max(page - 1, 1), 1],
                          dtype=torch.int32)
    pos = torch.full((npages, page), -1, dtype=torch.int32)
    for bi in range(2):
        for j in range(nsp):
            p = torch.arange(j * page, (j + 1) * page, dtype=torch.int32)
            pos[table[bi, j]] = torch.where(p < kv_len[bi], p, -1)
    kw = dict(block_table=table.to(dev), kv_len=kv_len.to(dev),
              pos_pages=pos.to(dev))
    o = paged_decode_attention(q, kp, vp, **kw)
    torch.testing.assert_close(o, paged_decode_ref(q, kp, vp, **kw), **TOL)
    assert (o[2] == 0).all()


@pytest.mark.parametrize("R", [1, 8, 20])
def test_lm_head_kernel_ties_and_tied_head(dev, R):
    x = _rnd(dev, R, 64).abs()
    emb = _rnd(dev, 300, 64, seed=1)
    emb[9] = emb[12] = emb[130] = 3.0          # ties in and across blocks
    for w in (emb.T, emb.T.contiguous()):
        lg, m, arg = lm_head_logits.raw(x, w, vocab=250)
        rlg, rm, rarg = lm_head_logits_ref(x, w, vocab=250)
        torch.testing.assert_close(lg, rlg, **TOL)
        torch.testing.assert_close(m, rm, **TOL)
        assert (arg == 9).all() and torch.equal(arg, rarg)


@pytest.mark.parametrize("R,V,vocab", [(5, 96, 70), (70, 200, 200),
                                        (130, 1100, 1000)])
@pytest.mark.parametrize("tied", [True, False])
def test_lm_head_ce_kernels(dev, R, V, vocab, tied):
    d = 48                                     # ragged against the 16 depth
    x = _rnd(dev, R, d)
    w = _rnd(dev, V, d, seed=1).T if tied else _rnd(dev, d, V, seed=1)
    lab = torch.randint(0, vocab, (R, 1), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(R)).to(dev)
    lse, gold = lm_head_ce.raw(x, w, lab, vocab=vocab)
    rlse, rgold = lm_head_ce_stats_ref(x, w, lab, vocab=vocab)
    torch.testing.assert_close(lse, rlse, **TOL)
    torch.testing.assert_close(gold, rgold, **TOL)
    g = _rnd(dev, R, 1, seed=2)
    dx, dw = lm_head_bwd(x, w, lab, lse, g, vocab=vocab)
    rdx, rdw = lm_head_bwd_ref(x, w, lab, lse, g, vocab=vocab)
    torch.testing.assert_close(dx, rdx, **TOL)
    torch.testing.assert_close(dw, rdw, **TOL)
    assert dw.stride() == ((1, d) if tied else (V, 1))   # w's own layout
    with pytest.raises(ValueError, match="labels"):
        lm_head_ce.raw(x, w, lab.cpu(), vocab=vocab)


@pytest.mark.parametrize("sq,skv,g,d", [(5, 5, 1, 32), (9, 9, 4, 64),
                                        (70, 70, 2, 64), (4, 11, 4, 32),
                                        (130, 200, 4, 64), (7, 4, 2, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernels(dev, sq, skv, g, d, causal):
    """Strided q and do, GQA groups, ragged lengths; (7, 4) causal has rows
    that see no key (lse = -inf): their dq is exactly 0."""
    b, hk = 2, 2
    h = hk * g
    q = _rnd(dev, b, sq, h, d).transpose(1, 2)
    k, v = _rnd(dev, b, hk, skv, d, seed=1), _rnd(dev, b, hk, skv, d, seed=2)
    do = _rnd(dev, b, sq, h, d, seed=3).transpose(1, 2)
    o, lse = flash_fwd_ref(q, k, v, causal=causal)
    delta = flash_delta(do, o)
    torch.testing.assert_close(delta, flash_delta_ref(do, o), **TOL)
    got = flash_bwd(q, k, v, do, lse, delta, causal=causal)
    want = flash_bwd_ref(q, k, v, do, lse, delta, causal=causal)
    for a, b_ in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b_, **TOL)
    if causal and sq > skv:
        assert (got[0][:, :, :sq - skv] == 0).all()


def test_gradients_flow_through_kernels_on_cuda(dev):
    """rmsnorm and flash attention on CUDA tensors record their backward:
    the gradients equal those of the plain versions."""
    x = _rnd(dev, 2, 9, 64).requires_grad_()
    w = _rnd(dev, 64, seed=1).requires_grad_()
    gy = _rnd(dev, 2, 9, 64, seed=2)
    got = torch.autograd.grad(rmsnorm(x, w), (x, w), gy)
    want = torch.autograd.grad(rmsnorm_ref(x, w), (x, w), gy)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, **TOL)
    q = _rnd(dev, 2, 17, 8, 32).transpose(1, 2).requires_grad_()
    k = _rnd(dev, 2, 2, 17, 32, seed=1).requires_grad_()
    v = _rnd(dev, 2, 2, 17, 32, seed=2).requires_grad_()
    go = _rnd(dev, 2, 8, 17, 32, seed=3)
    reset_launches()
    got = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), go)
    counts = launch_counts()
    assert counts["flash_fwd"] == counts["flash_delta"] == \
        counts["flash_bwd"] == 1
    want = torch.autograd.grad(mha_ref(q, k, v), (q, k, v), go)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, **TOL)
    with pytest.raises(RuntimeError, match="no backward"):
        lm_head_logits(x[0], w[:, None])


def test_lm_head_ce_grads_on_cuda_match_cpu(dev):
    x = _rnd(dev, 33, 64).requires_grad_()
    emb = _rnd(dev, 300, 64, seed=1).requires_grad_()
    lab = torch.arange(33, dtype=torch.int32, device=dev)[:, None] * 7
    got = torch.autograd.grad(lm_head_ce(x, emb.T, lab, vocab=250).mean(),
                              (x, emb))
    xc, ec = (t.detach().cpu().requires_grad_() for t in (x, emb))
    want = torch.autograd.grad(lm_head_ce(xc, ec.T, lab.cpu(),
                                          vocab=250).mean(), (xc, ec))
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a.cpu(), b_, **TOL)


def test_each_launch_counts_once(dev):
    reset_launches()
    x = _rnd(dev, 2, 64)
    rmsnorm(x, torch.ones(64, device=dev))
    lm_head_logits(x, _rnd(dev, 64, 128))
    q = _rnd(dev, 1, 2, 3, 32)
    o, lse = flash_attention_fwd(q, q, q)
    delta = flash_delta(q, o)
    flash_bwd(q, q, q, q, lse, delta)
    lab = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    w = _rnd(dev, 64, 128)
    lse2, _ = lm_head_ce.raw(x, w, lab)
    lm_head_bwd(x, w, lab, lse2, torch.ones((2, 1), device=dev))
    assert launch_counts() == {name: 0 if name == "paged_decode" else 1
                               for name in KERNELS}
