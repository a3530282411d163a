"""The port's Hopper kernels against their plain PyTorch versions on the
card, at small f32 shapes and their edge cases (tolerance 1e-4: f32 math
with sums in another order). Marked ``cuda``; without a card every test
skips. Run them on the card with

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_fwd_ref,
                                                 paged_decode_attention,
                                                 paged_decode_ref)
from repro_torch.kernels.lm_head import lm_head_logits, lm_head_logits_ref
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


def test_each_launch_counts_once(dev):
    reset_launches()
    x = _rnd(dev, 2, 64)
    rmsnorm(x, torch.ones(64, device=dev))
    lm_head_logits(x, _rnd(dev, 64, 128))
    q = _rnd(dev, 1, 2, 3, 32)
    flash_attention_fwd(q, q, q)
    counts = launch_counts()
    assert counts == {"rmsnorm": 1, "flash_fwd": 1, "paged_decode": 0,
                      "lm_head": 1}
