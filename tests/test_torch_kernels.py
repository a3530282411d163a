"""Kernel modules of the PyTorch port against the JAX package, on the CPU.

Each kernel module's plain version (what its wrapper runs for a CPU tensor)
is held against the JAX op twice on the same numpy inputs: once against the
jnp oracle and once against the Pallas kernel in interpret mode. Tolerances:
1e-5 elementwise (rmsnorm, softmax statistics), 1e-4 for matmul-like
outputs (attention, logits) whose f32 sums run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (flash_attention_fwd as jax_flash_fwd,
                                           mha_ref as jax_mha_ref,
                                           paged_decode_attention as jax_paged,
                                           paged_decode_ref as jax_paged_ref)
from repro.kernels.lm_head import (lm_head_logits as jax_lm_head,
                                   lm_head_logits_ref as jax_lm_head_ref)
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref

from repro_torch.kernels import KERNELS, launch_counts, reset_launches
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_fwd,
                                                 flash_bwd, flash_delta,
                                                 mha_ref,
                                                 paged_decode_attention)
from repro_torch.kernels.lm_head import lm_head_ce, lm_head_logits
from repro_torch.kernels.rmsnorm import rmsnorm

EW = dict(rtol=1e-5, atol=1e-5)
MM = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 20, 64), (7, 128), (1, 1, 48)])
def test_rmsnorm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape, np.float32) * 3
    w = rng.standard_normal(shape[-1:], np.float32)
    got = _np(rmsnorm(_t(x), _t(w), eps=1e-5))
    np.testing.assert_allclose(got, np.asarray(jax_rmsnorm_ref(
        jnp.asarray(x), jnp.asarray(w), eps=1e-5)), **EW)
    np.testing.assert_allclose(got, np.asarray(jax_rmsnorm(
        jnp.asarray(x), jnp.asarray(w), eps=1e-5, block_rows=4,
        backend="pallas")), **EW)


# ---------------------------------------------------------------------------
# flash prefill: ragged lengths, GQA, queries aligned to the end of kv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,skv,h,hk", [(5, 5, 4, 2), (9, 9, 4, 1),
                                         (3, 3, 4, 4), (7, 7, 8, 2),
                                         (4, 11, 4, 2)])
def test_flash_prefill_matches_jax(sq, skv, h, hk):
    rng = np.random.default_rng(sq * 31 + skv)
    b, d = 2, 32
    q = rng.standard_normal((b, h, sq, d), np.float32)
    k = rng.standard_normal((b, hk, skv, d), np.float32)
    v = rng.standard_normal((b, hk, skv, d), np.float32)
    o, lse = flash_attention_fwd(_t(q), _t(k), _t(v), causal=True)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    np.testing.assert_allclose(_np(o), np.asarray(jax_mha_ref(jq, jk, jv)),
                               **MM)
    jo, jlse = jax_flash_fwd(jq, jk, jv, causal=True, block_q=16, block_kv=16,
                             backend="pallas")
    np.testing.assert_allclose(_np(o), np.asarray(jo), **MM)
    np.testing.assert_allclose(_np(lse), np.asarray(jlse), **EW)
    np.testing.assert_allclose(
        _np(flash_attention(_t(q), _t(k), _t(v))), _np(o))


@pytest.mark.parametrize("window,prefix_len", [(3, 0), (None, 4), (2, 3)])
def test_mha_ref_window_and_prefix_masks_match_jax(window, prefix_len):
    """The oracle keeps the JAX oracle's sliding-window and prefix-LM masks
    (the Hopper prefill kernel is causal-only so far)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 4, 6, 32), np.float32)
    k = rng.standard_normal((1, 2, 9, 32), np.float32)
    v = rng.standard_normal((1, 2, 9, 32), np.float32)
    np.testing.assert_allclose(
        _np(mha_ref(_t(q), _t(k), _t(v), window=window,
                    prefix_len=prefix_len)),
        np.asarray(jax_mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               window=window, prefix_len=prefix_len)), **MM)


# ---------------------------------------------------------------------------
# paged decode: shuffled pages, GQA, idle slot on the null page
# ---------------------------------------------------------------------------

def _paged_case(seed, g, page):
    rng = np.random.default_rng(seed)
    b, hk, d, nsp = 3, 2, 32, 4
    h = hk * g
    npages = b * nsp + 1
    q = rng.standard_normal((b, h, 1, d), np.float32)
    kp = rng.standard_normal((npages, hk, page, d), np.float32)
    vp = rng.standard_normal((npages, hk, page, d), np.float32)
    perm = rng.permutation(np.arange(1, npages)).reshape(b, nsp)
    table = perm.astype(np.int32)
    table[2] = 0                            # slot 2 idle: the null page
    kv_len = np.array([3 * page + 2, page - 1, 1], np.int32)
    pos = np.full((npages, page), -1, np.int32)
    for bi in range(2):                     # live slots: positional pages
        for j in range(nsp):
            p = np.arange(j * page, (j + 1) * page)
            pos[table[bi, j]] = np.where(p < kv_len[bi], p, -1)
    return q, kp, vp, table, kv_len, pos


@pytest.mark.parametrize("g,page", [(1, 4), (2, 8), (4, 5)])
def test_paged_decode_matches_jax(g, page):
    q, kp, vp, table, kv_len, pos = _paged_case(g * 10 + page, g, page)
    got = _np(paged_decode_attention(_t(q), _t(kp), _t(vp),
                                     block_table=_t(table), kv_len=_t(kv_len),
                                     pos_pages=_t(pos)))
    assert (got[2] == 0).all()              # idle slot: exact 0, not NaN
    args = [jnp.asarray(a) for a in (q, kp, vp)]
    kw = dict(block_table=jnp.asarray(table), kv_len=jnp.asarray(kv_len),
              pos_pages=jnp.asarray(pos))
    np.testing.assert_allclose(got, np.asarray(jax_paged_ref(*args, **kw)),
                               **MM)
    np.testing.assert_allclose(
        got, np.asarray(jax_paged(*args, backend="pallas", **kw)), **MM)


# ---------------------------------------------------------------------------
# LM head: logits, row max, first-occurrence argmax (ties), padded vocab
# ---------------------------------------------------------------------------

def _head_case(seed, R, d, V):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((R, d), np.float32),
            rng.standard_normal((d, V), np.float32))


def _check_head(x, w, vocab, block_v=16):
    lg, m, arg = lm_head_logits.raw(_t(x), _t(w), vocab=vocab)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    for ref in (jax_lm_head_ref(jx, jw, vocab=vocab),
                jax_lm_head.raw(jx, jw, vocab=vocab, block_r=4,
                                block_v=block_v, block_k=8,
                                backend="pallas")):
        np.testing.assert_allclose(_np(lg), np.asarray(ref[0]), **MM)
        np.testing.assert_allclose(_np(m), np.asarray(ref[1]), **MM)
        assert (_np(arg) == np.asarray(ref[2])[:x.shape[0]]).all()
    return _np(arg)


@pytest.mark.parametrize("vocab", [96, 70, 1])
def test_lm_head_matches_jax(vocab):
    x, w = _head_case(vocab, R=8, d=16, V=96)
    _check_head(x, w, vocab)
    np.testing.assert_allclose(
        _np(lm_head_logits(_t(x), _t(w), vocab=vocab)),
        _np(lm_head_logits.raw(_t(x), _t(w), vocab=vocab)[0]))


@pytest.mark.parametrize("cols", [(9, 41), (3, 5), (17, 63)])
def test_lm_head_argmax_ties_pick_first(cols):
    """Equal maxima within one vocab block and across blocks: the first
    column wins, as in the TPU kernel."""
    x, w = _head_case(5, R=4, d=8, V=64)
    x = np.abs(x)
    for c in cols:
        w[:, c] = 3.0
    arg = _check_head(x, w, 64)
    assert (arg == cols[0]).all()


def test_lm_head_reads_transposed_head_in_place():
    """The tied head is ``embed.T``: a strided view, same answer."""
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((96, 16), np.float32)
    x = rng.standard_normal((3, 16), np.float32)
    got = lm_head_logits.raw(_t(x), _t(emb).T, vocab=90)
    ref = jax_lm_head_ref(jnp.asarray(x), jnp.asarray(emb).T, vocab=90)
    for a, b_ in zip(got, ref):
        np.testing.assert_allclose(_np(a), np.asarray(b_), **MM)


# ---------------------------------------------------------------------------
# wrappers: CPU tensors take the plain version, others launch or raise
# ---------------------------------------------------------------------------

def test_cpu_calls_do_not_count_as_launches():
    reset_launches()
    x = torch.randn(4, 32)
    rmsnorm(x, torch.ones(32))
    lm_head_logits.raw(x, torch.randn(32, 64))
    q = torch.randn(1, 2, 3, 32)
    flash_attention_fwd(q, q, q)
    assert launch_counts() == {name: 0 for name in KERNELS}


def test_non_cuda_devices_raise_instead_of_falling_back():
    x = torch.empty((4, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm(x, torch.empty((32,), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        lm_head_logits(x, torch.empty((32, 64), device="meta"))
    q = torch.empty((1, 2, 3, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd(q, q, q, q, torch.empty((1, 2, 3), device="meta"),
                  torch.empty((1, 2, 3), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        flash_delta(q, q)
    i32 = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        lm_head_ce.raw(x, torch.empty((32, 64), device="meta"),
                       torch.empty((4, 1), **i32))
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention(
            q[:, :, :1], torch.empty((3, 2, 4, 32), device="meta"),
            torch.empty((3, 2, 4, 32), device="meta"),
            block_table=torch.empty((1, 2), **i32),
            kv_len=torch.empty((1,), **i32),
            pos_pages=torch.empty((3, 4), **i32))
