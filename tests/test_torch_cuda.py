"""The port's Hopper kernels against their plain PyTorch versions on the
card, at small f32 shapes and their edge cases (tolerance 1e-4: f32 math
with sums in another order; bf16 cases 2e-2, one bf16 rounding of outputs
near 1 plus the plain version's bf16 probabilities; the app kernels use the
app tests' 2e-5 for the FD step and 2e-4 of the largest magnitude for the
SEM and DG contractions), and the models that run them, card against CPU.
Marked ``cuda``; without a card every test skips. Run them on the card
with

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.apps import dg_swe, fd2d as fd_app, sem as sem_app
from repro_torch.apps.numerics import fd_second_derivative_weights
from repro_torch.kernels import KERNELS, launch_counts, reset_launches
from repro_torch.kernels.apps import (apply_ref, dg_surface, dg_volume, fd2d,
                                      fd2d_ref, sem_apply, surface_ref,
                                      volume_ref)
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import (decode_ref, flash_attention,
                                                 flash_attention_fwd,
                                                 flash_bwd, flash_bwd_ref,
                                                 flash_decode, flash_delta,
                                                 flash_delta_ref,
                                                 flash_fwd_ref, mha_ref,
                                                 paged_decode_attention,
                                                 paged_decode_ref,
                                                 ring_bwd_ref,
                                                 ring_flash_attention,
                                                 ring_flash_bwd,
                                                 ring_flash_fwd, ring_fwd_ref,
                                                 rolling_slot_pos)
from repro_torch.kernels.matmul import matmul, matmul_ref
from repro_torch.kernels.matmul.ops import route as matmul_route
from repro_torch.kernels.lm_head import (bwd_route, lm_head_bwd,
                                         lm_head_bwd_ref,
                                         lm_head_ce, lm_head_ce_stats_ref,
                                         lm_head_logits, lm_head_logits_ref)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
from repro_torch.kernels.rmsnorm import route as rms_route
from repro_torch.kernels.ssm_scan import (selective_scan_ref, ssm_scan,
                                          ssm_scan_fwd, ssm_scan_state)
from repro_torch.launch.serve import generate
from repro_torch.models import LM, tree_to

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
    fd2d(x, x, weights=(1.0, -2.0, 1.0), dx=0.5, dt=0.1)
    u = _rnd(dev, 2, 3, 3, 3)
    sem_apply(u, _rnd(dev, 2, 7, 3, 3, 3), _rnd(dev, 3, 3))
    q = _rnd(dev, 2, 3, 3).abs() + 1
    dg_volume(q, _rnd(dev, 2, 4), _rnd(dev, 2, 3, 2), _rnd(dev, 3, 3),
              _rnd(dev, 3, 3))
    qf = _rnd(dev, 2, 6, 3).abs() + 1
    dg_surface(qf, qf, qf, _rnd(dev, 3, 6))
    k = _rnd(dev, 1, 2, 5, 32)
    flash_decode(_rnd(dev, 1, 4, 1, 32), k, k, kv_len=3)
    x = _rnd(dev, 1, 4, 8)
    ssm_scan_fwd(x, x.abs(), -_rnd(dev, 8, 4).abs(), _rnd(dev, 1, 4, 4),
                 _rnd(dev, 1, 4, 4), _rnd(dev, 8))
    q = _rnd(dev, 1, 2, 3, 32)
    o, lse = ring_flash_fwd(q, q, q, *_offsets(dev, 0, 0))
    ring_flash_bwd(q, q, q, q, lse, lse, *_offsets(dev, 0, 0))
    matmul(x[0], x[0].T.contiguous())
    matmul(x[0, :, :0], x[0, :0])                       # K == 0: no launch
    assert launch_counts() == {name: 0 if name == "paged_decode" else 1
                               for name in KERNELS}


# ---------------------------------------------------------------------------
# the paper apps' kernels
# ---------------------------------------------------------------------------

APP_REL = 2e-4


def _close_rel(got, ref, rel):
    scale = float(ref.abs().max())
    torch.testing.assert_close(got, ref, atol=rel * scale, rtol=rel)


@pytest.mark.parametrize("h,w,r,block", [(37, 53, 1, (16, 32)),
                                         (50, 29, 2, (8, 16)),
                                         (61, 45, 4, (32, 256)),
                                         (20, 300, 8, (32, 256)),
                                         (33, 70, 3, (0, 0))])
def test_fd2d_kernel(dev, h, w, r, block):
    """h != w, neither a multiple of the tile; r up to 8 (wider than some
    tiles); block (0, 0) is one tile over the whole field."""
    weights = tuple(float(x) for x in fd_second_derivative_weights(r))
    u1, u2 = _rnd(dev, h, w), _rnd(dev, h, w, seed=1)
    dx = 2.0 / w
    dt = 0.3 * dx / 2 ** 0.5
    out = torch.empty_like(u1)
    got = fd2d(u1, u2, weights=weights, dx=dx, dt=dt, block=block, out=out)
    assert got is out
    torch.testing.assert_close(got, fd2d_ref(u1, u2, weights, dx, dt),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("E,nq,eb", [(7, 2, 4), (13, 5, 4), (37, 8, 32),
                                     (5, 8, 1), (3, 11, 2)])
def test_sem_apply_kernel(dev, E, nq, eb):
    """E not a multiple of eb; nq = 11 needs more than 48 KB of shared
    memory."""
    u = _rnd(dev, E, nq, nq, nq)
    geo, dmat = _rnd(dev, E, 7, nq, nq, nq, seed=1), _rnd(dev, nq, nq, seed=2)
    _close_rel(sem_apply(u, geo, dmat, eb=eb), apply_ref(u, geo, dmat),
               APP_REL)


@pytest.mark.parametrize("n,E,eb", [(1, 37, 8), (3, 50, 16), (5, 131, 64),
                                    (5, 10, 64)])
def test_dg_kernels(dev, n, E, eb):
    np_, nfp3 = (n + 1) * (n + 2) // 2, 3 * (n + 1)
    q = 0.1 * _rnd(dev, E, np_, 3)
    q[..., 0] += 1.5                                   # positive depth
    geom, db = _rnd(dev, E, 4, seed=1), _rnd(dev, E, np_, 2, seed=2)
    dr, ds = _rnd(dev, np_, np_, seed=3), _rnd(dev, np_, np_, seed=4)
    _close_rel(dg_volume(q, geom, db, dr, ds, eb=eb),
               volume_ref(q, geom, db, dr, ds), APP_REL)
    qm, qp = 0.1 * _rnd(dev, E, nfp3, 3, seed=5), 0.1 * _rnd(dev, E, nfp3, 3,
                                                             seed=6)
    qm[..., 0] += 1.5
    qp[..., 0] += 1.5
    theta = _rnd(dev, E, nfp3, seed=7)
    nrm = torch.stack([theta.cos(), theta.sin(),
                       _rnd(dev, E, nfp3, seed=8).abs()], -1).contiguous()
    lift = _rnd(dev, np_, nfp3, seed=9)
    _close_rel(dg_surface(qm, qp, nrm, lift, eb=eb),
               surface_ref(qm, qp, nrm, lift), APP_REL)


def test_app_wrappers_raise_on_bad_input(dev):
    w3 = dict(weights=(1.0, -2.0, 1.0), dx=0.1, dt=0.01)
    u = _rnd(dev, 16, 24)
    for bad, match in (((u.double(), u.double()), "float32"),
                       ((u, u.cpu()), "CUDA device"),
                       ((u[:, :16].T, u[:, :16]), "contiguous")):
        with pytest.raises(ValueError, match=match):
            fd2d(*bad, **w3)
    with pytest.raises(ValueError, match="alias"):
        fd2d(u, u, out=u, **w3)
    s, g, d = _rnd(dev, 2, 4, 4, 4), _rnd(dev, 2, 7, 4, 4, 4), _rnd(dev, 4, 4)
    for bad, match in (((s, g, d.double()), "float32"),
                       ((s, g.cpu(), d), "CUDA device"),
                       ((s.transpose(1, 2), g, d), "contiguous")):
        with pytest.raises(ValueError, match=match):
            sem_apply(*bad)
    big = _rnd(dev, 1, 25, 25, 25)
    with pytest.raises(ValueError, match="nq <= 24"):
        sem_apply(big, _rnd(dev, 1, 7, 25, 25, 25), _rnd(dev, 25, 25))
    q, ge, db = _rnd(dev, 4, 3, 3).abs() + 1, _rnd(dev, 4, 4), _rnd(dev, 4, 3, 2)
    dr = _rnd(dev, 3, 3)
    for bad, match in (((q.double(), ge, db, dr, dr), "float32"),
                       ((q, ge, db.cpu(), dr, dr), "CUDA device"),
                       ((q, ge, db, dr.T, dr), "contiguous")):
        with pytest.raises(ValueError, match=match):
            dg_volume(*bad)
    qf, lift = _rnd(dev, 4, 6, 3).abs() + 1, _rnd(dev, 3, 6)
    for bad, match in (((qf, qf, qf, lift.double()), "float32"),
                       ((qf, qf.cpu(), qf, lift), "CUDA device"),
                       ((qf, qf, qf, _rnd(dev, 6, 3).T), "contiguous")):
        with pytest.raises(ValueError, match=match):
            dg_surface(*bad)


def test_app_drivers_on_card_match_cpu(dev):
    fd_g = fd_app.FDWave(width=40, height=56, radius=2, block=(16, 32)).run(20)
    fd_c = fd_app.FDWave(width=40, height=56, radius=2, device="cpu").run(20)
    torch.testing.assert_close(torch.from_numpy(fd_g.solution),
                               torch.from_numpy(fd_c.solution),
                               atol=1e-4, rtol=1e-4)
    kw = dict(ex=3, ey=2, ez=2, n=4, eb=5)
    op_g, op_c = sem_app.SEMOperator(**kw), sem_app.SEMOperator(
        device="cpu", **kw)
    u = torch.randn(op_c.nglob, generator=torch.Generator().manual_seed(0))
    _close_rel(op_g.apply_global(u.to(dev)).cpu(), op_c.apply_global(u),
               APP_REL)
    kw = dict(nx=4, ny=4, n=3, jitter=0.1, eb=7)
    sw_g, sw_c = dg_swe.SWESolver(**kw), dg_swe.SWESolver(device="cpu", **kw)
    x, y = sw_c.mesh["x"], sw_c.mesh["y"]
    h0 = torch.from_numpy(1.0 + 0.1 * np.exp(-20 * (x ** 2 + y ** 2))).float()
    Q = torch.stack([h0, 0 * h0, 0 * h0], -1)
    Qg, Qc = Q.to(dev), Q
    for _ in range(10):
        Qg, Qc = sw_g.step(Qg, 2e-4), sw_c.step(Qc, 2e-4)
    _close_rel(Qg.cpu(), Qc, APP_REL)


# ---------------------------------------------------------------------------
# the static path: flash_decode, ssm_scan, windowed prefill, head dim 128
# ---------------------------------------------------------------------------

def _tol(dtype, ref):
    """f32: TOL. bf16: both sides round o to bf16 (one ulp apart, <= 2^-7
    relative); the plain version rounds p to bf16 before p @ v, which 1%
    of max|o| covers (o averages randn rows, so it is small)."""
    if dtype == torch.float32:
        return TOL
    return dict(atol=0.01 * float(ref.float().abs().max()), rtol=2 ** -7)


# (skv, kv_len, window, rotated after t tokens or None, g, d)
@pytest.mark.parametrize("skv,kv_len,window,t,g,d", [
    (77, 77, None, None, 1, 64), (77, 40, None, None, 4, 64),
    (200, 150, 5, None, 4, 128), (33, 1, None, None, 8, 32),
    (64, 50, 64, 50, 1, 64), (64, 100, 64, 100, 8, 128),
    (40, 173, 64, 173, 4, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel(dev, skv, kv_len, window, t, g, d, dtype):
    b, hk = 3, 2
    q = _rnd(dev, b, 1, hk * g, d).transpose(1, 2).to(dtype)  # strided
    k = _rnd(dev, b, hk, skv, d, seed=1).to(dtype)
    v = _rnd(dev, b, hk, skv, d, seed=2).to(dtype)
    sp = None if t is None else rolling_slot_pos(skv, t).to(dev)
    kw = dict(kv_len=kv_len, window=window, slot_pos=sp)
    ref = decode_ref(q, k, v, **kw)
    torch.testing.assert_close(flash_decode(q, k, v, **kw), ref,
                               **_tol(dtype, ref))


def test_flash_decode_rejects_what_it_cannot_take(dev):
    k = _rnd(dev, 1, 1, 8, 128)
    k256 = _rnd(dev, 1, 1, 8, 256)
    with pytest.raises(ValueError, match="group"):
        flash_decode(_rnd(dev, 1, 16, 1, 256), k256, k256)  # g * d > 2048
    with pytest.raises(ValueError, match="group"):
        flash_decode(_rnd(dev, 1, 32, 1, 32), k[..., :32].contiguous(),
                     k[..., :32].contiguous())             # g > 16
    k48 = _rnd(dev, 1, 1, 8, 48)
    with pytest.raises(ValueError, match="head dims"):
        flash_decode(_rnd(dev, 1, 2, 1, 48), k48, k48)
    ks = _rnd(dev, 1, 1, 8, 128)[..., :64]                 # rows of 128
    with pytest.raises(ValueError, match="rows"):
        flash_decode(_rnd(dev, 1, 2, 1, 64), ks, ks)
    sp = torch.zeros(5, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="slot_pos"):
        flash_decode(_rnd(dev, 1, 2, 1, 32), k[..., :32].contiguous(),
                     k[..., :32].contiguous(), slot_pos=sp)
    assert (flash_decode(_rnd(dev, 1, 4, 1, 32), k[..., :32].contiguous(),
                         k[..., :32].contiguous(), kv_len=4,
                         slot_pos=torch.full((8,), -1, dtype=torch.int32,
                                             device=dev)) == 0).all()


@pytest.mark.parametrize("bt,L,dm,n", [(3, 77, 100, 16), (1, 200, 64, 8),
                                       (2, 5, 33, 4)])
def test_ssm_scan_kernel(dev, bt, L, dm, n):
    x = _rnd(dev, bt, L, dm)
    delta = torch.nn.functional.softplus(_rnd(dev, bt, L, dm, seed=1)) * 0.1
    A = -(_rnd(dev, dm, n, seed=2).abs() + 0.1)
    B, C = _rnd(dev, bt, L, n, seed=3), _rnd(dev, bt, L, n, seed=4)
    D, h0 = _rnd(dev, dm, seed=5), _rnd(dev, bt, dm, n, seed=6)
    for h in (h0, None):
        y, hT = ssm_scan_fwd(x, delta, A, B, C, D, h0=h)
        ry, rhT = selective_scan_ref(x, delta, A, B, C, D, h0=h)
        torch.testing.assert_close(y, ry, **TOL)
        torch.testing.assert_close(hT, rhT, **TOL)


def test_ssm_scan_kernel_bf16_with_f32_delta(dev):
    """bf16 x, B, C with the f32 delta mamba1 feeds it: y rounds to bf16
    once (2^-7 relative), hT stays f32; a bf16 delta is refused."""
    bf = torch.bfloat16
    x = _rnd(dev, 2, 70, 96).to(bf)
    delta = torch.nn.functional.softplus(_rnd(dev, 2, 70, 96, seed=1) - 3)
    A = -torch.arange(1, 17, dtype=torch.float32, device=dev).expand(
        96, 16).contiguous()
    B = _rnd(dev, 2, 70, 16, seed=2).to(bf)
    C = _rnd(dev, 2, 70, 16, seed=3).to(bf)
    D = torch.ones(96, device=dev)
    y, hT = ssm_scan_fwd(x, delta, A, B, C, D)
    ry, rhT = selective_scan_ref(x, delta, A, B, C, D)
    assert y.dtype == bf and hT.dtype == torch.float32
    torch.testing.assert_close(y, ry, atol=1e-2, rtol=2 ** -7)
    torch.testing.assert_close(hT, rhT, atol=1e-3, rtol=1e-3)
    with pytest.raises(ValueError, match="delta must be float32"):
        ssm_scan_fwd(x, delta.to(bf), A, B, C, D)
    with pytest.raises(ValueError, match="state size"):
        ssm_scan_fwd(x, delta, A[:, :5].contiguous(), B[..., :5].contiguous(),
                     C[..., :5].contiguous(), D)


@pytest.mark.parametrize("sq,skv,h,hk,d,causal,window", [
    (130, 130, 4, 2, 64, True, 40), (70, 200, 4, 2, 64, True, 33),
    (130, 130, 8, 2, 64, False, 7), (70, 70, 4, 2, 128, True, None),
    (130, 200, 8, 8, 128, True, 50)])
def test_flash_fwd_kernel_window_and_head_dim_128(dev, sq, skv, h, hk, d,
                                                  causal, window):
    q = _rnd(dev, 2, sq, h, d).transpose(1, 2)
    k, v = _rnd(dev, 2, hk, skv, d, seed=1), _rnd(dev, 2, hk, skv, d, seed=2)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
    ro, rlse = flash_fwd_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(o, ro, **TOL)
    torch.testing.assert_close(lse, rlse, **TOL)


@pytest.mark.parametrize("g,page", [(8, 16), (2, 5)])
def test_paged_decode_kernel_head_dim_128(dev, g, page):
    b, hk, d, nsp = 3, 2, 128, 4
    npages = b * nsp + 1
    q = _rnd(dev, b, hk * g, 1, d)
    kp, vp = _rnd(dev, npages, hk, page, d, seed=1), \
        _rnd(dev, npages, hk, page, d, seed=2)
    table = (torch.arange(b * nsp, dtype=torch.int32) + 1).reshape(b, nsp)
    kv_len = torch.tensor([3 * page + 2, page, 1], dtype=torch.int32)
    pos = torch.full((npages, page), -1, dtype=torch.int32)
    for bi in range(b):
        for j in range(nsp):
            p = torch.arange(j * page, (j + 1) * page, dtype=torch.int32)
            pos[table[bi, j]] = torch.where(p < kv_len[bi], p, -1)
    kw = dict(block_table=table.to(dev), kv_len=kv_len.to(dev),
              pos_pages=pos.to(dev))
    torch.testing.assert_close(paged_decode_attention(q, kp, vp, **kw),
                               paged_decode_ref(q, kp, vp, **kw), **TOL)


def test_attention_without_backward_kernel_refuses_gradients(dev):
    """f32 inputs take flash_bwd.cu's CUDA-core backward, which has no
    window mask and takes head dims <= 64: on the card a gradient through a
    windowed or d = 128 f32 ``flash_attention`` raises before any launch
    instead of coming out wrong; without a gradient both run the kernel.
    (bf16 takes the tensor-core backward, which has both: below.)"""
    for window, d in ((4, 32), (None, 128)):
        q = _rnd(dev, 1, 4, 9, d).requires_grad_()
        k = _rnd(dev, 1, 2, 9, d, seed=1).requires_grad_()
        with pytest.raises(NotImplementedError, match="backward"):
            flash_attention(q, k, k, window=window)
        with torch.no_grad():
            o = flash_attention(q, k, k, window=window)
        torch.testing.assert_close(o, mha_ref(q, k, k, window=window)
                                   .detach(), **TOL)


def test_ssm_scan_gradients_on_cuda_match_cpu(dev):
    """On the card ``ssm_scan`` runs the kernel forward and differentiates
    its plain version: gradients equal the CPU's."""
    x = _rnd(dev, 2, 20, 8)
    delta = torch.nn.functional.softplus(_rnd(dev, 2, 20, 8, seed=1)) * 0.1
    args = [x, delta, -(_rnd(dev, 8, 4, seed=2).abs() + 0.1),
            _rnd(dev, 2, 20, 4, seed=3), _rnd(dev, 2, 20, 4, seed=4),
            _rnd(dev, 8, seed=5)]
    gy = _rnd(dev, 2, 20, 8, seed=6)
    leaves = [a.clone().requires_grad_() for a in args]
    reset_launches()
    got = torch.autograd.grad(ssm_scan(*leaves), leaves, gy)
    assert launch_counts()["ssm_scan"] == 1
    cpu = [a.detach().cpu().requires_grad_() for a in args]
    want = torch.autograd.grad(ssm_scan(*cpu), cpu, gy.cpu())
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a.cpu(), b_, **TOL)
    # the state-returning form a prefill uses, from a given h0
    h0, ghT = _rnd(dev, 2, 8, 4, seed=7), _rnd(dev, 2, 8, 4, seed=8)
    leaves.append(h0.clone().requires_grad_())
    got = torch.autograd.grad(ssm_scan_state(*leaves[:6], h0=leaves[6]),
                              leaves, (gy, ghT))
    cpu.append(h0.cpu().requires_grad_())
    want = torch.autograd.grad(ssm_scan_state(*cpu[:6], h0=cpu[6]), cpu,
                               (gy.cpu(), ghT.cpu()))
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a.cpu(), b_, **TOL)


def _card_and_cpu(cfg, seed=0):
    cpu, gpu = LM(cfg, device="cpu"), LM(cfg)
    p = cpu.init(torch.Generator().manual_seed(seed))
    return cpu, p, gpu, tree_to(p, gpu.device)


def test_internlm2_head_dim_128_serves_on_card_like_cpu(dev):
    """A 2-layer internlm2_1_8b at its widths (head_dim 128) in f32:
    prefill logits and the engine's tokens on the card match the CPU."""
    cfg = dataclasses.replace(get_config("internlm2_1_8b"), n_layers=2,
                              dtype="float32")
    cpu, pc, gpu, pg = _card_and_cpu(cfg)
    prompts = np.random.RandomState(0).randint(1, cfg.vocab_size, (2, 20))
    toks = torch.from_numpy(prompts)
    lc, _ = cpu.prefill(pc, toks)
    lg, _ = gpu.prefill(pg, toks.to(dev))
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-3, rtol=1e-3)
    reset_launches()
    out_g, stats = generate(gpu, pg, prompts, gen_tokens=6, page_size=8)
    assert stats["engine"] and launch_counts()["paged_decode"] > 0
    out_c, _ = generate(cpu, pc, prompts, gen_tokens=6, page_size=8)
    np.testing.assert_array_equal(out_g, out_c)


@pytest.mark.parametrize("arch,changes", [("musicgen_medium", {}),
                                          ("falcon_mamba_7b", {}),
                                          ("llama3_2_1b", dict(window=8))])
def test_static_generate_on_card_matches_cpu(dev, arch, changes):
    """The reduced unpageable models through ``generate`` on the card (the
    static path, flash_decode or ssm_scan launched) give the CPU's tokens."""
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    cpu, pc, gpu, pg = _card_and_cpu(cfg, seed=1)
    prompts = np.random.RandomState(1).randint(0, cfg.vocab_size, (3, 12))
    reset_launches()
    out_g, stats = generate(gpu, pg, prompts, gen_tokens=10)
    counts = launch_counts()
    assert not stats["engine"]
    kernel = "ssm_scan" if cfg.ssm_type else "flash_decode"
    assert counts[kernel] == cfg.n_layers * (1 if cfg.ssm_type else 10)
    out_c, _ = generate(cpu, pc, prompts, gen_tokens=10)
    np.testing.assert_array_equal(out_g, out_c)


# ---------------------------------------------------------------------------
# the ring step kernels and matmul
# ---------------------------------------------------------------------------

def _misaligned(t):
    """A copy of t with its strides whose base lies one element past the
    alignment of t's own: the tensor-core routes refuse it by layout."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].as_strided(t.shape, t.stride())
    out.copy_(t)
    return out


def _offsets(dev, q_start, k_start):
    return (torch.tensor([[q_start]], dtype=torch.int32, device=dev),
            torch.tensor([[k_start]], dtype=torch.int32, device=dev))


RING_CASES = [  # sq, skv, h, hk, d, q_start, k_start, masks
    (70, 45, 4, 2, 32, 30, 50, {}),                  # across the diagonal
    (33, 40, 4, 4, 64, 100, 0, {}),                  # chunk wholly before
    (33, 40, 8, 2, 64, 0, 64, {}),                   # wholly after: dead
    (97, 32, 8, 2, 64, 64, 96, {}),
    (70, 45, 4, 1, 64, 60, 20, dict(window=30)),
    (70, 45, 8, 2, 32, 10, 30, dict(prefix_len=35)),
    (70, 45, 4, 4, 64, 0, 0, dict(causal=False)),
    (70, 45, 8, 2, 128, 30, 50, dict(window=40)),    # d = 128: forward only
]


@pytest.mark.parametrize("case", RING_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_flash_kernels(dev, case, dtype):
    """The step forward and backward against their plain versions: strided
    q and do, GQA, ragged lengths, all three masks; a chunk after the shard
    gives lse = -inf, o = 0 and zero gradients. The forward is held on its
    CUDA-core kernel in both dtypes (bf16 through a copy of q one element
    off the alignment the tensor-core route needs; that route has its own
    test below)."""
    sq, skv, h, hk, d, qs, ks, kw = case
    q = _rnd(dev, 2, sq, h, d).transpose(1, 2).to(dtype)
    k = _rnd(dev, 2, hk, skv, d, seed=1).to(dtype)
    v = _rnd(dev, 2, hk, skv, d, seed=2).to(dtype)
    off = _offsets(dev, qs, ks)
    reset_launches()
    o, lse = ring_flash_fwd(_misaligned(q), k, v, *off, **kw)
    assert ring_flash_fwd.routes == {"wgmma": 0, "simt": 1}
    ro, rlse = ring_fwd_ref(q, k, v, *off, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(o, ro, **TOL)
    else:   # the same f32 o rounded once to bf16: one ulp, <= 2^-7 of a row
        err = (o.float() - ro.float()).abs()
        row_max = ro.float().abs().amax(-1, keepdim=True)
        assert (err <= 2 ** -7 * row_max).all(), float(err.max())
    torch.testing.assert_close(lse, rlse, atol=1e-4 if dtype ==
                               torch.float32 else 1e-3, rtol=1e-4)
    dead = ks > qs + sq - 1 and kw.get("causal", True)
    if dead:
        assert torch.isneginf(lse).all() and (o == 0).all()
    if d == 128:
        return
    do = _rnd(dev, 2, sq, h, d, seed=3).transpose(1, 2).to(dtype)
    delta = flash_delta(do, o) - _rnd(dev, 2, h, sq, seed=4)
    got = ring_flash_bwd(q, k, v, do, lse, delta, *off, **kw)
    want = ring_bwd_ref(q, k, v, do, rlse, delta, *off, **kw)
    for a, b_ in zip(got, want):
        assert torch.isfinite(a).all()
        if dtype == torch.float32:
            torch.testing.assert_close(a, b_, **TOL)
        else:   # dq rounded to bf16 once; dk/dv f32 sums in another order
            _close_rel(a, b_, 2 ** -7 if a.dtype == torch.bfloat16 else 1e-3)
        if dead:
            assert (a == 0).all()


def test_ring_flash_wrappers_reject_what_the_kernels_cannot_take(dev):
    q = _rnd(dev, 1, 4, 9, 64)
    k = _rnd(dev, 1, 2, 9, 64, seed=1)
    off = _offsets(dev, 0, 0)
    with pytest.raises(ValueError, match="one CUDA device"):
        ring_flash_fwd(q, k, k, off[0].cpu(), off[1])
    with pytest.raises(ValueError, match="int32"):
        ring_flash_fwd(q, k, k, off[0].long(), off[1])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ring_flash_fwd(q.half(), k.half(), k.half(), *off)
    q128, k128 = _rnd(dev, 1, 4, 9, 128), _rnd(dev, 1, 2, 9, 128, seed=1)
    o, lse = ring_flash_fwd(q128, k128, k128, *off)
    with pytest.raises(ValueError, match="head dims"):
        ring_flash_bwd(q128, k128, k128, o, lse, lse, *off)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        ring_flash_fwd(q.requires_grad_(), k, k, *off)


@pytest.mark.parametrize("n,kw", [(4, {}), (5, {}), (4, dict(window=48)),
                                  (4, dict(prefix_len=24))])
def test_ring_attention_on_card_matches_cpu(dev, n, kw):
    """The local ring's output and q/k/v gradients, card (kernels) against
    CPU (plain versions), each step kernel launched once per step."""
    s = 160 if n == 5 else 128
    ins = [_rnd(dev, 1, h, s, 32, seed=i) for i, h in enumerate((4, 2, 2))]
    go = _rnd(dev, 1, 4, s, 32, seed=5)

    def run(ts, g):
        ts = [t.detach().requires_grad_() for t in ts]
        o = ring_flash_attention(*ts, ring_steps=n, **kw)
        return [o] + list(torch.autograd.grad(o, ts, g))

    reset_launches()
    got = run(ins, go)
    counts = launch_counts()
    assert counts["ring_flash_fwd"] == counts["ring_flash_bwd"] == n
    want = run([t.cpu() for t in ins], go.cpu())
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a.cpu(), b_, **TOL)


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (100, 70, 130), (129, 257, 65),
                                   (5, 1000, 3), (256, 128, 384)])
@pytest.mark.parametrize("dtypes", [(torch.float32, None),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, None),
                                    (torch.bfloat16, torch.float32)])
def test_matmul_kernel(dev, m, k, n, dtypes):
    dtype, out_dtype = dtypes
    a = _rnd(dev, m, k).to(dtype)
    b = _rnd(dev, k, n, seed=1).to(dtype)
    got = matmul(a, b, out_dtype=out_dtype)
    want = matmul_ref(a, b, out_dtype=out_dtype)
    assert got.dtype == want.dtype
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:       # one rounding of the same f32 sum to bf16
        _close_rel(got, want, 2 ** -7)
    # a transposed-rows view (leading stride != K) takes the same path
    wide = _rnd(dev, m, k + 3, seed=2).to(dtype)[:, :k]
    torch.testing.assert_close(matmul(wide, b, out_dtype=torch.float32),
                               matmul_ref(wide, b, out_dtype=torch.float32),
                               **TOL)


def test_matmul_rejects_what_the_kernel_cannot_take(dev):
    a = _rnd(dev, 4, 8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        matmul(a.half(), a.half().T)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        matmul(a, a.T, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="one CUDA device"):
        matmul(a, a.T.cpu())
    with pytest.raises(ValueError, match="rows"):
        matmul(a.T, a)                          # column-major a


# ---------------------------------------------------------------------------
# the tensor-core routes of matmul and the CE backward; the ring's up-front
# refusal of gradients at head dim 128
# ---------------------------------------------------------------------------

def test_ring_attention_refuses_d128_gradients_before_launch(dev):
    """At d = 128 (the step forward takes it, ring_flash_bwd does not) a
    gradient asked of the local ring raises before the first launch; under
    torch.no_grad() the forward runs."""
    q, k, v = (_rnd(dev, 1, h, 64, 128, seed=i)
               for i, h in enumerate((4, 2, 2)))
    reset_launches()
    with pytest.raises(NotImplementedError, match="head dim 128"):
        ring_flash_attention(q.requires_grad_(), k, v, ring_steps=2)
    assert launch_counts()["ring_flash_fwd"] == 0
    with torch.no_grad():
        o = ring_flash_attention(q, k, v, ring_steps=2)
    assert launch_counts()["ring_flash_fwd"] == 2 and torch.isfinite(o).all()


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A ("data", "model") mesh of one gloo rank in this process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_gqa_ring_branch_refuses_d128_gradients_before_launch(
        dev, one_rank_mesh, monkeypatch):
    """gqa_forward's ring branch (forced onto the one-rank model axis) at
    head dim 128: asking for a gradient raises before any ring launch."""
    from repro_torch.layers import attention as attn
    from repro_torch.parallel import Rules, use_rules

    monkeypatch.setattr(attn, "ring_axis_for",
                        lambda mesh, s, model_axis="model": model_axis)
    cfg = dataclasses.replace(reduced(get_config("llama3_2_1b")),
                              head_dim=128)
    params = attn.gqa_init(torch.Generator(device=dev).manual_seed(0), cfg,
                           torch.float32, dev)
    x = _rnd(dev, 1, 32, cfg.d_model).requires_grad_()
    reset_launches()
    with use_rules(Rules(mesh=one_rank_mesh, ring_axis="model")):
        with pytest.raises(NotImplementedError, match="head dim 128"):
            attn.gqa_forward(params, x, cfg)
    assert launch_counts()["ring_flash_fwd"] == 0


@pytest.mark.parametrize("m,k,n", [(128, 64, 256), (129, 200, 72),
                                   (300, 136, 264), (7, 2056, 520),
                                   (512, 1024, 768)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_matmul_tensor_core_route(dev, m, k, n, out_dtype):
    """bf16 operands with TMA-aligned rows take the wgmma kernel: ragged M,
    N and K against the 128 x 256 x 64 tiles. The products are exact in f32
    on both sides; f32 out differs by the order of K f32 additions (at K =
    2056 ~ sqrt(K) half-ulps of partial sums near the largest |c|): 2^-16
    of the largest magnitude. bf16 out within one rounding (2^-7)."""
    a = _rnd(dev, m, k).to(torch.bfloat16)
    b = _rnd(dev, k, n, seed=1).to(torch.bfloat16)
    assert matmul_route(a, b) == "wgmma"
    reset_launches()
    got = matmul(a, b, out_dtype=out_dtype)
    assert matmul.routes == {"wgmma": 1, "simt": 0}
    want = matmul_ref(a, b, out_dtype=out_dtype)
    _close_rel(got, want, 2 ** -16 if out_dtype == torch.float32
               else 2 ** -7)


def test_matmul_routes_by_layout(dev):
    """f32 operands and bf16 views TMA cannot read take the SIMT kernel; a
    view of wider, aligned rows still takes wgmma."""
    a = _rnd(dev, 96, 136).to(torch.bfloat16)
    b = _rnd(dev, 136, 80, seed=1).to(torch.bfloat16)
    cases = [(a.float(), b.float(), "simt"),
             (a[:, :130].contiguous(), b[:130], "simt"),  # rows of 130
             (a[:, 1:129], b[:128], "simt"),          # base 2 bytes off
             (a[:, :128], b[:128], "wgmma")]
    for x, y, want in cases:
        reset_launches()
        got = matmul(x, y, out_dtype=torch.float32)
        assert matmul.routes[want] == 1 == matmul.launches, want
        torch.testing.assert_close(
            got, matmul_ref(x, y, out_dtype=torch.float32), **TOL)


@pytest.mark.parametrize("R,V,vocab,d", [(67, 200, 190, 96), (5, 96, 70, 48),
                                         (130, 1104, 1000, 64),
                                         (300, 520, 520, 256)])
@pytest.mark.parametrize("tied", [True, False])
def test_lm_head_bwd_tensor_core_route(dev, R, V, vocab, d, tied):
    """bf16 x and w take the tensor-core backward (dl as hi/lo bf16
    planes): dx and dw within 1e-3 of the largest magnitude of the f32-dl
    plain version (as at full width), dw in w's own layout, zero on the
    padded columns."""
    bf = torch.bfloat16
    x = _rnd(dev, R, d).to(bf)
    w = (_rnd(dev, V, d, seed=1).T if tied else _rnd(dev, d, V, seed=1)).to(bf)
    lab = torch.randint(0, vocab, (R, 1), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(R)).to(dev)
    lse, _ = lm_head_ce.raw(x, w, lab, vocab=vocab)
    g = _rnd(dev, R, 1, seed=2)
    assert bwd_route(x, w) == "wgmma"
    reset_launches()
    dx, dw = lm_head_bwd(x, w, lab, lse, g, vocab=vocab)
    assert lm_head_bwd.routes == {"wgmma": 1, "simt": 0}
    rdx, rdw = lm_head_bwd_ref(x, w, lab, lse, g, vocab=vocab)
    _close_rel(dx, rdx, 1e-3)
    _close_rel(dw, rdw, 1e-3)
    assert dw.stride() == ((1, d) if tied else (V, 1))
    assert (dw[:, vocab:] == 0).all()
    # f32 and unaligned bf16 keep the CUDA-core backward
    for xx, ww in ((x.float(), w.float()),
                   (x[:, :d - 2].contiguous(), w[:d - 2])):  # rows of d - 2
        reset_launches()
        lm_head_bwd(xx, ww, lab, lse, g, vocab=vocab)
        assert lm_head_bwd.routes == {"wgmma": 0, "simt": 1}


# ---------------------------------------------------------------------------
# the tensor-core routes of flash_fwd and the ring step backward; the bf16
# ring gradient at head dim 128
# ---------------------------------------------------------------------------

FLASH_TC_CASES = [  # sq, skv, h, hk, d, causal, window
    (5, 5, 4, 4, 32, True, None), (70, 200, 8, 2, 64, True, None),
    (130, 130, 4, 1, 64, True, 40), (200, 333, 8, 2, 128, True, 50),
    (129, 129, 4, 4, 128, False, None), (1, 77, 8, 2, 64, True, None),
    (300, 300, 8, 2, 32, False, 64), (64, 64, 4, 1, 64, True, 1),
]


def _view(dev, b, s, heads, d, seed):
    """bf16 (b, heads, s, d) as the attention layer's projections give it:
    the (b, s, heads, d) -> (b, heads, s, d) view."""
    return _rnd(dev, b, s, heads, d, seed=seed).to(torch.bfloat16) \
        .transpose(1, 2)


def _layout(t, layout):
    return t.contiguous() if layout == "contiguous" else t


def _close_rows(got, ref, rel):
    """Each element within rel times the largest |ref| of its row."""
    err = (got.float() - ref.float()).abs()
    scale = ref.float().abs().amax(-1, keepdim=True)
    assert (err <= rel * scale).all(), float((err / scale).max())


@pytest.mark.parametrize("layout", ["views", "contiguous"])
@pytest.mark.parametrize("case", FLASH_TC_CASES)
def test_flash_fwd_tensor_core_route(dev, case, layout):
    """bf16 q (the projection's strided view), k and v (views as the
    projections give them, or contiguous) take the wgmma kernel: ragged
    Sq != Skv, windows, d 32/64/128, GQA groups 1 and 4. o within 2e-2
    (absolute + relative: the plain version rounds the normalised p to
    bf16, the kernel the unnormalised one) and within 2^-6 of its row's
    largest |o|, lse within 1e-3 / 1e-4: the full-width limits."""
    sq, skv, h, hk, d, causal, window = case
    q = _view(dev, 2, sq, h, d, 0)
    k = _layout(_view(dev, 2, skv, hk, d, 1), layout)
    v = _layout(_view(dev, 2, skv, hk, d, 2), layout)
    reset_launches()
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert flash_attention_fwd.routes == {"wgmma": 1, "simt": 0}
    ro, rlse = flash_fwd_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=2e-2)
    _close_rows(o, ro, 2 ** -6)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)


def test_flash_fwd_routes_by_dtype_and_layout(dev):
    """f32 inputs and bf16 rows the 16-byte copies cannot read keep the
    CUDA-core kernel; both routes agree with the plain version."""
    bf = torch.bfloat16
    q = _rnd(dev, 1, 4, 40, 64).to(bf)
    k = _rnd(dev, 1, 2, 40, 64, seed=1).to(bf)
    kw = _rnd(dev, 1, 2, 40, 72, seed=1).to(bf)[..., 4:68]   # rows 8 B in
    for qq, kk, want in ((q, k, "wgmma"), (q.float(), k.float(), "simt"),
                         (q, kw, "simt")):
        reset_launches()
        o, lse = flash_attention_fwd(qq, kk, kk)
        assert flash_attention_fwd.routes[want] == 1 == \
            flash_attention_fwd.launches, want
        ro, rlse = flash_fwd_ref(qq, kk, kk)
        torch.testing.assert_close(o.float(), ro.float(), atol=2e-2,
                                   rtol=2e-2)
        torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)


RING_TC_CASES = [  # sq, skv, h, hk, d, q_start, k_start, masks
    (70, 45, 4, 1, 32, 30, 50, {}),                  # across the diagonal
    (33, 40, 4, 4, 64, 100, 0, {}),                  # wholly before
    (33, 40, 8, 2, 64, 0, 64, {}),                   # wholly after: dead
    (197, 160, 8, 2, 64, 64, 96, {}),                # ragged, dead rows
    (130, 200, 4, 1, 64, 60, 20, dict(window=30)),
    (150, 145, 8, 2, 32, 10, 30, dict(prefix_len=35)),
    (70, 45, 4, 4, 64, 0, 0, dict(causal=False)),
    (130, 300, 8, 2, 128, 30, 50, dict(window=40)),  # d = 128
    (256, 256, 8, 2, 128, 0, 0, {}),
]


@pytest.mark.parametrize("layout", ["views", "contiguous"])
@pytest.mark.parametrize("case", RING_TC_CASES)
def test_ring_flash_bwd_tensor_core_route(dev, case, layout):
    """bf16 takes the wgmma backward at head dims 32, 64 and 128, with k, v
    and do as the projections' views or contiguous: dq within 2^-7 of its
    largest magnitude (rounded to bf16), dk/dv within 1e-3 (f32, p and ds
    as hi/lo bf16 planes), rows with lse = -inf give nothing."""
    sq, skv, h, hk, d, qs, ks, kw = case
    q = _view(dev, 2, sq, h, d, 0)
    k = _layout(_view(dev, 2, skv, hk, d, 1), layout)
    v = _layout(_view(dev, 2, skv, hk, d, 2), layout)
    do = _layout(_view(dev, 2, sq, h, d, 3), layout)
    off = _offsets(dev, qs, ks)
    o, lse = ring_flash_fwd(q, k, v, *off, **kw)
    delta = flash_delta(do, o) - torch.where(torch.isneginf(lse), 0.0,
                                             _rnd(dev, 2, h, sq, seed=4))
    reset_launches()
    got = ring_flash_bwd(q, k, v, do, lse, delta, *off, **kw)
    assert ring_flash_bwd.routes == {"wgmma": 1, "simt": 0}
    want = ring_bwd_ref(q, k, v, do, lse, delta, *off, **kw)
    for a, b_, rel in zip(got, want, (2 ** -7, 1e-3, 1e-3)):
        assert torch.isfinite(a).all()
        _close_rel(a.float(), b_.float(), rel)
    dead = torch.isneginf(lse)
    assert (got[0][dead] == 0).all()
    if ks > qs + sq - 1 and kw.get("causal", True):
        assert all((a == 0).all() for a in got)


def test_ring_attention_bf16_d128_gradients_on_card(dev):
    """A bf16 d = 128 gradient of the local ring runs on the card (the
    tensor-core backward takes d = 128; f32 is refused up front, above): each
    step backward on the wgmma route, the step kernel against ring_bwd_ref
    under the limits above, and the ring's gradients against the CPU's plain
    versions on the same bf16 values in f32 within 2^-6 of the largest
    magnitude (each side rounds its bf16 gradients, the card's sums its two
    steps' partials in bf16, as phase 13 of chip_smoke.py holds the ring)."""
    bf = torch.bfloat16
    ins = [_rnd(dev, 1, h, 128, 128, seed=i).to(bf)
           for i, h in enumerate((4, 2, 2))]
    go = _rnd(dev, 1, 4, 128, 128, seed=5).to(bf)
    ts = [t.detach().requires_grad_() for t in ins]
    reset_launches()
    o = ring_flash_attention(*ts, ring_steps=2)
    got = torch.autograd.grad(o, ts, go)
    assert ring_flash_bwd.routes == {"wgmma": 2, "simt": 0}
    cpu = [t.detach().cpu().float().requires_grad_() for t in ins]
    o_cpu = ring_flash_attention(*cpu, ring_steps=2)
    want = torch.autograd.grad(o_cpu, cpu, go.cpu().float())
    for a, b_ in zip(got, want):
        _close_rel(a.float().cpu(), b_, 2 ** -6)

    q, k, v = ins
    off = _offsets(dev, 64, 0)
    o1, lse = ring_flash_fwd(q, k[:, :, :64], v[:, :, :64], *off)
    delta = flash_delta(go, o1)
    got = ring_flash_bwd(q, k[:, :, :64], v[:, :, :64], go, lse, delta, *off)
    want = ring_bwd_ref(q, k[:, :, :64], v[:, :, :64], go, lse, delta, *off)
    for a, b_, rel in zip(got, want, (2 ** -7, 1e-3, 1e-3)):
        _close_rel(a.float(), b_.float(), rel)


# ---------------------------------------------------------------------------
# the tensor-core routes of the CE forward and flash_bwd; bf16 gradients
# through a windowed and a d = 128 flash_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R", [1, 5, 70, 130])
@pytest.mark.parametrize("tied", [True, False])
def test_lm_head_ce_tensor_core_route(dev, R, tied):
    """bf16 x and w with TMA-readable rows take the tensor-core forward:
    ragged R against the 128-row tiles, V = 1104 in 256-column tiles of
    which the last two lie wholly past vocab = 600, a label in the last
    true column. lse and gold within 1e-3 absolute of the plain version
    (the full-width limit: both sum exact bf16 products in f32, in another
    order)."""
    bf = torch.bfloat16
    V, vocab, d = 1104, 600, 64
    x = _rnd(dev, R, d).to(bf)
    w = (_rnd(dev, V, d, seed=1).T if tied else _rnd(dev, d, V, seed=1)).to(bf)
    lab = torch.randint(0, vocab, (R, 1), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(R)).to(dev)
    lab[-1] = vocab - 1
    assert bwd_route(x, w) == "wgmma"
    reset_launches()
    lse, gold = lm_head_ce.raw(x, w, lab, vocab=vocab)
    assert lm_head_ce.routes == {"wgmma": 1, "simt": 0}
    rlse, rgold = lm_head_ce_stats_ref(x, w, lab, vocab=vocab)
    assert torch.isfinite(lse).all() and torch.isfinite(gold).all()
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)
    torch.testing.assert_close(gold, rgold, atol=1e-3, rtol=0)


def test_lm_head_ce_forward_routes_by_layout(dev):
    """f32 and bf16 rows TMA cannot read keep the CUDA-core forward; both
    routes agree with the plain version (f32 1e-4; bf16 1e-3 absolute)."""
    bf = torch.bfloat16
    x = _rnd(dev, 33, 96).to(bf)
    w = _rnd(dev, 300, 96, seed=1).to(bf).T
    lab = torch.randint(0, 290, (33, 1), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(3)).to(dev)
    for xx, ww, want, tol in (
            (x, w, "wgmma", dict(atol=1e-3, rtol=0)),
            (x.float(), w.float(), "simt", TOL),
            (x[:, :90].contiguous(), w[:90], "simt",   # rows of 180 bytes
             dict(atol=1e-3, rtol=0))):
        reset_launches()
        got = lm_head_ce.raw(xx, ww, lab, vocab=290)
        assert lm_head_ce.routes[want] == 1 == lm_head_ce.launches, want
        for a, b_ in zip(got, lm_head_ce_stats_ref(xx, ww, lab, vocab=290)):
            torch.testing.assert_close(a, b_, **tol)


FLASH_BWD_TC_CASES = FLASH_TC_CASES + [
    (90, 40, 8, 2, 64, True, None),    # rows 0-49 see no key
    (70, 33, 4, 1, 128, True, 16),     # and with a window at d = 128
]


@pytest.mark.parametrize("layout", ["views", "contiguous"])
@pytest.mark.parametrize("case", FLASH_BWD_TC_CASES)
def test_flash_bwd_tensor_core_route(dev, case, layout):
    """bf16 q (a view) with k, v and do as the projections' views or
    contiguous take the wgmma backward at head dims 32, 64 and 128, with
    windows, GQA groups 1 and 4 and Sq != Skv: dq within 2^-7 of its
    largest magnitude (rounded to bf16), dk and dv within 1e-3 (f32, p and
    ds as hi/lo bf16 planes), the full-width limits; a row that sees no key
    gives dq = 0. delta is rowsum(do o) plus noise, as the ring passes it
    (rowsum(do o) - g_lse) through the same kernels: with delta exactly
    rowsum(do o), window 1 (each query sees one key, p = 1) makes dq and dk
    zero in exact arithmetic, and a limit relative to their largest
    magnitude would measure only the two sides' f32 cancellation."""
    sq, skv, h, hk, d, causal, window = case
    q = _view(dev, 2, sq, h, d, 0)
    k = _layout(_view(dev, 2, skv, hk, d, 1), layout)
    v = _layout(_view(dev, 2, skv, hk, d, 2), layout)
    do = _layout(_view(dev, 2, sq, h, d, 3), layout)
    o, lse = flash_fwd_ref(q, k, v, causal=causal, window=window)
    delta = flash_delta(do, o) + _rnd(dev, 2, h, sq, seed=4)
    reset_launches()
    got = flash_bwd(q, k, v, do, lse, delta, causal=causal, window=window)
    assert flash_bwd.routes == {"wgmma": 1, "simt": 0}
    want = flash_bwd_ref(q, k, v, do, lse, delta, causal=causal,
                         window=window)
    for a, b_, rel in zip(got, want, (2 ** -7, 1e-3, 1e-3)):
        assert torch.isfinite(a).all()
        _close_rel(a.float(), b_.float(), rel)
    dead = torch.isneginf(lse)
    assert (got[0][dead] == 0).all()


@pytest.mark.parametrize("d,window", [(64, 40), (128, None), (128, 24)])
def test_flash_attention_bf16_window_and_d128_gradients(dev, d, window):
    """A bf16 gradient through a windowed or d = 128 ``flash_attention``
    runs on the card, the backward on the tensor-core route, and matches
    the plain backward on the same o and lse: each gradient within 2^-7 of
    its largest magnitude (both round dq, dk and dv to bf16 once; the
    kernel's dk/dv sit within 1e-3 of the f32 plain ones before that)."""
    q = _view(dev, 2, 200, 8, d, 0).detach().requires_grad_()
    k = _view(dev, 2, 200, 2, d, 1).detach().requires_grad_()
    v = _view(dev, 2, 200, 2, d, 2).detach().requires_grad_()
    go = _view(dev, 2, 200, 8, d, 3)
    reset_launches()
    o = flash_attention(q, k, v, causal=True, window=window)
    got = torch.autograd.grad(o, (q, k, v), go)
    assert flash_bwd.routes == {"wgmma": 1, "simt": 0}
    assert flash_attention_fwd.routes == {"wgmma": 1, "simt": 0}
    with torch.no_grad():
        o2, lse = flash_attention_fwd(q, k, v, causal=True, window=window)
        dq, dk, dv = flash_bwd_ref(q, k, v, go, lse, flash_delta_ref(go, o2),
                                   causal=True, window=window)
    for a, b_ in zip(got, (dq, dk.to(k.dtype), dv.to(v.dtype))):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all()
        _close_rel(a.float(), b_.float(), 2 ** -7)


# ---------------------------------------------------------------------------
# the tensor-core routes of the ring step forward and the decode LM head
# ---------------------------------------------------------------------------

RING_FWD_TC_CASES = [  # sq, skv, h, hk, d, q_start, k_start, masks
    (70, 45, 4, 1, 32, 30, 50, {}),                  # across the diagonal
    (33, 40, 4, 4, 64, 100, 0, {}),                  # wholly before
    (33, 40, 8, 2, 64, 0, 64, {}),                   # wholly after: dead
    (197, 160, 8, 2, 64, 64, 96, {}),                # ragged, dead rows
    (130, 300, 4, 1, 64, 60, 20, dict(window=30)),
    (150, 145, 8, 2, 32, 10, 30, dict(prefix_len=35)),
    (150, 400, 8, 2, 64, 200, 0, dict(window=40, prefix_len=70)),
    (70, 45, 4, 4, 64, 0, 0, dict(causal=False)),
    (130, 300, 8, 2, 128, 30, 50, dict(window=40)),  # d = 128
    (200, 333, 8, 2, 128, 0, 120, dict(prefix_len=140)),
]


@pytest.mark.parametrize("layout", ["views", "contiguous"])
@pytest.mark.parametrize("case", RING_FWD_TC_CASES)
def test_ring_flash_fwd_tensor_core_route(dev, case, layout):
    """bf16 q (the projection's view), k and v (views or contiguous) take the
    wgmma forward at head dims 32, 64 and 128, under the causal, window and
    prefix masks, at ragged shard and chunk lengths: o within 2e-2 (absolute
    + relative) and within 2^-6 of its row's largest |o| (the tensor-core
    kernel rounds p to bf16 before P V, the plain version keeps it f32: the
    limits chip_smoke.py holds flash_fwd_tc to), lse within 1e-3 / 1e-4,
    -inf on exactly the rows that see no key, where o = 0."""
    sq, skv, h, hk, d, qs, ks, kw = case
    q = _view(dev, 2, sq, h, d, 0)
    k = _layout(_view(dev, 2, skv, hk, d, 1), layout)
    v = _layout(_view(dev, 2, skv, hk, d, 2), layout)
    off = _offsets(dev, qs, ks)
    reset_launches()
    o, lse = ring_flash_fwd(q, k, v, *off, **kw)
    assert ring_flash_fwd.routes == {"wgmma": 1, "simt": 0}
    ro, rlse = ring_fwd_ref(q, k, v, *off, **kw)
    dead = torch.isneginf(rlse)
    assert torch.equal(torch.isneginf(lse), dead)
    assert (o[dead] == 0).all()
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=2e-2)
    live = ~dead
    if live.any():
        _close_rows(o[live], ro[live], 2 ** -6)
        torch.testing.assert_close(lse[live], rlse[live], atol=1e-3,
                                   rtol=1e-4)
    if ks > qs + sq - 1 and kw.get("causal", True) and not kw.get(
            "prefix_len"):
        assert dead.all()


@pytest.mark.parametrize("case", FLASH_TC_CASES)
def test_flash_fwd_is_the_ring_forward_at_flash_offsets(dev, case):
    """flash_attention_fwd's tensor-core kernel is the ring forward's, at
    q_start = Skv - Sq and k_start = 0 with no prefix: the two wrappers give
    the same o and lse, bit for bit."""
    sq, skv, h, hk, d, causal, window = case
    q = _view(dev, 2, sq, h, d, 0)
    k, v = _view(dev, 2, skv, hk, d, 1), _view(dev, 2, skv, hk, d, 2)
    reset_launches()
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
    o2, lse2 = ring_flash_fwd(q, k, v, *_offsets(dev, skv - sq, 0),
                              causal=causal, window=window)
    assert flash_attention_fwd.routes["wgmma"] == 1
    assert ring_flash_fwd.routes["wgmma"] == 1
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_ring_flash_fwd_routes_by_dtype_and_layout(dev):
    """f32 inputs and bf16 rows the 16-byte copies cannot read keep the
    CUDA-core forward; both routes agree with the plain version."""
    bf = torch.bfloat16
    q = _rnd(dev, 1, 4, 40, 64).to(bf)
    k = _rnd(dev, 1, 2, 40, 64, seed=1).to(bf)
    off = _offsets(dev, 20, 0)
    for qq, kk, want in ((q, k, "wgmma"), (q.float(), k.float(), "simt"),
                         (_misaligned(q), k, "simt")):
        reset_launches()
        o, lse = ring_flash_fwd(qq, kk, kk, *off)
        assert ring_flash_fwd.routes[want] == 1 == ring_flash_fwd.launches
        ro, rlse = ring_fwd_ref(qq, kk, kk, *off)
        torch.testing.assert_close(o.float(), ro.float(), atol=2e-2,
                                   rtol=2e-2)
        torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)


def _check_argmax(arg, logits_ref, vocab, gap_tol):
    """chip_smoke.check_argmax's rule: the kernel's argmax equals the plain
    one wherever the plain top-2 gap exceeds gap_tol."""
    live = logits_ref[:, :vocab].float()
    top2 = torch.topk(live, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > gap_tol
    wrong = decided & (arg.reshape(-1).long() != live.argmax(-1))
    assert not wrong.any(), int(wrong.sum())


@pytest.mark.parametrize("R", [1, 8, 16, 20, 70])
@pytest.mark.parametrize("tied", [True, False])
def test_lm_head_tensor_core_route(dev, R, tied):
    """bf16 x and a head TMA can read (the tied embed.T view, read in place,
    or a contiguous (d, V) head) take the wgmma route at decode row counts
    1 through 20 and beyond (tiles of 8, 16, 64 and 256 rows), V = 1104
    padded past vocab = 1000: logits and row max within 1e-3 (bf16 products
    are exact in f32; the two sides sum d = 256 of them in other orders, the
    tensor cores truncating each k16 step), -1e30 past vocab, argmax equal
    wherever the plain top-2 gap exceeds 2e-3 (chip_smoke.check_argmax's
    rule); three equal best columns in different 128-row tiles give the
    first."""
    bf = torch.bfloat16
    V, vocab, d = 1104, 1000, 256
    x = _rnd(dev, R, d).to(bf)
    emb = _rnd(dev, V, d, seed=1)
    emb[:, :] *= 0.5
    emb[260] = emb[517] = emb[900] = 1.0          # ties across tiles
    xt = x.clone()
    xt[: R // 2] = x[: R // 2].abs()              # rows where the ties win
    emb = emb.to(bf)
    w = emb.T if tied else emb.T.contiguous()
    reset_launches()
    lg, m, arg = lm_head_logits.raw(xt, w, vocab=vocab)
    assert lm_head_logits.routes == {"wgmma": 1, "simt": 0}
    rlg, rm, rarg = lm_head_logits_ref(xt, w, vocab=vocab)
    torch.testing.assert_close(lg, rlg, atol=1e-3, rtol=0)
    torch.testing.assert_close(m, rm, atol=1e-3, rtol=0)
    assert (lg[:, vocab:] <= -1e29).all()
    _check_argmax(arg, rlg, vocab, gap_tol=2e-3)
    assert (arg[: R // 2] == 260).all()


def test_lm_head_routes_by_dtype_and_layout(dev):
    """f32 inputs and bf16 rows TMA cannot read keep the CUDA-core decode
    head; both routes agree with the plain version."""
    bf = torch.bfloat16
    x = _rnd(dev, 8, 128).to(bf)
    emb = _rnd(dev, 300, 128, seed=1).to(bf)
    for xx, w, want in ((x, emb.T, "wgmma"), (x.float(), emb.float().T,
                                              "simt"),
                        (_misaligned(x), emb.T, "simt")):
        reset_launches()
        lg, m, arg = lm_head_logits.raw(xx, w, vocab=290)
        assert lm_head_logits.routes[want] == 1 == lm_head_logits.launches
        rlg, rm, _ = lm_head_logits_ref(xx, w, vocab=290)
        torch.testing.assert_close(lg, rlg, atol=1e-3, rtol=0)
        torch.testing.assert_close(m, rm, atol=1e-3, rtol=0)
        _check_argmax(arg, rlg, 290, gap_tol=2e-3)


# ---------------------------------------------------------------------------
# rmsnorm (csrc/rmsnorm.cu) and split-KV paged decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [47, 48, 1000, 1536, 2048, 3584, 4096, 6144])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_routes(dev, d, xdt, wdt):
    """Every width of configs/ and the tests' small and odd ones, each dtype
    pair, on a contiguous x and on row-strided views (a stride of d + 8
    keeps 16-byte rows, d + 1 does not): the route is the layout's (16-byte
    vectors of x in d and the stride, at most 32 vectors a lane), counted
    once a call, and o matches the plain version (f32 out: TOL; bf16 out:
    both sides round one f32 result, one ulp, rtol 2^-7)."""
    rows = 70
    w = (1 + 0.1 * _rnd(dev, d, seed=1)).to(wdt)
    tol = TOL if xdt == torch.float32 else dict(atol=1e-6, rtol=2 ** -7)
    n = 16 // torch.tensor([], dtype=xdt).element_size()
    for pad in (0, 8, 1):
        x = (_rnd(dev, rows, d + pad, seed=d + pad) * 3).to(xdt)[:, :d]
        want = ("vec" if d % n == 0 and (d + pad) % n == 0
                and -(-d // (32 * n)) <= 32 else "elem")
        assert rms_route(x, w) == want
        reset_launches()
        got = rmsnorm(x, w, eps=1e-5)
        assert rmsnorm.routes[want] == 1 == rmsnorm.launches
        torch.testing.assert_close(got, rmsnorm_ref(x, w, eps=1e-5), **tol)
        x3 = x.reshape(7, 10, d)                 # (..., d): one launch
        torch.testing.assert_close(rmsnorm(x3, w, eps=1e-5),
                                   rmsnorm_ref(x3, w, eps=1e-5), **tol)


def _paged_inputs(dev, lens, page, nsp, hk, g, d, dtype, seed):
    """Pools with each sequence of ``lens`` on shuffled pages; a length of 0
    is an idle slot (table of zeros, the null page at -1); a length past
    nsp * page is a wrapped cache (slot l holds the newest position equal
    to l mod nsp * page)."""
    b, cap = len(lens), nsp * page
    npages = b * nsp + 1
    gen = torch.Generator().manual_seed(seed)
    table = (torch.randperm(npages - 1, generator=gen) + 1)[:b * nsp]
    table = table.reshape(b, nsp).to(torch.int32)
    pos = torch.full((npages, page), -1, dtype=torch.int32)
    for bi, n in enumerate(lens):
        if n == 0:
            table[bi] = 0
            continue
        for j in range(nsp):
            ar = torch.arange(j * page, (j + 1) * page)
            p = ar + torch.clamp((n - 1 - ar) // cap, min=0) * cap
            pos[table[bi, j]] = torch.where(p < n, p, -1).to(torch.int32)
    q = _rnd(dev, b, hk * g, 1, d, seed=seed).to(dtype)
    kp = _rnd(dev, npages, hk, page, d, seed=seed + 1).to(dtype)
    vp = _rnd(dev, npages, hk, page, d, seed=seed + 2).to(dtype)
    kw = dict(block_table=table.to(dev),
              kv_len=torch.tensor(lens, dtype=torch.int32, device=dev),
              pos_pages=pos.to(dev))
    return q, kp, vp, kw


PAGED_CASES = [  # lens, page, nsp, hk, g, d
    ([64, 1, 0, 37], 4, 16, 2, 1, 32),
    ([80, 7, 0, 33], 5, 16, 2, 4, 64),
    ([1408, 353, 0, 40], 352, 4, 2, 8, 128),
    ([2048, 600, 0, 1], 512, 4, 1, 16, 64),
    ([23, 57, 0, 20], 5, 4, 2, 4, 32),               # wrapped caches
    ([1016, 241, 700, 0, 33, 512, 999, 64], 16, 128, 8, 4, 64),
    ([130, 9], 16, 16, 2, 1, 128),
]


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_split_kernel(dev, case, dtype):
    """Ragged lengths whose later splits are wholly masked, idle slots
    (exactly 0), wrapped caches, pages of 4, 5, 16, 352 and 512, d 32, 64
    and 128, groups 1 to 16, splits of 32 slots (b * hk small) and of 64
    (8 x 8): against paged_decode_ref (f32: TOL; bf16: 2e-2, the plain
    version rounds p to bf16 before p @ v), one launch counted a call."""
    lens, page, nsp, hk, g, d = case
    q, kp, vp, kw = _paged_inputs(dev, lens, page, nsp, hk, g, d, dtype,
                                  seed=sum(lens) % 97)
    reset_launches()
    o = paged_decode_attention(q, kp, vp, **kw)
    assert paged_decode_attention.launches == 1
    tol = TOL if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(o, paged_decode_ref(q, kp, vp, **kw), **tol)
    for bi, n in enumerate(lens):
        if n == 0:
            assert (o[bi] == 0).all()


def test_paged_decode_takes_unaligned_pools(dev):
    """Contiguous pools whose base lies 2 bytes off 16 (the kernel's plain
    loads in place of cp.async) and a strided q give the same bits."""
    bf = torch.bfloat16
    q, kp, vp, kw = _paged_inputs(dev, [80, 7, 0, 33], 5, 16, 2, 4, 64, bf,
                                  seed=3)
    ko, vo = (_misaligned(t) for t in (kp, vp))
    assert ko.is_contiguous() and ko.data_ptr() % 16
    qs = _misaligned(q.transpose(1, 2).contiguous()).transpose(1, 2)
    want = paged_decode_attention(q, kp, vp, **kw)
    assert torch.equal(paged_decode_attention(qs, ko, vo, **kw), want)


# ---------------------------------------------------------------------------
# the split-KV flash_decode and the time-parallel ssm_scan
# ---------------------------------------------------------------------------

DECODE_SPLIT_CASES = [  # b, hk, g, d, skv, kv_len, window, rotated after t
    (3, 1, 8, 256, 200, 150, None, None),
    (2, 2, 8, 256, 96, 500, 96, 500),
    (3, 2, 4, 112, 200, 130, None, None),
    (2, 4, 1, 112, 64, 100, 40, 100),
    (2, 2, 4, 64, 1000, 40, None, None),
    (2, 2, 4, 64, 1000, 900, 50, None),
    (1, 3, 16, 128, 300, 300, None, None),
]


@pytest.mark.parametrize("split", [None, 32, 64, 512])
@pytest.mark.parametrize("case", DECODE_SPLIT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_split_kernel(dev, monkeypatch, case, split, dtype):
    """d 256 (g 8, and g * d = 2048) and 112, ranges wholly past q_pos or
    below the window, wrapped rotated caches, each split length forced (None:
    the rule's), against decode_ref; kv_len as a device tensor gives the
    int's bits; one launch counted a call."""
    from repro_torch.kernels.flash_attention import ops

    if split is not None:
        monkeypatch.setattr(ops, "decode_split",
                            lambda b, hk, skv: (split, -(-skv // split)))
    b, hk, g, d, skv, kv_len, window, t = case
    q = _rnd(dev, b, 1, hk * g, d).transpose(1, 2).to(dtype)
    k = _rnd(dev, b, hk, skv, d, seed=1).to(dtype)
    v = _rnd(dev, b, hk, skv, d, seed=2).to(dtype)
    sp = None if t is None else rolling_slot_pos(skv, t).to(dev)
    kw = dict(window=window, slot_pos=sp)
    ref = decode_ref(q, k, v, kv_len=kv_len, **kw)
    reset_launches()
    o = flash_decode(q, k, v, kv_len=kv_len, **kw)
    assert flash_decode.launches == 1
    torch.testing.assert_close(o, ref, **_tol(dtype, ref))
    kl = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    assert torch.equal(flash_decode(q, k, v, kv_len=kl, **kw), o)


def test_flash_decode_masked_slots_and_empty_rows(dev):
    """NaN in masked k and v slots changes no bit; a row with no live slot
    (kv_len 0 as a tensor, or every slot empty) gives exactly 0."""
    bf = torch.bfloat16
    q = _rnd(dev, 2, 4, 1, 64).to(bf)
    k, v = _rnd(dev, 2, 2, 64, 64, seed=1).to(bf), _rnd(dev, 2, 2, 64, 64,
                                                          seed=2).to(bf)
    for sp in (None, rolling_slot_pos(64, 40).to(dev)):
        want = flash_decode(q, k, v, kv_len=40, slot_pos=sp, window=64)
        kn, vn = k.clone(), v.clone()
        kn[:, :, [45, 63]] = float("nan")
        vn[:, :, [45, 63]] = float("nan")
        assert torch.equal(flash_decode(q, kn, vn, kv_len=40, slot_pos=sp,
                                        window=64), want)
    k = _rnd(dev, 2, 2, 70, 256)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    assert (flash_decode(_rnd(dev, 2, 16, 1, 256), k, k, kv_len=zero)
            == 0).all()
    empty = torch.full((70,), -1, dtype=torch.int32, device=dev)
    assert (flash_decode(_rnd(dev, 2, 16, 1, 256), k, k, kv_len=30,
                         slot_pos=empty) == 0).all()


@pytest.mark.parametrize("bt,L,dm", [(1, 2048, 8192), (4, 512, 8192)])
def test_ssm_scan_kernel_at_falcon_shapes(dev, bt, L, dm):
    """falcon_mamba_7b's forward (1 x 2048) and prefill (4 x 512) at its
    d_inner 8192 and state 16: bf16 x, B, C, f32 delta, against the plain
    version (y one bf16 rounding, 1e-2 and 2^-7; hT 1e-3 of its largest
    magnitude)."""
    bf = torch.bfloat16
    x = _rnd(dev, bt, L, dm).to(bf)
    delta = torch.nn.functional.softplus(_rnd(dev, bt, L, dm, seed=1) - 4)
    A = -torch.arange(1, 17, dtype=torch.float32, device=dev).expand(
        dm, 16).contiguous()
    B = _rnd(dev, bt, L, 16, seed=2).to(bf)
    C = _rnd(dev, bt, L, 16, seed=3).to(bf)
    D = torch.ones(dm, device=dev)
    y, hT = ssm_scan_fwd(x, delta, A, B, C, D)
    ry, rhT = selective_scan_ref(x, delta, A, B, C, D)
    torch.testing.assert_close(y, ry, atol=1e-2, rtol=2 ** -7)
    scale = float(rhT.abs().max())
    torch.testing.assert_close(hT, rhT, atol=1e-3 * scale, rtol=1e-3)


@pytest.mark.parametrize("bt,L,dm,n", [(2, 129, 17, 4), (1, 300, 40, 8),
                                       (1, 128, 32, 16), (2, 1, 5, 16),
                                       (1, 1000, 33, 16)])
def test_ssm_scan_kernel_off_its_tile(dev, bt, L, dm, n):
    """L and dm off the kernel's 128-step, 32-channel tile, n 4/8/16, with
    and without h0, in f32 (TOL)."""
    x = _rnd(dev, bt, L, dm)
    delta = torch.nn.functional.softplus(_rnd(dev, bt, L, dm, seed=1)) * 0.1
    A = -(_rnd(dev, dm, n, seed=2).abs() + 0.1)
    B, C = _rnd(dev, bt, L, n, seed=3), _rnd(dev, bt, L, n, seed=4)
    D, h0 = _rnd(dev, dm, seed=5), _rnd(dev, bt, dm, n, seed=6)
    for h in (h0, None):
        y, hT = ssm_scan_fwd(x, delta, A, B, C, D, h0=h)
        ry, rhT = selective_scan_ref(x, delta, A, B, C, D, h0=h)
        torch.testing.assert_close(y, ry, **TOL)
        torch.testing.assert_close(hT, rhT, **TOL)
