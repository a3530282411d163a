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
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import generate
from repro_torch.models import LM, tree_to
from repro_torch.optim import AdamW, WarmupCosine
from repro_torch.parallel import (GraphStep, TrainGraphStep, build_serve_step,
                                  build_train_step)
from repro_torch.parallel.steps import train_step
from repro_torch.serving import Engine
from repro_torch.tree import leaves, tree_map

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


def test_f32_windowed_and_d128_gradients_take_the_cuda_core_backward(dev):
    """f32 inputs take flash_bwd.cu's CUDA-core backward, which has the
    window mask and every head dim the forward takes: a gradient through a
    windowed or d = 128 f32 ``flash_attention`` runs on the card and
    matches autograd through the plain version (1e-4)."""
    for window, d in ((4, 32), (None, 128), (7, 128)):
        q = _rnd(dev, 1, 4, 9, d).requires_grad_()
        k = _rnd(dev, 1, 2, 9, d, seed=1).requires_grad_()
        go = _rnd(dev, 1, 4, 9, d, seed=2)
        reset_launches()
        o = flash_attention(q, k, k, window=window)
        got = torch.autograd.grad(o, (q, k), go)
        assert flash_bwd.routes == {"wgmma": 0, "simt": 1}
        want = torch.autograd.grad(mha_ref(q, k, k, window=window), (q, k),
                                   go)
        torch.testing.assert_close(o, mha_ref(q, k, k, window=window)
                                   .detach(), **TOL)
        for a, b_ in zip(got, want):
            torch.testing.assert_close(a, b_, **TOL)


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
    (130, 150, 4, 1, 112, 30, 50, dict(window=40)),  # ring_flash_wide.cu
    (150, 145, 4, 1, 256, 10, 30, dict(prefix_len=35)),
    (96, 128, 2, 2, 256, 0, 0, {}),
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
    (130, 150, 4, 1, 112, 30, 50, dict(window=40)),  # ring_flash_wide.cu
    (200, 333, 8, 1, 256, 0, 120, dict(prefix_len=140)),
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


# ---------------------------------------------------------------------------
# the row-streaming fd2d and the folded dg_volume: routes and instances
# ---------------------------------------------------------------------------

def _off(t, lead=1):
    """A contiguous copy of t starting ``lead`` floats past t's alignment."""
    buf = torch.empty(t.numel() + lead, dtype=t.dtype, device=t.device)
    out = buf[lead:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("r", range(1, 9))
def test_fd2d_routes_at_every_radius(dev, r):
    """At each r the windows of the edge tiles wrap on every side (and the
    (2r + 1)-row and 5-row fields are narrower than the stencil): the "vec"
    route where w and bw are multiples of 4, the "scalar" one for w % 4 !=
    0, a tile width of 18 and bases one to three floats off alignment;
    every output within 2e-5 of fd2d_ref, bit-equal to fd2d_stream_ref,
    and the two routes bit-equal on the same values; each launch's route
    counted."""
    from repro_torch.kernels.apps import fd2d_stream_ref

    wts = tuple(float(x) for x in fd_second_derivative_weights(r))
    reset_launches()
    want = {"vec": 0, "scalar": 0}
    for i, (h, w, block) in enumerate(((40 + r, 64, (16, 32)),
                                       (21 + r, 61 + 2 * r, (8, 20)),
                                       (2 * r + 1, 12, (0, 0)),
                                       (5, 44, (4, 0)),
                                       (30, 72, (7, 18)),
                                       (64, 1100, (16, 0)))):
        u1, u2 = _rnd(dev, h, w, seed=i), _rnd(dev, h, w, seed=i + 10)
        dx = 2.0 / w
        dt = 0.3 * dx / 2 ** 0.5
        bw = min(block[1] or w, w)
        route = "vec" if w % 4 == 0 and bw % 4 == 0 else "scalar"
        got = fd2d(u1, u2, weights=wts, dx=dx, dt=dt, block=block)
        want[route] += 1
        torch.testing.assert_close(got, fd2d_ref(u1, u2, wts, dx, dt),
                                   atol=2e-5, rtol=2e-5)
        assert torch.equal(got, fd2d_stream_ref(u1, u2, wts, dx, dt))
        for lead, which in ((1, 0), (2, 1), (3, 2)):
            ins = [u1, u2, torch.empty_like(u1)]
            ins[which] = _off(ins[which], lead)
            other = fd2d(ins[0], ins[1], weights=wts, dx=dx, dt=dt,
                         block=block, out=ins[2])
            want["scalar"] += 1
            assert torch.equal(other, got)
    assert dict(fd2d.routes) == want and fd2d.launches == sum(want.values())


@pytest.mark.parametrize("n", range(1, 9))
def test_dg_volume_instances(dev, n):
    """N = 1..7 on their templated instances, N = 8 (np 45) on the generic
    one, at E not a multiple of eb, eb = 1 and eb past one chunk of 128
    elements (at N = 7 and 8 a smaller chunk still, to fit shared memory),
    q and out's runs off 16-byte alignment: within APP_REL of volume_ref (as test_dg_kernels) and 2e-5
    of volume_folded_ref; each launch's instance counted."""
    from repro_torch.kernels.apps import volume_folded_ref

    np_ = (n + 1) * (n + 2) // 2
    reset_launches()
    calls = 0
    for E, eb in ((37, 8), (13, 1), (300, 200), (5, 64)):
        q = 0.1 * _rnd(dev, E, np_, 3)
        q[..., 0] += 1.5
        args = (q, _rnd(dev, E, 4, seed=1), _rnd(dev, E, np_, 2, seed=2),
                _rnd(dev, np_, np_, seed=3), _rnd(dev, np_, np_, seed=4))
        ref = volume_ref(*args)
        for qq in (q, _off(q, 1), _off(q, 3)):
            got = dg_volume(qq, *args[1:], eb=eb)
            calls += 1
            _close_rel(got, ref, APP_REL)
            _close_rel(got, volume_folded_ref(*args), 2e-5)
    route = "templated" if n <= 7 else "generic"
    assert dict(dg_volume.routes) == {"templated": 0, "generic": 0,
                                      route: calls}
    assert dg_volume.launches == calls


@pytest.mark.parametrize("nq", [2, 5, 8, 9, 10, 11, 24])
def test_sem_apply_routes(dev, nq):
    """nq 2, 5, 8, 9, 10 on their templated instances (9 and 10 one
    element a block; 4-byte copies at odd nq), 11 and 24 on the generic
    kernel, at E not a multiple of eb, eb = 1 and eb past one round of
    elements side by side: within APP_REL of apply_ref; each launch's route
    counted."""
    from repro_torch.kernels.apps import sem_route

    reset_launches()
    cases = ((37, 8), (13, 1), (5, 64)) if nq <= 11 else ((3, 2), (2, 1))
    for i, (E, eb) in enumerate(cases):
        u = _rnd(dev, E, nq, nq, nq, seed=i)
        geo = _rnd(dev, E, 7, nq, nq, nq, seed=i + 1)
        dmat = _rnd(dev, nq, nq, seed=i + 2)
        _close_rel(sem_apply(u, geo, dmat, eb=eb), apply_ref(u, geo, dmat),
                   APP_REL)
    route = sem_route(nq)
    assert route == ("templated" if nq <= 10 else "generic")
    assert dict(sem_apply.routes) == {"templated": 0, "generic": 0,
                                      route: len(cases)}
    assert sem_apply.launches == len(cases)


@pytest.mark.parametrize("d", [32, 64, 112, 128, 256])
def test_flash_delta_routes(dev, d):
    """Both routes of flash_delta at Sq = 37 (not a multiple of a block's
    rows), bf16 and f32, do contiguous and as a transposed view (the train
    step's), all-zero rows, and a copy one element off alignment (the
    "scalar" route): within TOL of flash_delta_ref; routes counted."""
    reset_launches()
    want = {"vec": 0, "scalar": 0}
    b, h, sq = 2, 3, 37
    for dtype in (torch.bfloat16, torch.float32):
        o = _rnd(dev, b, h, sq, d, seed=1).to(dtype)
        o[1, 2, 5:9] = 0
        for do in (_rnd(dev, b, h, sq, d, seed=2).to(dtype),
                   _rnd(dev, b, sq, h, d, seed=3).to(dtype).transpose(1, 2)):
            for dd, route in ((do, "vec"), (_misaligned(do), "scalar")):
                assert flash_delta.route(dd, o) == route
                got = flash_delta(dd, o)
                want[route] += 1
                torch.testing.assert_close(got, flash_delta_ref(dd, o), **TOL)
                assert (got[1, 2, 5:9] == 0).all()
    assert dict(flash_delta.routes) == want
    assert flash_delta.launches == sum(want.values())


# ---------------------------------------------------------------------------
# flash_fwd at MLA's head dims (d_qk 192, d_v 128) on both routes, and its
# gradient
# ---------------------------------------------------------------------------

def _mla_qkv(dev, b, s, h, dtype, seed):
    """q, k (b, h, s, 192) and v (b, h, s, 128) as MLA's prefill gives
    them: q and k concatenated (nope 128 + rope 64), v the strided view of
    the latent's expansion (b, s, h, 128 + 128)[..., 128:]."""
    q = _rnd(dev, b, h, s, 192, seed=seed).to(dtype)
    k = _rnd(dev, b, h, s, 192, seed=seed + 1).to(dtype)
    kv = _rnd(dev, b, s, h, 256, seed=seed + 2).to(dtype).transpose(1, 2)
    return q, k, kv[..., 128:]


@pytest.mark.parametrize("sq,skv,causal", [(5, 5, True), (70, 70, True),
                                           (130, 200, True), (64, 64, False),
                                           (1, 77, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_mla_head_dims(dev, sq, skv, causal, dtype):
    """d_qk 192 / d_v 128 on the CUDA-core kernel (f32) and the tensor-core
    one (bf16, v the projection's strided view), ragged Sq != Skv and Sq
    off the 64-row tile: f32 within 1e-4; bf16 o within 2e-2 and 2^-6 of
    its row's largest |o|, lse within 1e-3 / 1e-4."""
    q, k, v = _mla_qkv(dev, 2, skv, 4, dtype, 3)
    q = q[:, :, skv - sq:]
    reset_launches()
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    want = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert flash_attention_fwd.routes[want] == 1 == flash_attention_fwd.launches
    assert o.shape == (2, 4, sq, 128)
    ro, rlse = flash_fwd_ref(q, k, v, causal=causal)
    if dtype == torch.float32:
        torch.testing.assert_close(o, ro, **TOL)
        torch.testing.assert_close(lse, rlse, **TOL)
    else:
        torch.testing.assert_close(o.float(), ro.float(), atol=2e-2,
                                   rtol=2e-2)
        _close_rows(o, ro, 2 ** -6)
        torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)


def _grads_against_plain(q, k, v, go, dtype, **kw):
    """The q, k, v gradients of <flash_attention(q, k, v), go> on the card
    against the plain backward on the kernel forward's o and lse: f32
    within 1e-4, bf16 (the tensor-core route) each within 2^-7 of its
    largest magnitude (both round dq, dk and dv to bf16 once)."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    reset_launches()
    o = flash_attention(q, k, v, **kw)
    got = torch.autograd.grad(o, (q, k, v), go)
    want_route = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert flash_bwd.routes[want_route] == 1 == flash_bwd.launches
    assert flash_attention_fwd.routes[want_route] == 1
    with torch.no_grad():
        o2, lse = flash_attention_fwd(q, k, v, **kw)
        dq, dk, dv = flash_bwd_ref(q, k, v, go, lse, flash_delta_ref(go, o2),
                                   **kw)
    for a, b_ in zip(got, (dq, dk.to(k.dtype), dv.to(v.dtype))):
        assert a.dtype == dtype and torch.isfinite(a).all()
        if dtype == torch.float32:
            torch.testing.assert_close(a, b_, **TOL)
        else:
            _close_rel(a.float(), b_.float(), 2 ** -7)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_mla_gradient_on_card(dev, dtype):
    """d_qk 192 / d_v 128 (MLA's prefill, v the latent expansion's strided
    view): the gradient runs on the card on the dtype's route and matches
    the plain backward; dv is 128 wide."""
    q, k, v = _mla_qkv(dev, 1, 40, 2, dtype, 5)
    go = _rnd(dev, 1, 2, 40, 128, seed=9).to(dtype)
    dq, dk, dv = _grads_against_plain(q, k, v, go, dtype)
    assert dq.shape == q.shape and dv.shape == v.shape


def test_mla_decode_products_keep_f32_results_in_bf16(dev):
    """MLA's absorbed decode multiplies the bf16 latent cache and weights
    as stored with f32 results (the JAX op's preferred_element_type):
    each product within 1e-4 of the same product of f32 copies, and the
    layer's bf16 output within 1e-2 of the same call on the CPU."""
    from repro_torch.layers import attention as attn

    cfg = dataclasses.replace(reduced(get_config("deepseek_v2_lite")),
                              dtype="bfloat16")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(7)
    b, m, pos = 3, 40, 33
    params = attn.mla_init(gen, cfg, bf, dev)
    a = _rnd(dev, b, cfg.n_heads, cfg.kv_lora_rank, seed=1).to(bf)
    ckv = _rnd(dev, b, m, cfg.kv_lora_rank, seed=2).to(bf)
    got = attn._bmm_f32(a, ckv.transpose(1, 2))
    assert got.dtype == torch.float32
    _close_rel(got, torch.bmm(a.float(), ckv.float().transpose(1, 2)), 1e-4)
    cache = {"ckv": ckv, "krope": _rnd(dev, b, m, cfg.qk_rope_dim,
                                       seed=3).to(bf)}
    c_cpu = tree_to(cache, "cpu")
    x = _rnd(dev, b, 1, cfg.d_model, seed=4).to(bf)
    y, _ = attn.mla_decode(params, x, cache, cfg, pos=pos)
    y_cpu, _ = attn.mla_decode(tree_to(params, "cpu"), x.cpu(), c_cpu, cfg,
                               pos=pos)
    _close_rel(y.cpu().float(), y_cpu.float(), 1e-2)


# ---------------------------------------------------------------------------
# zamba2: ssm_scan at state size 64, flash_fwd at head dim 112
# ---------------------------------------------------------------------------

def _head_broadcast_A(dev, dm, n, p, seed):
    """mamba2's A reaching the kernel: one value a head of p channels,
    repeated over the channels and broadcast along n (a contiguous copy)."""
    a = -(_rnd(dev, dm // p, seed=seed).abs() + 0.5)
    return a.repeat_interleave(p)[:, None].expand(dm, n).contiguous()


@pytest.mark.parametrize("bt,L,dm,head_A", [(2, 129, 17, False),
                                            (1, 300, 40, False),
                                            (2, 1, 5, False),
                                            (1, 200, 96, True)])
def test_ssm_scan_kernel_state_64(dev, bt, L, dm, head_A):
    """n = 64 in f32 at L and dm off the kernel's 128-step, 32-channel
    tile, with and without h0, and with a per-head-broadcast A (heads of
    32 channels), against the plain version (TOL)."""
    n = 64
    x = _rnd(dev, bt, L, dm)
    delta = torch.nn.functional.softplus(_rnd(dev, bt, L, dm, seed=1)) * 0.1
    A = (_head_broadcast_A(dev, dm, n, 32, 2) if head_A
         else -(_rnd(dev, dm, n, seed=2).abs() + 0.1))
    B, C = _rnd(dev, bt, L, n, seed=3), _rnd(dev, bt, L, n, seed=4)
    D, h0 = _rnd(dev, dm, seed=5), _rnd(dev, bt, dm, n, seed=6)
    for h in (h0, None):
        reset_launches()
        y, hT = ssm_scan_fwd(x, delta, A, B, C, D, h0=h)
        assert ssm_scan_fwd.launches == 1
        ry, rhT = selective_scan_ref(x, delta, A, B, C, D, h0=h)
        torch.testing.assert_close(y, ry, **TOL)
        torch.testing.assert_close(hT, rhT, **TOL)


@pytest.mark.parametrize("bt,L", [(4, 512), (1, 2048)])
def test_ssm_scan_kernel_at_zamba2_shapes(dev, bt, L):
    """zamba2_7b's prefill (4 x 512) and forward (1 x 2048) at d_inner
    7168 and state 64, inputs as mamba2 hands them over: bf16 x, B, C, f32
    delta and A repeated over each head's 64 channels. y within one bf16
    rounding (1e-2 and 2^-7), hT within 1e-3 of its largest magnitude."""
    bf, dm, n, p = torch.bfloat16, 7168, 64, 64
    x = _rnd(dev, bt, L, dm).to(bf)
    dt = torch.nn.functional.softplus(_rnd(dev, bt, L, dm // p, seed=1) - 4)
    delta = dt.repeat_interleave(p, dim=-1)
    A = _head_broadcast_A(dev, dm, n, p, 2)
    B = _rnd(dev, bt, L, n, seed=3).to(bf)
    C = _rnd(dev, bt, L, n, seed=4).to(bf)
    D = torch.ones(dm, device=dev)
    y, hT = ssm_scan_fwd(x, delta, A, B, C, D)
    ry, rhT = selective_scan_ref(x, delta, A, B, C, D)
    torch.testing.assert_close(y, ry, atol=1e-2, rtol=2 ** -7)
    scale = float(rhT.abs().max())
    torch.testing.assert_close(hT, rhT, atol=1e-3 * scale, rtol=1e-3)


@pytest.mark.parametrize("sq,skv,causal", [(5, 5, True), (70, 70, True),
                                           (130, 200, True), (64, 64, False),
                                           (1, 77, True), (512, 512, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_head_dim_112(dev, sq, skv, causal, dtype):
    """d = 112 on the CUDA-core kernel (f32) and the tensor-core one (bf16,
    q, k, v the projections' strided views), ragged Sq != Skv and Sq off
    the 64-row tile, sm_scale 1/sqrt(112): f32 within 1e-4; bf16 o within
    2e-2 and 2^-6 of its row's largest |o|, lse within 1e-3 / 1e-4."""
    d = 112
    if dtype == torch.bfloat16:
        q = _view(dev, 2, skv, 4, d, 1)[:, :, skv - sq:]
        k, v = _view(dev, 2, skv, 4, d, 2), _view(dev, 2, skv, 4, d, 3)
    else:
        q = _rnd(dev, 2, 4, sq, d, seed=1)
        k, v = _rnd(dev, 2, 4, skv, d, seed=2), _rnd(dev, 2, 4, skv, d, seed=3)
    reset_launches()
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    want = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert flash_attention_fwd.routes[want] == 1 == flash_attention_fwd.launches
    assert o.shape == (2, 4, sq, d)
    ro, rlse = flash_fwd_ref(q, k, v, causal=causal, sm_scale=d ** -0.5)
    if dtype == torch.float32:
        torch.testing.assert_close(o, ro, **TOL)
        torch.testing.assert_close(lse, rlse, **TOL)
    else:
        torch.testing.assert_close(o.float(), ro.float(), atol=2e-2,
                                   rtol=2e-2)
        _close_rows(o, ro, 2 ** -6)
        torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_d112_gradient_on_card(dev, dtype):
    """d = 112 (zamba2's shared attention): the gradient runs on the card
    on the dtype's route and matches the plain backward."""
    q, k, v, go = (_rnd(dev, 1, 2, 40, 112, seed=i).to(dtype)
                   for i in range(4))
    _grads_against_plain(q, k, v, go, dtype)


def test_zamba2_serves_on_card_like_cpu(dev):
    """Reduced zamba2 (two groups of two mamba2 layers and the shared
    block, a mamba2 tail) at state 64 and head dim 112, one set of f32
    weights on the card and the CPU: prefill logits within 1e-3 of the
    largest, 8 greedy tokens equal, every scan and prefill attention on
    its kernel."""
    cfg = dataclasses.replace(reduced(get_config("zamba2_7b")), n_layers=5,
                              ssm_state=64, head_dim=112)
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(3))
    cpu = LM(cfg, device="cpu")
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 40))
    reset_launches()
    out, _ = generate(model, params, prompts, gen_tokens=8)
    counts = launch_counts()
    assert counts["ssm_scan"] == 5 and counts["flash_fwd"] == 2
    assert counts["flash_decode"] == 2 * 8
    ref, _ = generate(cpu, tree_to(params, "cpu"), prompts, gen_tokens=8)
    np.testing.assert_array_equal(out, ref)
    toks = torch.as_tensor(prompts, device=dev)
    with torch.no_grad():
        lg, _ = model.prefill(params, toks)
        lc, _ = cpu.prefill(tree_to(params, "cpu"), toks.cpu())
    _close_rel(lg.cpu(), lc, 1e-3)


# ---------------------------------------------------------------------------
# paligemma: flash_fwd at d = 256 and under the prefix-LM mask, paged
# decode at d = 256 with 8 query heads a kv head
# ---------------------------------------------------------------------------

PREFIX_CASES = [  # sq, skv, h, hk, d, prefix_len, window
    (70, 70, 8, 1, 256, 0, None),
    (130, 200, 8, 1, 256, 100, None),       # Sq != Skv, off the tiles
    (64, 64, 4, 4, 256, 64, None),          # a whole 64-row tile, group 1
    (40, 90, 8, 1, 256, 300, None),         # past Sq and Skv: all visible
    (150, 150, 8, 1, 256, 37, 20),          # a window, the prefix before it
    (200, 333, 8, 2, 128, 160, None),
    (100, 100, 4, 2, 64, 64, 16),
    (96, 96, 4, 1, 64, 200, None),
]


def _prefix_qkv(dev, sq, skv, h, hk, d, dtype, seed):
    if dtype == torch.bfloat16:                  # the projections' views
        q = _view(dev, 2, skv, h, d, seed)[:, :, skv - sq:]
        return q, _view(dev, 2, skv, hk, d, seed + 1), \
            _view(dev, 2, skv, hk, d, seed + 2)
    return (_rnd(dev, 2, h, sq, d, seed=seed),
            _rnd(dev, 2, hk, skv, d, seed=seed + 1),
            _rnd(dev, 2, hk, skv, d, seed=seed + 2))


@pytest.mark.parametrize("case", PREFIX_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_head_dim_256_and_prefix(dev, case, dtype):
    """d = 256 (groups 1 and 8) and the prefix-LM mask (none, off the
    tile, a whole tile, past Sq and Skv, with a window) on the CUDA-core
    kernel (f32, within 1e-4) and the tensor-core one (bf16 q, k, v the
    projections' strided views: o within 2e-2 and 2^-6 of its row's
    largest |o|, lse within 1e-3 / 1e-4), against flash_fwd_ref with the
    same prefix; the causal-only plain version differs on the prefix's
    rows."""
    sq, skv, h, hk, d, prefix, window = case
    q, k, v = _prefix_qkv(dev, sq, skv, h, hk, d, dtype, seed=sq + prefix)
    kw = dict(causal=True, window=window, prefix_len=prefix)
    reset_launches()
    o, lse = flash_attention_fwd(q, k, v, **kw)
    want = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert flash_attention_fwd.routes[want] == 1 == flash_attention_fwd.launches
    ro, rlse = flash_fwd_ref(q, k, v, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(o, ro, **TOL)
        torch.testing.assert_close(lse, rlse, **TOL)
    else:
        torch.testing.assert_close(o.float(), ro.float(), atol=2e-2,
                                   rtol=2e-2)
        _close_rows(o, ro, 2 ** -6)
        torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)
    if prefix > skv - sq + 1:           # some query sees a key past itself
        causal, _ = flash_fwd_ref(q, k, v, causal=True, window=window)
        assert not torch.allclose(o.float(), causal.float(), atol=2e-2,
                                  rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_d256_and_prefix_gradients_on_card(dev, dtype):
    """d = 256 and the prefix-LM mask (at d = 64 and 256): each gradient
    runs on the card on the dtype's route and matches the plain backward
    with the same prefix; the prefix changes the gradient."""
    q, k, v, go = (_rnd(dev, 1, 2, 40, 256, seed=i).to(dtype)
                   for i in range(4))
    p, pk, pv, gp = (_rnd(dev, 1, 2, 40, 64, seed=4 + i).to(dtype)
                     for i in range(4))
    _grads_against_plain(q, k, v, go, dtype)
    got = _grads_against_plain(p, pk, pv, gp, dtype, prefix_len=8)
    causal = _grads_against_plain(p, pk, pv, gp, dtype)
    assert not torch.allclose(got[0].float(), causal[0].float(), atol=2e-2)
    _grads_against_plain(q, k, v, go, dtype, prefix_len=24, window=5)


WIDE_BWD_CASES = [  # sq, skv, h, hk, d, dv, prefix_len, window
    (70, 70, 8, 1, 256, 256, 0, None),
    (130, 200, 8, 1, 256, 256, 100, None),   # Sq != Skv, off the tiles
    (64, 64, 4, 4, 256, 256, 64, None),      # one whole 64-row tile
    (40, 90, 8, 1, 256, 256, 300, None),     # past Sq and Skv
    (150, 150, 8, 1, 256, 256, 37, 20),      # a window, the prefix before it
    (90, 40, 8, 1, 256, 256, 0, None),       # rows 0-49 see no key
    (200, 333, 8, 2, 128, 128, 160, 50),
    (100, 100, 4, 2, 112, 112, 0, None),
    (130, 200, 8, 1, 112, 112, 70, 33),
    (70, 70, 4, 4, 192, 128, 0, None),
    (130, 200, 16, 2, 192, 128, 0, None),    # group 8
    (90, 40, 4, 1, 192, 128, 10, 16),        # dead rows, prefix, window
]


@pytest.mark.parametrize("layout", ["tc", "simt"])
@pytest.mark.parametrize("case", WIDE_BWD_CASES)
def test_flash_bwd_wide_domains_on_both_routes(dev, case, layout):
    """flash_bwd at d 112/128/256 and (192, 128), groups 1-8, ragged Sq !=
    Skv, the prefix (none, off the tile, a tile, past Sq) with and without
    a window, rows that see no key: bf16 q, k, v, do as the projections'
    views on the tensor-core route (dq within 2^-7 of its largest
    magnitude, dk and dv within 1e-3: the full-width limits), and the same
    values as f32 on the CUDA-core route (1e-4); a dead row's dq is 0.
    delta is rowsum(do o) plus noise, as for the d <= 128 cases."""
    sq, skv, h, hk, d, dv, prefix, window = case
    q = _view(dev, 2, sq, h, d, 0)
    k = _view(dev, 2, skv, hk, d, 1)
    v = _view(dev, 2, skv, hk, dv, 2)
    do = _view(dev, 2, sq, h, dv, 3)
    if layout == "simt":
        q, k, v, do = (t.float() for t in (q, k, v, do))
    kw = dict(causal=True, window=window, prefix_len=prefix)
    o, lse = flash_fwd_ref(q, k, v, **kw)
    delta = flash_delta(do, o) + _rnd(dev, 2, h, sq, seed=4)
    reset_launches()
    got = flash_bwd(q, k, v, do, lse, delta, **kw)
    path = "wgmma" if layout == "tc" else "simt"
    assert flash_bwd.routes[path] == 1 == flash_bwd.launches
    want = flash_bwd_ref(q, k, v, do, lse, delta, **kw)
    for a, b_, rel in zip(got, want, (2 ** -7, 1e-3, 1e-3)):
        assert a.shape == b_.shape and torch.isfinite(a).all()
        if layout == "simt":
            torch.testing.assert_close(a, b_, **TOL)
        else:
            _close_rel(a.float(), b_.float(), rel)
    assert (got[0][torch.isneginf(lse)] == 0).all()


@pytest.mark.parametrize("d", [64, 256])
def test_flash_bwd_prefix_against_causal_plain_fails(dev, d):
    """A planted check: the prefix kernel's gradient held against the
    causal-only plain backward is far outside the limit on the rows the
    prefix lets see past their diagonal."""
    sq = skv = 96
    q, k, v, do = (_view(dev, 1, sq, 2, d, i) for i in range(4))
    o, lse = flash_fwd_ref(q, k, v, prefix_len=40)
    delta = flash_delta(do, o)
    got = flash_bwd(q, k, v, do, lse, delta, prefix_len=40)
    want = flash_bwd_ref(q, k, v, do, lse, delta, prefix_len=40)
    causal = flash_bwd_ref(q, k, v, do, lse, delta)
    _close_rel(got[0].float(), want[0].float(), 2 ** -7)
    err = (got[0].float() - causal[0].float()).abs().max()
    assert err > 2 ** -7 * causal[0].float().abs().max()


@pytest.mark.parametrize("d", [112, 256])
def test_ring_refuses_wide_gradients_before_launch(dev, d):
    """The ring's CUDA-core step kernels take head dims up to 128 (64
    backward): an f32 gradient at d = 112 or 256 through the local ring
    raises before the first launch. The tensor-core route takes both widths
    (``csrc/ring_flash_wide.cu``): a bf16 gradient, with the prefix-LM mask
    at 256 (paligemma), runs on the wgmma route every step, o and the
    gradients against the CPU's plain versions on the same bf16 values
    within 2^-6 of the largest magnitude (as the d = 128 test below)."""
    q, k, v = (_rnd(dev, 1, h, 64, d, seed=i)
               for i, h in enumerate((4, 2, 2)))
    reset_launches()
    with pytest.raises(NotImplementedError, match=f"head dim {d}"):
        ring_flash_attention(q.requires_grad_(), k, v, ring_steps=2)
    assert launch_counts()["ring_flash_fwd"] == 0
    bf = torch.bfloat16
    ins = [t.detach().to(bf) for t in (q, k, v)]
    kw = dict(prefix_len=16) if d == 256 else {}
    go = _rnd(dev, 1, 4, 64, d, seed=5).to(bf)
    ts = [t.detach().requires_grad_() for t in ins]
    reset_launches()
    o = ring_flash_attention(*ts, ring_steps=2, **kw)
    got = (o,) + torch.autograd.grad(o, ts, go)
    assert ring_flash_fwd.routes == {"wgmma": 2, "simt": 0}
    assert ring_flash_bwd.routes == {"wgmma": 2, "simt": 0}
    cpu = [t.detach().cpu().float().requires_grad_() for t in ins]
    o_cpu = ring_flash_attention(*cpu, ring_steps=2, **kw)
    want = (o_cpu,) + torch.autograd.grad(o_cpu, cpu, go.cpu().float())
    for a, b_ in zip(got, want):
        _close_rel(a.detach().float().cpu(), b_.detach(), 2 ** -6)


PAGED_256_CASES = [  # lens, page, nsp, hk, g, d
    ([1016, 241, 0, 700, 33, 512, 999, 64], 512, 4, 1, 8, 256),
    ([300, 17, 0, 130], 16, 32, 1, 8, 256),
    ([90, 40, 0], 16, 4, 1, 8, 256),                 # wrapped caches
    ([200, 5, 0], 32, 8, 2, 4, 256),
]


@pytest.mark.parametrize("split", [None, 32, 64, 512])
@pytest.mark.parametrize("case", PAGED_256_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_head_dim_256_group_8(dev, monkeypatch, case, split,
                                           dtype):
    """d = 256 with 8 query heads a kv head (g d = 2048: two output chunks
    a thread; f32 takes a 2-stage ring) on layouts that keep the engine's
    invariant, each split length forced (None: the rule's), idle slots
    exactly 0, against paged_decode_ref; one launch a call."""
    from repro_torch.kernels.flash_attention import ops

    lens, page, nsp, hk, g, d = case
    if split is not None:
        monkeypatch.setattr(ops, "paged_split",
                            lambda b, hk, nsp, page: (
                                split, -(-nsp * page // split)))
    q, kp, vp, kw = _paged_inputs(dev, lens, page, nsp, hk, g, d, dtype,
                                  seed=sum(lens) % 89)
    reset_launches()
    o = paged_decode_attention(q, kp, vp, **kw)
    assert paged_decode_attention.launches == 1
    ref = paged_decode_ref(q, kp, vp, **kw)
    torch.testing.assert_close(o, ref, **_tol(dtype, ref))
    for bi, n in enumerate(lens):
        if n == 0:
            assert (o[bi] == 0).all()


def test_paligemma_serves_on_card_like_cpu(dev):
    """Reduced paligemma at the published attention shape (8 heads of 256
    over 1 kv head), one set of f32 weights on the card and the CPU:
    ``LM(get_config("paligemma_3b"))`` is no longer refused; prefill
    logits over 8 prefix embeddings within 1e-3 of the largest; 8 greedy
    tokens equal on the engine and on the static path; every prefill
    attention on flash_fwd, every engine decode on paged_decode."""
    assert LM(get_config("paligemma_3b"), device=dev).pageable
    cfg = dataclasses.replace(reduced(get_config("paligemma_3b")),
                              n_heads=8, n_kv_heads=1, head_dim=256)
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(5))
    cpu, p_cpu = LM(cfg, device="cpu"), tree_to(params, "cpu")
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 40))
    reset_launches()
    paged, st = generate(model, params, prompts, gen_tokens=8, page_size=16)
    counts = launch_counts()
    assert st["engine"] and counts["flash_fwd"] == 2 * 2
    assert counts["paged_decode"] == 2 * 7
    static, _ = generate(model, params, prompts, gen_tokens=8,
                         engine="static")
    ref, _ = generate(cpu, p_cpu, prompts, gen_tokens=8, engine="static")
    np.testing.assert_array_equal(paged, ref)
    np.testing.assert_array_equal(static, ref)
    pre = _rnd(dev, 2, 8, cfg.d_model, seed=7)
    toks = torch.as_tensor(prompts, device=dev)
    with torch.no_grad():
        lg, _ = model.prefill(params, toks, prefix_embeddings=pre)
        lc, _ = cpu.prefill(p_cpu, toks.cpu(), prefix_embeddings=pre.cpu())
    _close_rel(lg.cpu(), lc, 1e-3)


# ---------------------------------------------------------------------------
# the compiled decode steps: a CUDA graph's replays against eager steps
# ---------------------------------------------------------------------------

# reduced bf16 programs of every static kind: (arch, config changes)
STEP_PROGRAMS = [
    ("llama3_2_1b", {}),                              # dense GQA
    ("llama3_2_1b", dict(window=16)),                 # rolling, wraps
    ("musicgen_medium", {}),                          # sinusoidal positions
    ("falcon_mamba_7b", {}),                          # mamba1
    ("zamba2_7b", dict(n_layers=5)),                  # mamba2, shared block
    ("deepseek_v2_lite", dict(qk_nope_dim=128, qk_rope_dim=64,
                              v_head_dim=128)),        # MLA, MoE
]


def _route_counts():
    return {n: dict(fn.routes) for n, fn in KERNELS.items()
            if hasattr(fn, "routes")}


def _greedy_run(model, params, prompts, nsteps, max_len, step=None):
    """(tokens (nsteps, B), logits (nsteps, B, Vpad), launch counts, route
    counts) of ``nsteps`` greedy steps after a prefill of ``prompts``:
    through ``step`` (a built serve step), else ``model.greedy_step``
    eagerly. The counts cover the steps alone."""
    toks = torch.as_tensor(prompts, device=model.device)
    with torch.no_grad():
        logits, cache = model.prefill(params, toks, max_len=max_len)
        tok = model.greedy_token(logits)[:, None]
        if step is None:
            def step(p, c, t):
                return model.greedy_step(p, t, c)
        reset_launches()
        out, lgs = [], []
        for _ in range(nsteps):
            nxt, lg, cache = step(params, cache, tok)
            out.append(nxt.clone())
            lgs.append(lg.clone())
            tok = nxt[:, None]
    torch.cuda.synchronize()
    return (torch.stack(out), torch.stack(lgs), launch_counts(),
            _route_counts())


def _bf16_model(dev, arch, seed, **changes):
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="bfloat16",
                              **changes)
    model = LM(cfg, device=dev)
    return model, model.init(torch.Generator(device=dev).manual_seed(seed))


@pytest.mark.parametrize("arch,changes", STEP_PROGRAMS,
                         ids=["dense", "window", "sinusoidal", "mamba1",
                              "mamba2", "mla_moe"])
def test_compiled_static_step_equals_eager(dev, arch, changes):
    """24 greedy steps through ``build_serve_step`` (one eager step, one
    capture, 23 replays) after a 10-token prompt give the eager steps'
    tokens and logits bit for bit, with the eager launch and route
    counts; the window's 16-slot cache wraps during the replays."""
    model, params = _bf16_model(dev, arch, 5, **changes)
    prompts = np.random.default_rng(6).integers(0, model.cfg.vocab_size,
                                                (2, 10))
    nsteps, max_len = 24, 10 + 24 + 1
    eager = _greedy_run(model, params, prompts, nsteps, max_len)
    step, info = build_serve_step(model, batch=2)
    assert info["cuda_graph"] and isinstance(step, GraphStep)
    graph = _greedy_run(model, params, prompts, nsteps, max_len, step)
    assert step.captures == 1
    torch.testing.assert_close(graph[0], eager[0], atol=0, rtol=0)
    torch.testing.assert_close(graph[1], eager[1], atol=0, rtol=0)
    assert graph[2] == eager[2] and graph[3] == eager[3]


def test_compiled_paged_step_equals_eager(dev):
    """The engine's compiled step (captured at its second step) against
    the eager ``paged_greedy_step`` on traffic that admits and retires
    sequences between replays (6 requests, 2 slots): equal tokens, equal
    launch and route counts, one capture."""
    model, params = _bf16_model(dev, "llama3_2_1b", 7)
    rng = np.random.default_rng(8)
    traffic = [(rng.integers(0, model.cfg.vocab_size, n).tolist(), g)
               for n, g in ((5, 9), (17, 4), (3, 12), (30, 6), (8, 7),
                            (12, 5))]
    runs = []
    for compiled in (False, True):
        eng = Engine(model, params, batch=2, max_len=48, page_size=16)
        if not compiled:
            eng._step = lambda p, c, t: model.paged_greedy_step(p, t, c)
        reset_launches()
        rids = [eng.submit(p, g) for p, g in traffic]
        res = eng.drain()
        torch.cuda.synchronize()
        runs.append(([res[r] for r in rids], launch_counts(),
                     _route_counts()))
    assert isinstance(eng._step, GraphStep) and eng._step.captures == 1
    assert runs[1][0] == runs[0][0]
    assert [len(t) for t in runs[1][0]] == [g for _, g in traffic]
    assert runs[1][1:] == runs[0][1:]


def test_compiled_step_refuses_a_moved_cache(dev):
    """One built step serves the cache of its first call (its tokens equal
    the eager ones); handed the cache of another prefill it raises and
    never replays onto the first cache's addresses, and the first cache
    still replays. A replay past the cache's capacity raises the overflow
    error."""
    model, params = _bf16_model(dev, "llama3_2_1b", 9)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, model.cfg.vocab_size, (2, 10))
               for _ in range(2)]
    step, _ = build_serve_step(model, batch=2)
    eager = _greedy_run(model, params, prompts[0], 6, 24)
    graph = _greedy_run(model, params, prompts[0], 6, 24, step)
    assert step.captures == 1
    torch.testing.assert_close(graph[0], eager[0], atol=0, rtol=0)
    assert graph[2] == eager[2]
    tok = graph[0][-1][:, None]
    with torch.no_grad():
        _, other = model.prefill(
            params, torch.as_tensor(prompts[1], device=dev), max_len=24)
        with pytest.raises(ValueError, match="first call"):
            step(params, other, tok)
        assert int(other["pos"]) == 10 and step.captures == 1
    step, _ = build_serve_step(model, batch=2)
    with torch.no_grad():
        logits, cache = model.prefill(
            params, torch.as_tensor(prompts[0], device=dev), max_len=13)
        tok = model.greedy_token(logits)[:, None]
        for _ in range(3):                       # positions 10, 11, 12
            nxt, _, cache = step(params, cache, tok)
            tok = nxt[:, None]
        with pytest.raises(ValueError, match="cache overflow"):
            step(params, cache, tok)


def _eager_serve_step(model, *, batch, greedy=True, split=None):
    """``build_serve_step``'s eager counterpart: the model's method."""
    method = model.greedy_step if greedy else model.decode_step
    return (lambda p, c, t: method(p, t, c, split=split)), {
        "greedy": greedy, "cuda_graph": False}


@pytest.mark.parametrize("arch,changes", [("llama3_2_1b", {}),
                                          ("musicgen_medium", {})],
                         ids=["dense", "sinusoidal"])
def test_compiled_sampling_static_equals_eager(dev, monkeypatch, arch,
                                               changes):
    """``generate(engine="static", greedy=False)`` through the compiled
    ``decode_step`` (sampling from the replay's logits before the next
    replay) and eagerly, each with a generator of the same seed: equal
    tokens and launch counts."""
    model, params = _bf16_model(dev, arch, 11, **changes)
    prompts = np.random.default_rng(12).integers(0, model.cfg.vocab_size,
                                                 (2, 9))
    built, runs = [], []

    def spy(model_, **kw):
        step, info = build_serve_step(model_, **kw)
        built.append(step)
        return step, info

    for builder in (_eager_serve_step, spy):
        monkeypatch.setattr(serve_mod, "build_serve_step", builder)
        reset_launches()
        out, stats = generate(
            model, params, prompts, gen_tokens=16, engine="static",
            greedy=False, temperature=0.8,
            rng=torch.Generator(device=dev).manual_seed(13))
        torch.cuda.synchronize()
        assert not stats["engine"]
        runs.append((out.tolist(), launch_counts(), _route_counts()))
    assert isinstance(built[0], GraphStep) and built[0].captures == 1
    assert runs[1] == runs[0]


def test_compiled_sampling_engine_equals_eager(dev):
    """A sampling engine (``greedy=False``: its compiled step is
    ``paged_decode_step``'s graph, sampled before the next replay) against
    the same engine stepping ``paged_decode_step`` eagerly, each with a
    generator of the same seed, on traffic that admits and retires
    sequences between replays: equal tokens and launch counts."""
    model, params = _bf16_model(dev, "llama3_2_1b", 14)
    rng = np.random.default_rng(15)
    traffic = [(rng.integers(0, model.cfg.vocab_size, n).tolist(), g)
               for n, g in ((5, 9), (17, 4), (3, 12), (30, 6))]
    runs = []
    for compiled in (False, True):
        eng = Engine(model, params, batch=2, max_len=48, page_size=16,
                     greedy=False, temperature=0.8,
                     rng=torch.Generator(device=dev).manual_seed(16))
        if not compiled:
            eng._step = lambda p, c, t: model.paged_decode_step(p, t, c)
        reset_launches()
        rids = [eng.submit(p, g) for p, g in traffic]
        res = eng.drain()
        torch.cuda.synchronize()
        runs.append(([res[r] for r in rids], launch_counts(),
                     _route_counts()))
    assert isinstance(eng._step, GraphStep) and eng._step.captures == 1
    assert runs[1] == runs[0]
    assert [len(t) for t in runs[1][0]] == [g for _, g in traffic]


# ---------------------------------------------------------------------------
# the compiled train step: a CUDA graph's replays against eager steps
# ---------------------------------------------------------------------------

TRAIN_PROGRAMS = [("llama3_2_1b", "float32"), ("llama3_2_1b", "bfloat16"),
                  ("zamba2_7b", "float32"), ("paligemma_3b", "float32")]


def _train_state(dev, arch, dtype, seed=21, **kw):
    """(model, trainable params, AdamW, its state) on reduced ``arch`` in
    ``dtype`` with the LM options ``kw``."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
    model = LM(cfg, device=dev, **kw)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    for p in leaves(params):
        p.requires_grad_()
    opt = AdamW(schedule=WarmupCosine(peak_lr=3e-3, warmup_steps=2,
                                      total_steps=6))
    return model, params, opt, opt.init(params)


def _train_batches(model, n, b=4, s=32, seed=22):
    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bt = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (b, s)), device=dev)}
        if cfg.frontend:
            bt["prefix_embeddings"] = torch.as_tensor(rng.standard_normal(
                (b, cfg.num_prefix_embeddings, cfg.d_model)),
                dtype=getattr(torch, cfg.dtype), device=dev)
        out.append(bt)
    return out


def _train_run(dev, arch, dtype, step_of, nsteps, **kw):
    """``nsteps`` train steps from the seeded state through ``step_of(model,
    opt)``: (losses, gradient norms, final params, launch counts, route
    counts, the step)."""
    model, params, opt, state = _train_state(dev, arch, dtype, **kw)
    step = step_of(model, opt)
    reset_launches()
    losses, norms = [], []
    for bt in _train_batches(model, nsteps):
        _, _, loss, met = step(params, state, bt)
        losses.append(float(loss))
        norms.append(float(met["grad_norm"]))
    torch.cuda.synchronize()
    return (losses, norms, [p.detach() for p in leaves(params)],
            launch_counts(), _route_counts(), step)


def _assert_held_by_eager(e1, e2, c):
    """Compiled ``c`` against two eager runs ``e1``, ``e2`` from one state:
    bit-equal where the eager runs are, else each difference within theirs
    (the yardstick of run-to-run nondeterminism)."""
    def diff(x, y):
        d = max(abs(u - v) for u, v in zip(x[0] + x[1], y[0] + y[1]))
        p = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(x[2], y[2]))
        return d, p

    yard = diff(e1, e2)
    got = min(diff(c, e1), diff(c, e2))
    if yard == (0.0, 0.0):
        assert got == (0.0, 0.0), got
        for a, b in zip(c[2], e1[2]):
            assert torch.equal(a, b)
    else:
        assert got[0] <= yard[0] and got[1] <= yard[1], (got, yard)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch,dtype", TRAIN_PROGRAMS,
                         ids=["llama_f32", "llama_bf16", "zamba2", "paligemma"])
def test_compiled_train_step_equals_eager(dev, arch, dtype, accum, remat):
    """Five steps through ``build_train_step`` (one eager, one capture, four
    replays) against five eager ``train_step``s, twice, from the same
    state: the losses, gradient norms and parameters within the eager runs'
    own difference (bit-equal where they are), the launch and route counts
    equal (remat's recomputed kernels counted in both)."""
    def eager(model, opt):
        return lambda p, s, b: train_step(model, opt, p, s, b,
                                          accum_steps=accum)

    def compiled(model, opt):
        step, info = build_train_step(model, opt, accum_steps=accum)
        assert info == {"accum_steps": accum, "cuda_graph": True}
        return step

    runs = [_train_run(dev, arch, dtype, fn, 5, remat=remat)
            for fn in (eager, eager, compiled)]
    _assert_held_by_eager(*[r[:3] for r in runs])
    assert runs[2][3] == runs[0][3] and runs[2][4] == runs[0][4]
    step = runs[2][5]
    assert isinstance(step, TrainGraphStep) and step.captures == 1
    assert all(np.isfinite(runs[2][0]))


def test_compiled_train_step_refuses_another_pair(dev):
    """The step serves the (params, opt_state) of its first call: another
    params or optimizer state object, or a batch of another shape, raises
    and runs nothing; the first pair still replays."""
    model, params, opt, state = _train_state(dev, "llama3_2_1b", "float32")
    step, _ = build_train_step(model, opt)
    bts = _train_batches(model, 3)
    for bt in bts[:2]:
        step(params, state, bt)
    other_p = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    for p, s in ((other_p, state), (params, opt.init(params))):
        with pytest.raises(ValueError, match="first call"):
            step(p, s, bts[2])
    with pytest.raises(ValueError, match="captured for"):
        step(params, state, {"tokens": bts[2]["tokens"][:2]})
    assert int(state["step"]) == 2
    step(params, state, bts[2])
    assert int(state["step"]) == 3 and step.captures == 1


def test_compiled_trainloop_restore_continues_eager_history(dev, tmp_path,
                                                            monkeypatch):
    """``TrainLoop`` through the compiled step with a failure at step 3:
    the checkpoint of step 2 is copied into the step's leaves in place and
    the replays go on; the history and the final parameters are the eager
    loop's (the same failure, ``train_step`` eagerly) within the eager
    loops' own difference."""
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime import FailureInjector

    cfg = dataclasses.replace(reduced(get_config("llama3_2_1b")),
                              dtype="bfloat16")
    real = train_mod.build_train_step
    steps = []

    def build(model, optimizer, eager):
        step, info = real(model, optimizer)
        steps.append(step)
        if eager:
            return (lambda p, s, b: train_step(model, optimizer, p, s, b),
                    info)
        return step, info

    runs = []
    for i, eager in enumerate((True, True, False)):
        monkeypatch.setattr(train_mod, "build_train_step",
                            lambda m, o, e=eager: build(m, o, e))
        out = train_mod.TrainLoop(
            model=LM(cfg, device=dev), global_batch=4, seq_len=32, steps=6,
            ckpt_dir=str(tmp_path / str(i)), ckpt_every=2, verbose=False,
            injector=FailureInjector([3])).run()
        runs.append((out["history"], [], [p.detach() for p in
                                          leaves(out["params"])]))
    assert len(runs[2][0]) == 7
    _assert_held_by_eager(*runs)
    assert isinstance(steps[2], TrainGraphStep) and steps[2].captures == 1


def test_compiled_train_graph_holds_the_backward_kernels(dev, monkeypatch):
    """The captured graph of a bf16 train step holds, as kernel nodes, each
    hand-written kernel as often as the capture counted its wrapper: the
    forward's (rmsnorm, flash_fwd, the CE head) and the backward's
    (flash_delta, flash_bwd's dq kernel, the CE backward's first product)."""
    import re
    import tempfile

    from repro_torch.parallel import steps as steps_mod

    graphs = []

    def capture(fn):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            out = fn()
        graph.instantiate()
        graphs.append(graph)
        return graph.replay, out

    monkeypatch.setattr(steps_mod, "capture", capture)
    model, params, opt, state = _train_state(dev, "llama3_2_1b", "bfloat16")
    step, _ = build_train_step(model, opt)
    for bt in _train_batches(model, 3):
        step(params, state, bt)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/g.dot"
        graphs[0].debug_dump(path)
        names = re.findall(r"ID \| \d+ \(topoId: \d+\) \| ([^\s|}]+)",
                           open(path).read())
    kernels = {"rmsnorm": ("rmsnorm_vec_kernel", "rmsnorm_elem_kernel"),
               "flash_fwd": ("fwd_tc_kernel",),
               "flash_delta": ("delta_vec_kernel",),
               "flash_bwd": ("dq_tc_kernel",),
               "lm_head_ce": ("ce_merge_kernel",),
               "lm_head_bwd": ("DlEpi",)}
    seen = {k: sum(any(key in n for key in keys) for n in names)
            for k, keys in kernels.items()}
    assert seen == {k: n for k, (n, _) in step.counts.items()}
    assert seen["flash_bwd"] == seen["flash_fwd"] == model.cfg.n_layers


# ---------------------------------------------------------------------------
# autotuning on the card: winners swept, persisted, adopted and launched
# ---------------------------------------------------------------------------

def _record_launches(monkeypatch, module, names):
    """Record the arguments of each call of the C entry points ``names``
    that ``module``'s wrappers make through its ``load``."""
    calls = []

    class View:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            fn = getattr(self._lib, name)
            if name not in names:
                return fn

            def entry(*args):
                calls.append((name, args))
                return fn(*args)
            return entry

    real = module.load
    monkeypatch.setattr(module, "load", lambda n, sig: View(real(n, sig)))
    return calls


def test_tuned_split_is_adopted_launched_and_kept_by_the_graph(
        dev, tmp_path, monkeypatch):
    """paged decode's sweep runs every split on the card, each held
    against the plain version; a persisted winner (the sweep pinned to one
    split off the rule, so adoption shows) is adopted by the engine and
    passed to its step, and is the split the kernel launches with; the
    captured step keeps it after another winner is persisted (replays
    launch nothing from Python), its tokens equal an eager step's on the
    same split, and an engine built after that adopts the new winner."""
    from repro_torch.core import get_op
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.launch import tuning
    from repro_torch.tune_cli import _materialize

    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    model, params = _bf16_model(dev, "llama3_2_1b", 7)
    b, max_len, page = 2, 48, 16
    op = get_op("flash_decode_paged")
    metas, kw = tuning.serving_probes(model.cfg, b, max_len, max_len,
                                      page_size=page)["flash_decode_paged"]
    real, kw_real = _materialize(metas, kw, vocab=model.cfg.vocab_size,
                                 gen=torch.Generator(device=dev).manual_seed(1),
                                 device=dev)
    full = op.tune(real, repeats=2, **kw_real)
    assert len(full.trials) == 5 and full.skipped == []
    rule = attn_ops.paged_split(b, model.cfg.n_kv_heads, 3, page)[0]
    pinned = 64 if rule != 64 else 128
    monkeypatch.setattr(op, "sweep", {"split": [pinned]})
    assert op.tune(real, repeats=1, **kw_real)["split"] == pinned
    rng = np.random.default_rng(8)
    traffic = [(rng.integers(0, model.cfg.vocab_size, n).tolist(), g)
               for n, g in ((5, 9), (17, 4), (3, 12), (30, 6))]
    calls = _record_launches(monkeypatch, attn_ops, {"paged_decode"})
    eng = Engine(model, params, batch=b, max_len=max_len, page_size=page)
    assert eng.tuned == {"flash_decode_paged": {"split": pinned}}
    rids = [eng.submit(p, g) for p, g in traffic]
    for _ in range(3):                       # eager, capture, a replay
        eng.step()
    assert eng._step.captures == 1
    assert {a[13] for _, a in calls} == {pinned}
    monkeypatch.setattr(op, "sweep", {"split": [32]})
    assert op.tune(real, repeats=1, **kw_real)["split"] == 32
    n_launched = len(calls)                  # the sweep's launches too
    res = eng.drain()
    assert len(calls) == n_launched          # replays only
    compiled = [res[r] for r in rids]
    eager = Engine(model, params, batch=b, max_len=max_len, page_size=page,
                   use_tuned=False)
    assert eager.tuned == {}
    eager._step = lambda p, c, t: model.paged_greedy_step(p, t, c,
                                                          split=pinned)
    calls.clear()
    rids = [eager.submit(p, g) for p, g in traffic]
    res = eager.drain()
    assert {a[13] for _, a in calls} == {pinned}
    assert [res[r] for r in rids] == compiled
    later = Engine(model, params, batch=b, max_len=max_len, page_size=page)
    assert later.tuned == {"flash_decode_paged": {"split": 32}}
    calls.clear()
    later.submit(traffic[0][0], 2)
    later.step()                             # the first call runs eagerly
    assert {a[13] for _, a in calls} == {32}


def test_tune_cli_apps_on_the_card(dev, tmp_path, monkeypatch):
    """``tune_cli --apps`` at small shapes: every candidate launched, timed
    and held against the plain version; a second run all cache hits; the
    drivers adopt the winners, and their runs give the bits of runs on the
    default knobs (the knobs change no output's arithmetic)."""
    from repro_torch import tune_cli
    from repro_torch.launch.apps import hump_state

    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    argv = ["--apps", "--repeats", "2", "--fd-size", "256", "--fd-radius",
            "3", "--sem-elems", "4", "--sem-n", "5", "--dg-nx", "8",
            "--dg-n", "4"]
    code, res = tune_cli.run(argv)
    assert code == 0 and len(res) == 4
    for name, r in res:
        assert not r.cached and r.skipped == [], (name, r.skipped)
    code, again = tune_cli.run(argv)
    assert all(r.cached and r.trials == [] for _, r in again)
    won = dict(res)

    fd = fd_app.FDWave(width=256, height=256, radius=3)
    plain = fd_app.FDWave(width=256, height=256, radius=3, block=(32, 256))
    assert fd.block == (won["fd2d"]["bh"], won["fd2d"]["bw"])
    fd.run(20), plain.run(20)
    assert torch.equal(fd.u1, plain.u1)

    op = sem_app.SEMOperator(ex=4, ey=4, ez=4, n=5)
    assert op.eb == won["sem_apply"]["eb"]
    u = _rnd(dev, op.E, 6, 6, 6)
    base = sem_app.SEMOperator(ex=4, ey=4, ez=4, n=5, eb=8)
    assert torch.equal(op.apply_local(u), base.apply_local(u))

    sol = dg_swe.SWESolver(nx=8, ny=8, n=4, jitter=0.0)
    assert (sol.eb, sol.surf_eb) == (won["dg_volume"]["eb"],
                                     won["dg_surface"]["eb"])
    ref = dg_swe.SWESolver(nx=8, ny=8, n=4, jitter=0.0, eb=64)
    qa = qb = hump_state(sol)
    for _ in range(5):
        qa, qb = sol.step(qa, 1e-4), ref.step(qb, 1e-4)
    assert torch.equal(qa, qb)


# ---------------------------------------------------------------------------
# the kernel language's cuda backend: the six specs bound to hand-written
# kernels, through Device("cuda"), against their torch expansion on the
# card and their plain versions (the app tolerances above; matmul bf16 and
# rmsnorm bf16 one bf16 rounding, 2^-7)
# ---------------------------------------------------------------------------

def _lang_cases(dev):
    from repro_torch.apps.dg_swe import dg_surface_builder, dg_volume_builder
    from repro_torch.apps.fd2d import fd2d_builder
    from repro_torch.apps.sem import sem_builder
    from repro_torch.kernels.matmul import matmul_builder
    from repro_torch.kernels.rmsnorm import rmsnorm_builder

    def water(E, n, seed):
        q = _rnd(dev, E, n, 3, seed=seed) * torch.tensor([0.1, 0.3, 0.3],
                                                         device=dev)
        q[..., 0] += 1.5
        return q

    def normals(E, n):
        t = _rnd(dev, E, n, seed=7)
        return torch.stack([t.cos(), t.sin(), _rnd(dev, E, n, seed=8).abs()],
                           -1).contiguous()

    wts = tuple(float(x) for x in fd_second_derivative_weights(2))
    bf = torch.bfloat16
    return {
        "fd2d": (fd2d_builder, dict(w=64, h=48, r=2, bh=16, bw=32, dx=1 / 32,
                                    dt=0.01, weights=wts, dtype="float32"),
                 lambda: (_rnd(dev, 48, 64), _rnd(dev, 48, 64, seed=1)),
                 lambda u1, u2: fd2d_ref(u1, u2, wts, 1 / 32, 0.01),
                 fd2d, dict(atol=2e-5, rtol=2e-5)),
        "sem_ax": (sem_builder, dict(E=12, nq=5, eb=4, dtype="float32"),
                   lambda: (_rnd(dev, 12, 5, 5, 5), _rnd(dev, 12, 7, 5, 5, 5,
                                                         seed=1),
                            _rnd(dev, 5, 5, seed=2)),
                   apply_ref, sem_apply, APP_REL),
        "dg_swe_volume": (dg_volume_builder,
                          dict(E=32, np_=10, eb=8, g=9.81, dtype="float32"),
                          lambda: (water(32, 10, 3), _rnd(dev, 32, 4, seed=4),
                                   _rnd(dev, 32, 10, 2, seed=5),
                                   _rnd(dev, 10, 10, seed=6),
                                   _rnd(dev, 10, 10, seed=9)),
                          volume_ref, dg_volume, APP_REL),
        "dg_swe_surface": (dg_surface_builder,
                           dict(E=32, np_=10, nfp3=12, eb=8, g=9.81,
                                dtype="float32"),
                           lambda: (water(32, 12, 3), water(32, 12, 4),
                                    normals(32, 12),
                                    _rnd(dev, 10, 12, seed=6)),
                           surface_ref, dg_surface, APP_REL),
        "matmul": (matmul_builder, dict(M=64, K=96, N=48, bm=16, bk=32, bn=16,
                                        dtype="bfloat16"),
                   lambda: (_rnd(dev, 64, 96).to(bf),
                            _rnd(dev, 96, 48, seed=1).to(bf)),
                   matmul_ref, matmul, 2 ** -7),
        "rmsnorm": (rmsnorm_builder, dict(rows=24, d=256, block_rows=8,
                                          eps=1e-6, dtype="bfloat16",
                                          wdtype="float32"),
                    lambda: (_rnd(dev, 24, 256).to(bf), _rnd(dev, 256, seed=1)),
                    rmsnorm_ref, rmsnorm, 2 ** -7),
    }


@pytest.mark.parametrize("name", ["fd2d", "sem_ax", "dg_swe_volume",
                                  "dg_swe_surface", "matmul", "rmsnorm"])
def test_language_cuda_backend_runs_the_bound_kernel(dev, name):
    from repro_torch.core import Device

    builder, defines, make, plain, wrapper, tol = _lang_cases(dev)[name]
    cuda, expanded = Device("cuda"), Device("torch")
    kc = cuda.build_kernel(builder, defines)
    assert kc.binding.wrapper is wrapper and cuda.device.type == "cuda"
    ins = make()
    (t,) = kc.spec.outputs
    out = cuda.malloc(t.shape, t.dtype)
    ptr = out.data.data_ptr()
    reset_launches()
    kc(*ins, out)
    torch.cuda.synchronize()
    want = {k: int(w is wrapper) for k, w in KERNELS.items()}
    assert launch_counts() == want and out.data.data_ptr() == ptr
    (ref,) = expanded.build_kernel(builder, defines).run(*ins)
    assert launch_counts() == want           # the expansion launches nothing
    for other in (ref, plain(*ins).to(t.dtype)):
        if isinstance(tol, dict):
            torch.testing.assert_close(out.data, other, **tol)
        else:
            _close_rel(out.data.float(), other.float(), tol)
    (fresh,) = kc.run(*ins)
    assert fresh.data_ptr() != ptr and torch.equal(fresh, out.data)


def test_language_cuda_backend_refuses_at_build(dev):
    from repro_torch.apps.fd2d import fd2d_builder
    from repro_torch.core import Device, Spec, Tile

    cuda = Device("cuda")

    def unbound(D):
        return Spec("copy", grid=(2,),
                    inputs=[Tile("x", (8,), "float32", block=(4,))],
                    outputs=[Tile("y", (8,), "float32", block=(4,))],
                    body=lambda ctx, x, y: y.__setitem__(Ellipsis, x[...]))

    with pytest.raises(ValueError, match="no cuda binding"):
        cuda.build_kernel(unbound, {})
    with pytest.raises(ValueError, match="refuses these defines"):
        cuda.build_kernel(fd2d_builder, dict(
            w=32, h=32, r=1, bh=8, bw=32, dx=0.1, dt=0.01,
            weights=(1.0, -2.0, 1.0), dtype="float64"))
    assert Device("torch").device.type == "cuda"


def test_app_drivers_build_on_the_cuda_backend(dev):
    from repro_torch.launch.apps import hump_state

    reset_launches()
    fd = fd_app.FDWave(width=64, height=64, radius=2)
    assert fd.model == "cuda" and fd.fd2d.binding.name == "fd2d"
    fd.run(3)
    sol = dg_swe.SWESolver(nx=4, ny=4, n=2, jitter=0.0)
    sol.step(hump_state(sol), 1e-4)
    op = sem_app.SEMOperator(ex=2, ey=2, ez=1, n=3)
    op.apply_global(torch.ones(op.nglob, device=dev))
    counts = launch_counts()
    assert (counts["fd2d"], counts["dg_volume"], counts["dg_surface"],
            counts["sem_apply"]) == (3, 5, 5, 1)


# ---------------------------------------------------------------------------
# the ops over their builders: each op on CUDA tensors is its wrapper (the
# same bits, one launch a wrapper call), the attention, head and scan specs'
# cuda builds against their torch expansion, and a binding's refusal inside
# build_kernel
# ---------------------------------------------------------------------------

def _op_cases(dev):
    """{op name: (args, params, the wrapper's direct call)} at small
    shapes the kernels take (bf16 attention and heads, f32 apps)."""
    from repro_torch.kernels.flash_attention.ops import paged_positions

    bf = torch.bfloat16

    def r(*shape, seed=0, dtype=torch.float32, scale=1.0):
        return (_rnd(dev, *shape, seed=seed) * scale).to(dtype)

    q, k, v = (r(2, 4, 96, 64, seed=1, dtype=bf),
               r(2, 2, 160, 64, seed=2, dtype=bf),
               r(2, 2, 160, 64, seed=3, dtype=bf))
    qd, kd = r(2, 4, 1, 64, seed=4, dtype=bf), r(2, 2, 200, 64, seed=5,
                                                 dtype=bf)
    kp = r(9, 2, 32, 64, seed=6, dtype=bf)
    table = torch.tensor([[3, 1, 8, 2], [5, 4, 7, 6]], dtype=torch.int32)
    lens = torch.tensor([100, 37], dtype=torch.int32)
    paged = dict(block_table=table.to(dev), kv_len=lens.to(dev),
                 pos_pages=torch.from_numpy(paged_positions(
                     table.numpy(), lens.numpy(), 9, 32)).to(dev))
    starts = dict(q_start=torch.full((1, 1), 64, dtype=torch.int32,
                                     device=dev),
                  k_start=torch.full((1, 1), 32, dtype=torch.int32,
                                     device=dev))
    embed = r(300, 64, seed=7, dtype=bf, scale=0.05)
    x8, xr = r(8, 64, seed=8, dtype=bf), r(40, 64, seed=9, dtype=bf)
    labels = torch.randint(0, 290, (40, 1), device=dev, dtype=torch.int32)
    scan = (r(2, 40, 24, seed=10), torch.nn.functional.softplus(
        r(2, 40, 24, seed=11)), -(r(24, 16, seed=12).abs() + 0.1),
        r(2, 40, 16, seed=13), r(2, 40, 16, seed=14), r(24, seed=15))
    h0 = torch.zeros(2, 24, 16, device=dev)
    w3 = tuple(float(x) for x in fd_second_derivative_weights(2))
    u1, u2 = r(64, 96, seed=16), r(64, 96, seed=17)
    su, geo, dm = r(10, 4, 4, 4, seed=18), r(10, 7, 4, 4, 4, seed=19), \
        r(4, 4, seed=20)
    qv = r(12, 6, 3, seed=21, scale=0.1)
    qv[..., 0] += 1.5
    vol = (qv, r(12, 4, seed=22), r(12, 6, 2, seed=23, scale=0.01),
           r(6, 6, seed=24), r(6, 6, seed=25))
    qm, qp = r(12, 9, 3, seed=26, scale=0.1), r(12, 9, 3, seed=27, scale=0.1)
    qm[..., 0] += 1.5
    qp[..., 0] += 1.5
    th = r(12, 9, seed=28)
    nrm = torch.stack([th.cos(), th.sin(), r(12, 9, seed=29).abs()],
                      -1).contiguous()
    surf = (qm, qp, nrm, r(6, 9, seed=30))
    xn, wn = r(3, 5, 64, seed=31, dtype=bf), r(64, seed=32)
    a, b = r(96, 64, seed=33, dtype=bf), r(64, 128, seed=34, dtype=bf)
    return {
        "rmsnorm": ((xn, wn), dict(eps=1e-5),
                    lambda: rmsnorm(xn, wn, eps=1e-5)),
        "matmul": ((a, b), {}, lambda: matmul(a, b)),
        "flash_attention": ((q, k, v), dict(causal=True, window=50),
                            lambda: flash_attention_fwd(q, k, v,
                                                        window=50)[0]),
        "flash_decode": ((qd, kd, kd), dict(kv_len=150),
                         lambda: flash_decode(qd, kd, kd, kv_len=150)),
        "flash_decode_paged": ((qd, kp, kp), paged,
                               lambda: paged_decode_attention(qd, kp, kp,
                                                              **paged)),
        "ring_flash": ((q, k, v), dict(starts, causal=True),
                       lambda: ring_flash_fwd(q, k, v, *starts.values())[0]),
        "lm_head_logits": ((x8, embed.T), dict(vocab=290),
                           lambda: lm_head_logits(x8, embed.T, vocab=290)),
        "lm_head_ce": ((xr, embed.T, labels), dict(vocab=290),
                       lambda: lm_head_ce(xr, embed.T, labels, vocab=290)),
        "ssm_scan": (scan, {}, lambda: ssm_scan_fwd(*scan, h0=h0)[0]),
        "fd2d": ((u1, u2), dict(weights=w3, dx=0.05, dt=0.01),
                 lambda: fd2d(u1, u2, weights=w3, dx=0.05, dt=0.01)),
        "sem_apply": ((su, geo, dm), {}, lambda: sem_apply(su, geo, dm)),
        "dg_volume": (vol, {}, lambda: dg_volume(*vol)),
        "dg_surface": (surf, {}, lambda: dg_surface(*surf)),
    }


_OPS = sorted(["rmsnorm", "matmul", "flash_attention", "flash_decode",
               "flash_decode_paged", "ring_flash", "lm_head_logits",
               "lm_head_ce", "ssm_scan", "fd2d", "sem_apply", "dg_volume",
               "dg_surface"])


def _counted(fn):
    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in launch_counts().items() if v}


@pytest.mark.parametrize("name", _OPS)
def test_op_over_its_builder_is_its_wrapper_on_the_card(dev, name):
    """backend auto on CUDA tensors runs the spec's cuda binding: the
    wrapper's bits and launches; ``backend="cuda"`` is the same call."""
    from repro_torch.core import get_op

    args, params, direct = _op_cases(dev)[name]
    op = get_op(name)
    got, moved = _counted(lambda: op(*args, **params))
    want, wmoved = _counted(direct)
    assert moved == wmoved and sum(moved.values()) >= 1, (moved, wmoved)
    assert got.dtype == want.dtype and torch.equal(got, want), name
    again = op(*args, backend="cuda", **params)
    assert torch.equal(again, want)


def test_op_vjps_are_the_wrappers_backward_on_the_card(dev):
    """flash_attention's and lm_head_ce's OpVJPs (the delta, fused backward
    and CE backward builders on the cuda backend) give the wrappers'
    autograd bits, with the same launches."""
    from repro_torch.core import get_op

    cases = _op_cases(dev)
    q, k, v = cases["flash_attention"][0]
    do = _rnd(dev, *q.shape, seed=40).to(q.dtype)
    x, wt, labels = cases["lm_head_ce"][0]
    g = _rnd(dev, x.shape[0], seed=41)

    def attn(fn):
        ls = [t.detach().requires_grad_() for t in (q, k, v)]
        o = fn(*ls)
        return (o.detach(),) + torch.autograd.grad(o, ls, do)

    def head(fn):
        xl, el = x.detach().requires_grad_(), wt.T.detach().requires_grad_()
        loss = fn(xl, el.T)
        return (loss.detach(),) + torch.autograd.grad(loss, (xl, el), g)

    op_a, op_h = get_op("flash_attention"), get_op("lm_head_ce")
    for run, via_op, via_wrapper in (
            (attn, lambda *t: op_a(*t, causal=True, window=50),
             lambda *t: flash_attention(*t, causal=True, window=50)),
            (head, lambda xl, w: op_h(xl, w, labels, vocab=290),
             lambda xl, w: lm_head_ce(xl, w, labels, vocab=290))):
        got, moved = _counted(lambda: run(via_op))
        want, wmoved = _counted(lambda: run(via_wrapper))
        assert moved == wmoved
        for a_, b_ in zip(got, want, strict=True):
            assert a_.dtype == b_.dtype and torch.equal(a_, b_)


def _new_specs(dev):
    """The eleven specs of the attention, head and scan builders: (builder,
    defines, inputs) from the ops' own defines at the _op_cases shapes."""
    from repro_torch.core import get_op
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.lm_head import kernel as lk
    from repro_torch.kernels.ssm_scan import kernel as sk

    cases = _op_cases(dev)

    def prep(name):
        args, params, _ = cases[name]
        op = get_op(name)
        _, p = op._resolve(params)
        run_args, defines, _ = op._prepare(args, p)
        return defines, run_args

    out = {}
    D, ins = prep("flash_attention")
    o, lse = flash_attention_fwd(*ins, window=50)
    do = _rnd(dev, *o.shape, seed=42).to(o.dtype)
    delta = flash_delta(do, o)
    out["flash_attention_fwd"] = (fk.flash_fwd_builder, D, ins)
    out["flash_delta"] = (fk.flash_delta_builder, D, (do, o))
    out["flash_attention_bwd"] = (fk.flash_bwd_builder, D,
                                  (*ins, do, lse, delta))
    out["flash_decode"] = (fk.flash_decode_builder, *prep("flash_decode"))
    out["flash_decode_paged"] = (fk.paged_decode_builder,
                                 *prep("flash_decode_paged"))
    D, ins = prep("ring_flash")
    out["ring_flash_fwd"] = (fk.ring_flash_fwd_builder, D, ins)
    ro, rlse = ring_flash_fwd(*ins)
    rdo = _rnd(dev, *ro.shape, seed=43).to(ro.dtype)
    out["ring_flash_bwd"] = (fk.ring_flash_bwd_builder, D,
                             (*ins[:3], rdo, rlse, flash_delta(rdo, ro),
                              *ins[3:]))
    out["lm_head_logits"] = (lk.lm_head_builder, *prep("lm_head_logits"))
    D, ins = prep("lm_head_ce")
    out["lm_head_ce"] = (lk.lm_head_builder, D, ins)
    lse_c, _ = lm_head_ce.raw(*ins, vocab=290)
    out["lm_head_ce_bwd"] = (lk.lm_head_bwd_builder, D,
                             (*ins, lse_c, _rnd(dev, ins[0].shape[0], 1,
                                                seed=44)))
    out["ssm_scan"] = (sk.ssm_scan_builder, *prep("ssm_scan"))
    return out


_NEW_SPECS = sorted(["flash_attention_fwd", "flash_delta",
                     "flash_attention_bwd", "flash_decode",
                     "flash_decode_paged", "ring_flash_fwd",
                     "ring_flash_bwd", "lm_head_logits", "lm_head_ce",
                     "lm_head_ce_bwd", "ssm_scan"])


@pytest.mark.parametrize("name", _NEW_SPECS)
def test_new_spec_cuda_build_matches_its_torch_expansion(dev, name):
    """The spec's cuda build (its kernel) against its torch expansion on
    the card: 2^-7 of max |ref| for bf16 inputs (one rounding), 1e-4 for
    f32 (the scan); an argmax is held by the logit it picks."""
    from repro_torch.core import Device

    builder, D, ins = _new_specs(dev)[name]
    kc = Device("cuda").build_kernel(builder, D)
    assert kc.spec.name == name and kc.binding is not None
    got = kc.run(*ins)
    want = Device("torch").build_kernel(builder, D, analyze="off").run(*ins)
    rel = 2 ** -7 if ins[0].dtype == torch.bfloat16 else 1e-4
    for t, a_, b_ in zip(kc.spec.outputs, got, want, strict=True):
        if t.dtype == torch.int32:
            at = want[0].gather(1, a_.long())
            _close_abs(at, want[1], rel * float(want[0].abs().max()))
        else:
            _close_abs(a_.float(), b_.float(),
                       rel * float(b_.float().abs().max()))


def _close_abs(got, ref, atol):
    torch.testing.assert_close(got, ref, atol=atol, rtol=0)


def test_ring_backward_refuses_head_dim_112_inside_build_kernel(dev):
    """The ring step's CUDA-core backward kernel takes d 32/64 (ROADMAP
    §B; the tensor-core one takes 112 and 256 too): an f32 spec at d = 112
    fails inside build_kernel, before any launch."""
    from repro_torch.core import Device
    from repro_torch.kernels.flash_attention import kernel as fk

    D = dict(b=1, h=2, hk=1, sq=128, skv=128, d=112, dv=112, block_q=64,
             block_kv=64, causal=True, window=None, prefix_len=0,
             sm_scale=112 ** -0.5, dtype="float32", ring_steps=1,
             mesh_axis="model")
    reset_launches()
    with pytest.raises(ValueError, match="refuses these defines"):
        Device("cuda").build_kernel(fk.ring_flash_bwd_builder, D)
    # the torch expansion takes it (its tiles overflow the footprint model,
    # which gates that build by default)
    Device("torch").build_kernel(fk.ring_flash_bwd_builder, D,
                                 analyze="off")
    assert sum(launch_counts().values()) == 0


# ---------------------------------------------------------------------------
# the kernels at the local shard shapes of a (data 1, model 2) mesh
# (chip_smoke.py phase 22), one rank, no process group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_at_a_tensor_parallel_shard(dev, dtype):
    """llama3_2_1b's 32 / 8 query / kv heads on 2 ranks: 16 / 4 a rank
    (g 4, d 64) over 512-token pages, against paged_decode_ref."""
    lens = [1016, 241, 700, 33, 512, 999, 64, 1]
    q, kp, vp, kw = _paged_inputs(dev, lens, 512, 4, 4, 4, 64, dtype,
                                  seed=41)
    reset_launches()
    o = paged_decode_attention(q, kp, vp, **kw)
    assert paged_decode_attention.launches == 1
    tol = TOL if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(o.float(),
                               paged_decode_ref(q, kp, vp, **kw).float(),
                               **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_head_on_vocab_shards_with_the_argmax_combined(dev, dtype):
    """The decode head on each of two vocab shards of a tied embedding
    (the view ``shard.T``), held to the plain version on the shard, and
    the shards' (max, argmax) combined at the second shard's column offset
    (the larger value, ties to the lower column: ``comm.argmax_combine``'s
    rule) against the argmax over the whole vocab, where the top-2 gap is
    past the rounding."""
    vs, d, rows = 4096, 256, 8
    embed = (0.05 * _rnd(dev, 2 * vs, d, seed=3)).to(dtype)
    x = _rnd(dev, rows, d, seed=4).to(dtype)
    raw = []
    for r in range(2):
        w = embed[r * vs:(r + 1) * vs].T
        lg, m, arg = lm_head_logits.raw(x, w, vocab=vs - 3 * r)
        rlg, rm, rarg = lm_head_logits_ref(x, w, vocab=vs - 3 * r)
        atol = 1e-4 if dtype == torch.float32 else 4e-3
        torch.testing.assert_close(lg, rlg, atol=atol, rtol=0)
        torch.testing.assert_close(m, rm, atol=atol, rtol=0)
        raw.append((m, arg))
    top = torch.maximum(raw[0][0], raw[1][0])
    big = torch.iinfo(torch.int64).max
    col = torch.minimum(
        torch.where(raw[0][0] == top, raw[0][1].long(), big),
        torch.where(raw[1][0] == top, raw[1][1].long() + vs, big))
    full, _, farg = lm_head_logits_ref(x, embed.T, vocab=2 * vs - 3)
    top2 = torch.topk(full[:, :2 * vs - 3], 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 1e-2
    assert decided.any()
    assert (col[decided] == farg[decided].long()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_head_ce_on_a_vocab_shard_with_labels_outside(dev, dtype):
    """The CE forward and backward on the second of two vocab shards:
    labels shifted by the shard's offset, half of them outside it (negative
    or past its columns) give gold 0 and no one-hot; lse and gold against
    the plain version, dx and dw from a global lse (the other shard's mass
    added) against the plain backward, on both routes."""
    vs, d, rows = 1536, 256, 70
    w = (0.05 * _rnd(dev, 2 * vs, d, seed=5)).to(dtype)[vs:].T
    x = _rnd(dev, rows, d, seed=6).to(dtype)
    gen = torch.Generator(device=dev).manual_seed(7)
    labels = (torch.randint(0, 2 * vs, (rows, 1), generator=gen,
                            device=dev) - vs).to(torch.int32).contiguous()
    out = (labels < 0) | (labels >= vs)
    assert out.any() and (~out).any()
    lse, gold = lm_head_ce.raw(x, w, labels, vocab=vs)
    rlse, rgold = lm_head_ce_stats_ref(x, w, labels, vocab=vs)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)
    torch.testing.assert_close(gold, rgold, atol=1e-3, rtol=0)
    assert (gold[out] == 0).all()
    g = torch.rand((rows, 1), generator=gen, device=dev) / rows
    glse = (rlse + 0.5).contiguous()
    dx, dw = lm_head_bwd(x, w, labels, glse, g, vocab=vs)
    rdx, rdw = lm_head_bwd_ref(x, w, labels, glse, g, vocab=vs)
    _close_rel(dx, rdx, 1e-3)
    _close_rel(dw, rdw, 1e-3)


# ---------------------------------------------------------------------------
# the kernels at the local shard shapes of tensor parallelism below the
# kv heads (chip_smoke.py phase 23), one rank, no process group
# ---------------------------------------------------------------------------

def _shard_cache(dev, b, h, hk, skv, d, dtype, seed):
    q = _rnd(dev, b, h, 1, d, seed=seed).to(dtype)
    k = _rnd(dev, b, hk, skv, d, seed=seed + 1).to(dtype)
    v = _rnd(dev, b, hk, skv, d, seed=seed + 2).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("off,q_pos", [(0, 600), (256, 300), (512, 300)])
def test_flash_decode_lse_on_a_sequence_shard(dev, dtype, off, q_pos):
    """paligemma's 8 query heads over its 1 kv head (d 256) on a shard of
    256 slots holding positions [off, off + 256) (``slot_pos``): o and lse
    against the plain version. A shard whose first slot is past ``q_pos``
    (off 512) sees nothing: o = 0, lse = -inf, and the merge weighs it 0;
    one partly past it (off 256) is masked by position, the range skip by
    slot index staying sound."""
    q, k, v = _shard_cache(dev, 2, 8, 1, 256, 256, dtype, seed=off)
    slot_pos = torch.arange(off, off + 256, dtype=torch.int32, device=dev)
    kv_len = torch.full((1,), q_pos + 1, dtype=torch.int32, device=dev)
    reset_launches()
    o, lse = flash_decode(q, k, v, kv_len=kv_len, slot_pos=slot_pos,
                          return_lse=True)
    assert flash_decode.launches == 1 and lse.shape == (2, 8)
    ro, rlse = decode_ref(q, k, v, kv_len=kv_len, slot_pos=slot_pos,
                          return_lse=True)
    tol = TOL if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(o.float(), ro.float(), **tol)
    if off > q_pos:
        assert (o == 0).all() and (lse == float("-inf")).all()
        assert (rlse == float("-inf")).all()
    else:
        torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)


def test_flash_decode_shards_merge_to_the_whole_cache(dev):
    """Two sequence shards' (o, lse) merged by ``ring_merge`` equal one
    ``flash_decode`` over the whole cache, the second shard wholly past the
    query included."""
    from repro_torch.kernels.flash_attention.ring import ring_merge

    q, k, v = _shard_cache(dev, 2, 8, 1, 512, 256, torch.float32, seed=9)
    kv_len = torch.full((1,), 200, dtype=torch.int32, device=dev)
    whole = flash_decode(q, k, v, kv_len=kv_len)
    for cut in (256, 128):
        parts = []
        for lo, hi in ((0, cut), (cut, 512)):
            sp = torch.arange(lo, hi, dtype=torch.int32, device=dev)
            o, lse = flash_decode(q, k[:, :, lo:hi].contiguous(),
                                  v[:, :, lo:hi].contiguous(), kv_len=kv_len,
                                  slot_pos=sp, return_lse=True)
            parts.append((o, lse[..., None]))
        o, _ = ring_merge(*parts)
        torch.testing.assert_close(o, whole, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_four_query_heads_over_one_kv_head_d256(dev, dtype):
    """paligemma on 2 ranks: 4 query heads a rank over the replicated kv
    head (g 4, d 256, g d = 1024) on 256-token pages, against
    paged_decode_ref."""
    lens = [300, 1, 0, 511]
    q, kp, vp, kw = _paged_inputs(dev, lens, 256, 2, 1, 4, 256, dtype,
                                  seed=43)
    reset_launches()
    o = paged_decode_attention(q, kp, vp, **kw)
    assert paged_decode_attention.launches == 1
    tol = TOL if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(o.float(),
                               paged_decode_ref(q, kp, vp, **kw).float(),
                               **tol)
