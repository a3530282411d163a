"""The ten builders that joined the port's kernel language with the
attention, head and scan specs (``repro_torch.kernels.*.kernel``) against
the JAX builders at the same defines: the port's torch and loops
expansions against JAX's jnp and loops, on the same numpy inputs, f32 at
tiny shapes. Limit: 1e-5 of max |JAX| for attention, heads and scan
outputs, 2e-4 for the backward's products (dq, dk, dv, dx, dw: sums of
many products in another order).

Two specs differ from JAX's where the kernels do: the attention
backwards emit dk and dv summed over each kv head's group of query heads
(``flash_bwd``'s outputs), which here are held against JAX's per-head dk
and dv summed over the group."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import Device as JDevice
from repro.kernels.flash_attention import kernel as jk
from repro.kernels.lm_head import kernel as jl
from repro.kernels.ssm_scan import kernel as js

from repro_torch.core import Device
from repro_torch.kernels.flash_attention import kernel as tk
from repro_torch.kernels.lm_head import kernel as tl
from repro_torch.kernels.ssm_scan import kernel as ts

PAIRS = (("torch", "jnp"), ("loops", "loops"))


def _run(tb, jb, defines, inputs):
    """{port backend: outputs} and {JAX backend: outputs} as numpy."""
    got, want = {}, {}
    for tback, jback in PAIRS:
        k = Device(tback, device="cpu").build_kernel(tb, defines)
        got[tback] = [o.numpy() for o in k.run(*(torch.from_numpy(x)
                                                  for x in inputs))]
        jkern = JDevice(jback).build_kernel(jb, defines)
        want[jback] = [np.asarray(o) for o in jkern.run(
            *(jnp.asarray(x) for x in inputs))]
    return got, want


def _close(got, want, rel, what):
    for g, w in zip(got, want):
        assert g.shape == w.shape, what
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale,
                                   err_msg=what)


def _agree(tb, jb, defines, inputs, rel=1e-5, fold=None):
    got, want = _run(tb, jb, defines, inputs)
    for tback, jback in PAIRS:
        w = want[jback] if fold is None else fold(want[jback])
        _close(got[tback], w, rel, f"{tback} vs {jback}")
    return got["torch"]


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _attn(b=1, h=4, hk=2, sq=16, skv=24, d=8, **kw):
    D = dict(b=b, h=h, hk=hk, sq=sq, skv=skv, d=d, dv=d, block_q=8,
             block_kv=8, causal=True, window=None, prefix_len=0,
             sm_scale=float(d ** -0.5), dtype="float32")
    D.update(kw)
    return D


def _qkv(rng, D):
    return (_rand(rng, D["b"], D["h"], D["sq"], D["d"]),
            _rand(rng, D["b"], D["hk"], D["skv"], D["d"]),
            _rand(rng, D["b"], D["hk"], D["skv"], D["dv"]))


MASKS = [dict(), dict(window=6, prefix_len=5)]


@pytest.mark.parametrize("masks", MASKS, ids=["causal", "window_prefix"])
def test_flash_fwd_builder_matches_jax(masks):
    D = _attn(**masks)
    _agree(tk.flash_fwd_builder, jk.flash_fwd_builder, D,
           _qkv(np.random.RandomState(0), D))


def test_flash_delta_builder_matches_jax():
    rng = np.random.RandomState(1)
    D = dict(b=1, h=4, sq=16, dv=8, block_q=8, dtype="float32")
    _agree(tk.flash_delta_builder, jk.flash_delta_builder, D,
           (_rand(rng, 1, 4, 16, 8), _rand(rng, 1, 4, 16, 8)))


def _fold_group(outs, g):
    """JAX's per-head dk, dv summed over each kv head's group."""
    dq, dk, dv = outs
    fold = [x.reshape(x.shape[0], -1, g, *x.shape[2:]).sum(2)
            for x in (dk, dv)]
    return [dq, *fold]


def _bwd_inputs(rng, D, starts=None):
    q, k, v = _qkv(rng, D)
    fwd = JDevice("jnp").build_kernel(
        jk.ring_flash_fwd_builder if starts else jk.flash_fwd_builder,
        dict(D, ring_steps=1, mesh_axis="model") if starts else D)
    o, lse = (np.asarray(x) for x in fwd.run(
        q, k, v, *((jnp.asarray(s) for s in starts) if starts else ())))
    do = _rand(rng, *o.shape)
    delta = (do * o).sum(-1).astype(np.float32)
    return (q, k, v, do, lse.astype(np.float32), delta) + tuple(
        starts or ())


def test_flash_bwd_builder_matches_jax_summed_over_groups():
    D = _attn(window=6, prefix_len=5)
    _agree(tk.flash_bwd_builder, jk.flash_bwd_builder, D,
           _bwd_inputs(np.random.RandomState(2), D), rel=2e-4,
           fold=lambda outs: _fold_group(outs, D["h"] // D["hk"]))


def _decode(window=None):
    return dict(b=2, h=4, hk=2, skv=32, d=8, dv=8, block_kv=8, window=window,
                sm_scale=float(8 ** -0.5), dtype="float32")


def test_flash_decode_builder_matches_jax():
    rng = np.random.RandomState(3)
    D = _decode(window=12)
    q = _rand(rng, 2, 4, 1, 8)
    k, v = _rand(rng, 2, 2, 32, 8), _rand(rng, 2, 2, 32, 8)
    # a partly filled cache (the last slots empty), then a rotated
    # rolling one past its wrap (slot i holds a position p, p % 32 == i)
    slot_pos = np.where(np.arange(32) < 28, np.arange(32), -1).astype(
        np.int32)[None]
    _agree(tk.flash_decode_builder, jk.flash_decode_builder, D,
           (q, k, v, np.array([[20]], np.int32), slot_pos))
    slot_pos = np.where(np.arange(32) < 8, np.arange(32) + 64,
                        np.arange(32) + 32).astype(np.int32)[None]
    _agree(tk.flash_decode_builder, jk.flash_decode_builder, D,
           (q, k, v, np.array([[72]], np.int32), slot_pos))


def test_paged_decode_builder_matches_jax():
    rng = np.random.RandomState(4)
    D = dict(b=2, h=4, hk=2, d=8, dv=8, npages=6, page=8, nseq_pages=3,
             window=None, sm_scale=float(8 ** -0.5), dtype="float32")
    q = _rand(rng, 2, 4, 1, 8)
    kp, vp = _rand(rng, 6, 2, 8, 8), _rand(rng, 6, 2, 8, 8)
    table = np.array([[3, 1, 0], [2, 5, 4]], np.int32)
    kv_len = np.array([[13], [24]], np.int32)
    pos = np.full((6, 8), -1, np.int32)
    for row, n in zip(table, kv_len[:, 0]):
        for j, p in enumerate(row):
            if j * 8 < n:
                pos[p] = np.arange(j * 8, (j + 1) * 8)
    _agree(tk.paged_decode_builder, jk.paged_decode_builder, D,
           (q, kp, vp, table, kv_len, pos))


def _ring(**kw):
    return dict(_attn(sq=16, skv=16, **kw), ring_steps=1, mesh_axis="model")


def _starts(q0, k0):
    return (np.full((1, 1), q0, np.int32), np.full((1, 1), k0, np.int32))


@pytest.mark.parametrize("q0,k0", [(16, 0), (0, 16)],
                         ids=["chunk_before", "chunk_after"])
def test_ring_flash_fwd_builder_matches_jax(q0, k0):
    D = _ring(window=20, prefix_len=3)
    q, k, v = _qkv(np.random.RandomState(5), D)
    _agree(tk.ring_flash_fwd_builder, jk.ring_flash_fwd_builder, D,
           (q, k, v, *_starts(q0, k0)))


def test_ring_flash_bwd_builder_matches_jax_summed_over_groups():
    D = _ring(window=20, prefix_len=3)
    _agree(tk.ring_flash_bwd_builder, jk.ring_flash_bwd_builder, D,
           _bwd_inputs(np.random.RandomState(6), D, starts=_starts(8, 0)),
           rel=2e-4, fold=lambda outs: _fold_group(outs, 2))


def _head(emit):
    return dict(R=16, d=16, V=32, vocab=30, block_r=8, block_v=16, block_k=8,
                emit_logits=emit, dtype="float32")


@pytest.mark.parametrize("emit", [1, 0], ids=["logits", "ce"])
def test_lm_head_builder_matches_jax(emit):
    rng = np.random.RandomState(7)
    x, w = _rand(rng, 16, 16), _rand(rng, 16, 32)
    ins = (x, w) if emit else (x, w, rng.randint(0, 30, (16, 1)).astype(
        np.int32))
    got, want = _run(tl.lm_head_builder, jl.lm_head_builder, _head(emit),
                     ins)
    for tback, jback in PAIRS:
        if emit:     # the argmax exactly, logits and max within 1e-5
            np.testing.assert_array_equal(got[tback][2], want[jback][2])
            _close(got[tback][:2], want[jback][:2], 1e-5, tback)
        else:
            _close(got[tback], want[jback], 1e-5, tback)


def test_lm_head_bwd_builder_matches_jax():
    rng = np.random.RandomState(8)
    D = dict(R=16, d=16, V=32, vocab=30, block_r=8, block_v=16,
             dtype="float32")
    x, w = _rand(rng, 16, 16), _rand(rng, 16, 32)
    labels = rng.randint(0, 30, (16, 1)).astype(np.int32)
    logits = x @ w
    lse = np.log(np.exp(logits[:, :30]).sum(-1, keepdims=True)).astype(
        np.float32)
    g = _rand(rng, 16, 1)
    _agree(tl.lm_head_bwd_builder, jl.lm_head_bwd_builder, D,
           (x, w, labels, lse, g), rel=2e-4)


def test_ssm_scan_builder_matches_jax():
    rng = np.random.RandomState(9)
    bt, L, dm, n = 1, 16, 8, 4
    D = dict(bt=bt, L=L, dm=dm, n=n, chunk=4, d_block=4, dtype="float32")
    x = _rand(rng, bt, L, dm)
    delta = (np.log1p(np.exp(_rand(rng, bt, L, dm))) * 0.1).astype(
        np.float32)
    A = -(np.abs(_rand(rng, dm, n)) + 0.1).astype(np.float32)
    B, C = _rand(rng, bt, L, n), _rand(rng, bt, L, n)
    Dskip, h0 = _rand(rng, 1, dm), _rand(rng, bt, dm, n)
    _agree(ts.ssm_scan_builder, js.ssm_scan_builder, D,
           (x, delta, A, B, C, Dskip, h0))


# ---------------------------------------------------------------------------
# the cuda backend's outputs: run() hands back the wrapper's own tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("copies", [True, False])
def test_cuda_expansion_copies_only_into_callers_outputs(monkeypatch,
                                                         copies):
    """A stub binding stands for a wrapper: ``run`` (no output Memory)
    returns the tensors the launch made, with no copy; a call into output
    tensors copies into them when the wrapper makes its own
    (``copies=True``) and hands them to the launch otherwise."""
    from repro_torch.core import Spec, Tile, cuda as tcuda, lang

    made, seen = [], []

    def launch(D, ins, outs):
        seen.append(outs)
        if outs is not None:
            outs[0].copy_(ins[0] * 2)
            return outs
        made.append(ins[0] * 2)
        return (made[-1],)

    monkeypatch.setitem(tcuda._TABLE, "stub", tcuda.Binding(
        "stub", wrapper=None, launch=launch, refusal=lambda spec, D: None,
        launch_defines=(), copies=copies))
    spec = Spec("stub", grid=(2,), inputs=[Tile("x", (8,), "float32",
                                                block=(4,))],
                outputs=[Tile("y", (8,), "float32", block=(4,))],
                body=lambda ctx, x, y: None)
    fn = lang.expand(spec, lang.defines_namespace({}), "cuda")
    x = torch.arange(8, dtype=torch.float32)
    (y,) = fn(x)
    assert y is made[-1] and seen[-1] is None          # no copy
    out = torch.empty(8)
    (z,) = fn(x, outs=(out,))
    assert z is out and torch.equal(out, 2 * x)
    assert (seen[-1] is None) == copies                # copies: launch made
    assert len(made) == (2 if copies else 1)           # its own, copied in
