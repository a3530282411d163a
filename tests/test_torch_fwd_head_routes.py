"""The tensor-core routes of the ring step forward (``ring_flash_fwd``) and
of the decode LM head (``lm_head_logits``), on the CPU.

* The route rules are pure functions of dtype, strides and alignment, held
  here on CPU tensors' metadata: ``route`` (q, k, v) for the ring forward,
  ``head_route`` (x, w) for the decode head. The wrappers' choice of entry
  point is held with the library stubbed (``load`` returns a recorder,
  ``on_cpu`` says "card"): bf16 with 16-byte rows takes the tensor-core
  entry (``ring_flash_fwd_tc``, ``lm_head_tc``), f32 and unaligned bf16 the
  CUDA-core one; each call counts its route. CPU calls run the plain
  versions and count nothing.
* The plain versions against the JAX ops on the same seeded numpy inputs:
  ``ring_fwd_ref`` against the JAX ring step (Pallas, interpret mode) at the
  four kinds of (rank, step) pair a causal ring replays (a chunk fully
  visible, on the diagonal, wholly after its queries, and one seen through
  a prefix), and ``lm_head_logits_ref`` against the JAX ``lm_head_logits``
  (Pallas, interpret mode) at R = 1, 8 and 20 with a padded vocab and equal
  best columns.
* Plain models of what the tensor-core kernels do differently: the decode
  head's partials (a (max, first argmax) per 16 vocab rows, folded by the
  larger-max, smaller-index rule) give the plain argmax; the ring forward's
  bf16 p before P V stays within the row-scaled limit its card check uses.

Tolerances: f32 throughout; 1e-5 where both sides compute the same sums in
another order at these sizes (d <= 128, V <= 1104).
"""

import ctypes

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ring as jax_ring
from repro.kernels.lm_head import lm_head_logits as jax_logits

from repro_torch.kernels import reset_launches
from repro_torch.kernels.flash_attention import (ring_flash_fwd, ring_fwd_ref,
                                                 route)
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.lm_head import (bwd_route, head_route,
                                         lm_head_logits, lm_head_logits_ref)
from repro_torch.kernels.lm_head import ops as head_ops

BF = torch.bfloat16
EXACT = dict(rtol=1e-5, atol=1e-5)
PART_ROWS = 16      # vocab rows of one partial on the tensor-core head


class _Lib:
    """A stand-in for a kernel library: records which entry point was
    called and with what, returns 0 (no CUDA error)."""

    def __init__(self, consts=None):
        self.calls = []
        self.consts = consts or {}

    def __getattr__(self, name):
        if name in self.consts:
            return self.consts[name]

        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def stub(monkeypatch):
    """Both wrappers as they run on the card, with their libraries
    replaced by recorders."""
    libs = {"ring_flash": _Lib(),
            "lm_head": _Lib({"lm_head_tc_partials":
                             lambda V: -(-V // PART_ROWS),
                             "lm_head_partials": lambda V: -(-V // 64)})}
    for mod in (head_ops, attn_ops):
        monkeypatch.setattr(mod, "on_cpu", lambda name, *ts: False)
        monkeypatch.setattr(mod, "load", lambda name, sig: libs[name])
        monkeypatch.setattr(mod, "stream", lambda: ctypes.c_void_p(0))
    reset_launches()
    return libs


def _bf(*shape, dtype=BF):
    return torch.zeros(shape, dtype=dtype)


def _proj(b, s, h, d, dtype=BF):
    """A projection's head view: (B, S, H, D) -> (B, H, S, D)."""
    return torch.zeros((b, s, h, d), dtype=dtype).transpose(1, 2)


def _shifted(*shape, dtype=BF):
    """A tensor whose base is one element past an aligned address."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(*shape)


# ---------------------------------------------------------------------------
# the ring forward's route and entry point
# ---------------------------------------------------------------------------

RING_FWD_ROUTES = {
    "bf16, q a view, k/v contiguous (the replay)": (
        lambda: (_proj(1, 96, 8, 64), _bf(1, 2, 80, 64), _bf(1, 2, 80, 64)),
        "wgmma"),
    "bf16, all three projection views": (
        lambda: (_proj(1, 96, 8, 32), _proj(1, 80, 2, 32),
                 _proj(1, 80, 2, 32)), "wgmma"),
    "bf16 d = 128, a chunk sliced out of the sequence": (
        lambda: (_bf(1, 8, 64, 128), _bf(1, 2, 256, 128)[:, :, 64:128],
                 _bf(1, 2, 256, 128)[:, :, 64:128]), "wgmma"),
    "f32": (lambda: (_proj(1, 96, 8, 64, torch.float32),
                     _bf(1, 2, 80, 64, dtype=torch.float32),
                     _bf(1, 2, 80, 64, dtype=torch.float32)), "simt"),
    "bf16, q's base 2 bytes off": (
        lambda: (_shifted(1, 8, 96, 64), _bf(1, 2, 80, 64),
                 _bf(1, 2, 80, 64)), "simt"),
    "bf16, v's rows 72 elements apart, 4 bytes into them": (
        lambda: (_bf(1, 8, 96, 64), _bf(1, 2, 80, 64),
                 _bf(1, 2, 80, 72)[..., 2:66]), "simt"),
}


@pytest.mark.parametrize("case", list(RING_FWD_ROUTES))
def test_ring_fwd_route_and_entry(stub, case):
    """``ring_flash_fwd`` launches the entry point of ``route(q, k, v)``:
    ``ring_flash_fwd_tc`` with the offsets, the masks and q's, k's, v's
    strides, or the CUDA-core ``ring_flash_fwd`` with the dtype code besides;
    one launch, one route counted."""
    make, want = RING_FWD_ROUTES[case]
    q, k, v = make()
    assert route(q, k, v) == want
    off = torch.zeros((1, 1), dtype=torch.int32)
    o, lse = ring_flash_fwd(q, k, v, off, off, window=16, prefix_len=5)
    assert o.shape == q.shape and o.dtype == q.dtype
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    (name, args), = stub["ring_flash"].calls
    assert len(args) == len(attn_ops._RING_SIG[name][0])
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    assert args[7:13] == (b, h, hk, sq, skv, d)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    assert args[-10:-1] == strides
    if want == "wgmma":
        assert name == "ring_flash_fwd_tc"
        assert args[13:16] == (1, 16, 5)
    else:
        assert name == "ring_flash_fwd"
        assert args[13:17] == (0 if q.dtype == torch.float32 else 1, 1, 16,
                               5)
    assert ring_flash_fwd.launches == 1
    assert ring_flash_fwd.routes == {"wgmma": int(want == "wgmma"),
                                     "simt": int(want == "simt")}


# ---------------------------------------------------------------------------
# the decode head's route and entry point
# ---------------------------------------------------------------------------

HEAD_ROUTES = {
    "bf16, tied head embed.T, read in place": (
        lambda: (_bf(8, 96), _bf(1104, 96).T), "wgmma"),
    "bf16, contiguous (d, V) head": (lambda: (_bf(8, 96), _bf(96, 1104)),
                                     "wgmma"),
    "bf16, one decode row": (lambda: (_bf(1, 2048), _bf(1104, 2048).T),
                             "wgmma"),
    "bf16, x a row of a wider buffer": (
        lambda: (_bf(20, 160)[:, 32:128], _bf(1104, 96).T), "wgmma"),
    "f32, tied head": (lambda: (_bf(8, 96, dtype=torch.float32),
                                _bf(1104, 96, dtype=torch.float32).T),
                       "simt"),
    "bf16, x's base 2 bytes off": (lambda: (_shifted(8, 96),
                                            _bf(1104, 96).T), "simt"),
    "bf16, the head's base 2 bytes off": (
        lambda: (_bf(8, 96), _shifted(1104, 96).T), "simt"),
    "bf16, (d, V) head with V = 1100 (rows 2200 bytes)": (
        lambda: (_bf(8, 96), _bf(96, 1100)), "simt"),
}


@pytest.mark.parametrize("case", list(HEAD_ROUTES))
def test_head_route_and_entry(stub, case):
    """``lm_head_logits.raw`` launches the entry point of ``head_route(x,
    w)``: ``lm_head_tc`` with (R, d, V, vocab) and x's and w's strides,
    partials of one per 16 vocab rows; or the CUDA-core ``lm_head`` with the
    dtype code, partials of one per 64 columns. One launch, one route
    counted; the CE head's rule is the same function."""
    x, w = HEAD_ROUTES[case][0]()
    want = HEAD_ROUTES[case][1]
    assert head_route(x, w) == want == bwd_route(x, w)
    R, d = x.shape
    V = w.shape[1]
    logits, m, arg = lm_head_logits.raw(x, w, vocab=V - 4)
    assert logits.shape == (R, V) and m.shape == arg.shape == (R, 1)
    (name, args), = stub["lm_head"].calls
    assert len(args) == len(head_ops._SIG[name][0])
    assert args[7:11] == (R, d, V, V - 4)
    assert args[-4:-1] == (x.stride(0), w.stride(0), w.stride(1))
    if want == "wgmma":
        assert name == "lm_head_tc"
    else:
        assert name == "lm_head"
        assert args[11] == (0 if x.dtype == torch.float32 else 1)
    assert lm_head_logits.launches == 1
    assert lm_head_logits.routes == {"wgmma": int(want == "wgmma"),
                                     "simt": int(want == "simt")}


def test_head_scratch_holds_one_partial_per_16_vocab_rows(stub, monkeypatch):
    """On the tensor-core route the wrapper allocates (ceil(V / 16), R)
    partials for lm_head_tc, on the CUDA-core route (ceil(V / 64), R)."""
    shapes = []
    real_empty = torch.empty

    def empty(shape, **kw):
        shapes.append(tuple(shape))
        return real_empty(shape, **kw)

    monkeypatch.setattr(head_ops.torch, "empty", empty)
    lm_head_logits.raw(_bf(8, 96), _bf(1104, 96).T, vocab=1000)
    lm_head_logits.raw(_bf(8, 96, dtype=torch.float32),
                       _bf(1104, 96, dtype=torch.float32).T, vocab=1000)
    assert shapes[3:5] == [(69, 8), (69, 8)]
    assert shapes[8:10] == [(18, 8), (18, 8)]


def test_cpu_calls_count_no_route():
    """On CPU tensors both wrappers run their plain versions: neither the
    launch count nor either route moves."""
    reset_launches()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8, 32).astype("float32")).to(BF)
    w = torch.from_numpy(rng.randn(96, 32).astype("float32")).to(BF).T
    lm_head_logits.raw(x, w, vocab=90)
    q, k, v = (torch.from_numpy(rng.randn(1, h, 24, 64).astype("float32"))
               .to(BF) for h in (4, 2, 2))
    off = torch.zeros((1, 1), dtype=torch.int32)
    ring_flash_fwd(q, k, v, off, off)
    for fn in (lm_head_logits, ring_flash_fwd):
        assert fn.launches == 0
        assert fn.routes == {"wgmma": 0, "simt": 0}


# ---------------------------------------------------------------------------
# the plain ring forward against the JAX ring step at the replay's pairs
# ---------------------------------------------------------------------------

# (q_start, k_start, masks) of a shard of 96 queries against a chunk of 80
# keys: the kinds of (rank, step) pair a causal ring replays
RING_PAIRS = {
    "fully visible (a chunk before the shard)": (200, 0, {}),
    "diagonal": (0, 0, {}),
    "fully masked (a chunk after the shard)": (0, 120, {}),
    "a chunk after the shard, seen through a prefix": (0, 120,
                                                       dict(prefix_len=150)),
    "window across the chunk": (100, 40, dict(window=48)),
}


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("pair", list(RING_PAIRS))
def test_ring_fwd_ref_matches_jax_ring_step(pair, d):
    """``ring_fwd_ref`` against the JAX ring step (``ring_flash.raw``, the
    Pallas kernel in interpret mode) on the same f32 numpy inputs, GQA 4,
    at the pair's offsets: o and lse within 1e-5; rows that see no key give
    o = 0 and lse = -inf on both sides."""
    qs, ks, kw = RING_PAIRS[pair]
    rng = np.random.RandomState(d + len(pair))
    sq, skv, h, hk = 96, 80, 8, 2
    q = rng.randn(1, h, sq, d).astype("float32")
    k = rng.randn(1, hk, skv, d).astype("float32")
    v = rng.randn(1, hk, skv, d).astype("float32")
    qst = np.array([[qs]], np.int32)
    kst = np.array([[ks]], np.int32)
    jo, jlse = jax_ring.ring_flash.raw(
        q, k, v, q_start=qst, k_start=kst, causal=True,
        window=kw.get("window"), prefix_len=kw.get("prefix_len", 0),
        block_q=32, block_kv=16, backend="pallas", interpret=True)
    o, lse = ring_fwd_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                          torch.from_numpy(qst), torch.from_numpy(kst), **kw)
    jo, jlse = torch.from_numpy(np.array(jo)), torch.from_numpy(
        np.array(jlse)).reshape(lse.shape)
    dead = torch.isneginf(lse)
    assert torch.equal(dead, torch.isneginf(jlse))
    torch.testing.assert_close(o, jo, **EXACT)
    torch.testing.assert_close(lse[~dead], jlse[~dead], **EXACT)
    assert (o[dead] == 0).all()
    if "fully masked" in pair:
        assert dead.all()
    if "fully visible" in pair or "prefix" in pair:
        assert not dead.any()


def _fwd_bf16_p(q, k, v, q_start, k_start, **kw):
    """The tensor-core ring forward's rounding, in plain PyTorch: p
    unnormalised (exp(s - row max)) rounded to bf16 before P V, the sum l
    kept in f32 from the unrounded p, o = (P V) / l rounded once to bf16."""
    from repro_torch.kernels.flash_attention.ref import _mask

    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    g = h // hk
    s = torch.matmul(q.float().reshape(b, hk, g, sq, d),
                     k.float()[:, :, None].transpose(-1, -2)) / d ** 0.5
    mask = _mask(sq, skv, causal=True, window=kw.get("window"),
                 prefix_len=kw.get("prefix_len", 0), device=q.device,
                 q_start=q_start, k_start=k_start)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m))
    l_ = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(BF).float(), v.float()[:, :, None])
    o = o / torch.where(l_ == 0, 1.0, l_)
    return o.reshape(b, h, sq, d).to(q.dtype)


@pytest.mark.parametrize("pair", list(RING_PAIRS))
def test_bf16_p_stays_within_the_card_limit(pair):
    """The limit the card holds the tensor-core ring forward to (2^-6 of
    each row's largest |o|, chip_smoke.check_flash_tc's) covers rounding p
    to bf16 before P V: the model of that rounding against ring_fwd_ref
    (p in f32) on bf16 inputs stays within it on every row. Both round o
    once to bf16, so one ulp of o (up to 2^-7 of the row) comes on top of
    p's 2^-9."""
    qs, ks, kw = RING_PAIRS[pair]
    rng = np.random.RandomState(len(pair))
    ins = [torch.from_numpy(rng.randn(1, n, s, 64).astype("float32")).to(BF)
           for n, s in ((8, 96), (2, 80), (2, 80))]
    off = (torch.full((1, 1), qs, dtype=torch.int32),
           torch.full((1, 1), ks, dtype=torch.int32))
    want, _ = ring_fwd_ref(*ins, *off, **kw)
    got = _fwd_bf16_p(*ins, *off, **kw)
    err = (got.float() - want.float()).abs()
    scale = want.float().abs().amax(-1, keepdim=True)
    assert (err <= 2 ** -6 * scale).all()


# ---------------------------------------------------------------------------
# the plain decode head against the JAX op, and the partials of the
# tensor-core route
# ---------------------------------------------------------------------------

def _head_inputs(R, seed, V=112, vocab=100, d=32):
    """x (R, d), w (d, V) f32 with columns 9, 41 and 70 equal and largest
    for every row (ties in three 16-column partials), one padded column
    larger still (past vocab, never picked)."""
    rng = np.random.RandomState(seed)
    x = np.abs(rng.randn(R, d)).astype("float32")
    w = (0.3 * rng.randn(d, V)).astype("float32")
    w[:, 9] = w[:, 41] = w[:, 70] = 1.0
    w[:, vocab + 3] = 2.0
    return x, w, vocab


@pytest.mark.parametrize("R", [1, 8, 20])
def test_logits_ref_matches_jax_lm_head_logits(R):
    """``lm_head_logits_ref`` against the JAX ``lm_head_logits.raw``
    (Pallas, interpret mode) on the same f32 inputs: logits (-1e30 past
    vocab) and row max within 1e-5, the first-occurrence argmax (column 9 of
    the three equal best) exactly."""
    x, w, vocab = _head_inputs(R, R)
    jl, jm, ja = jax_logits.raw(x, w, vocab=vocab, block_r=4, block_v=16,
                                block_k=8, backend="pallas", interpret=True)
    lg, m, arg = lm_head_logits_ref(torch.from_numpy(x), torch.from_numpy(w),
                                    vocab=vocab)
    torch.testing.assert_close(lg, torch.from_numpy(np.array(jl)), **EXACT)
    torch.testing.assert_close(m, torch.from_numpy(np.array(jm))
                               .reshape(m.shape), **EXACT)
    assert (arg == 9).all()
    assert torch.equal(arg, torch.from_numpy(np.array(ja)).reshape(
        arg.shape).to(torch.int32))
    assert (lg[:, vocab:] <= -1e29).all()


def _tc_partials(logits, vocab):
    """The tensor-core head's reduction in plain PyTorch: each 16-row
    partial of the vocab gives each decode row its (max, first argmax) over
    the columns < vocab (-inf past vocab), and the partials fold by the
    larger max, then the smaller index (lm_head_reduce)."""
    R, V = logits.shape
    best = torch.full((R,), float("-inf"))
    arg = torch.full((R,), 2 ** 31 - 1, dtype=torch.int64)
    for p0 in range(0, V, PART_ROWS):
        cols = torch.arange(p0, min(p0 + PART_ROWS, V))
        part = logits[:, cols].masked_fill(cols >= vocab, float("-inf"))
        pm, pi = part.max(-1)            # the first of equal maxima
        pi = cols[pi]
        win = (pm > best) | ((pm == best) & (pi < arg))
        best, arg = torch.where(win, pm, best), torch.where(win, pi, arg)
    return best[:, None], arg.to(torch.int32)[:, None]


@pytest.mark.parametrize("R", [1, 8, 20])
def test_tc_partials_give_the_plain_max_and_argmax(R):
    """Folding 16-row partials by the larger-max, smaller-index rule gives
    lm_head_logits_ref's row max and first-occurrence argmax, with equal
    best columns in different partials and a larger padded column."""
    x, w, vocab = _head_inputs(R, 100 + R)
    lg, m, arg = lm_head_logits_ref(torch.from_numpy(x), torch.from_numpy(w),
                                    vocab=vocab)
    pm, parg = _tc_partials(lg, vocab)
    torch.testing.assert_close(pm, m, **EXACT)
    assert torch.equal(parg, arg) and (arg == 9).all()
