"""The tensor-core routes of the CE-head forward (``lm_head_ce.raw``) and
of ``flash_bwd``, on the CPU.

* The route rules are pure functions of dtype, strides and alignment. The
  wrappers' choice of entry point is held here with the library stubbed
  (``load`` returns a recorder, ``on_cpu`` says "card"): bf16 with 16-byte
  rows takes the tensor-core entry (``lm_head_ce_fwd_tc``,
  ``flash_bwd_tc``), f32 and unaligned bf16 the CUDA-core one, windows
  and head dim 128 included; each call counts its route. CPU calls run the
  plain versions and count nothing.
* The tensor-core CE forward reduces each 256-column tile of a row to (max,
  sum of exp, label logit) and merges the tiles, skipping those wholly past
  ``vocab``: a plain model of that (``_tiled_ce_stats``) is held against
  ``lm_head_ce_stats_ref`` and the JAX ``lm_head_ce`` (Pallas, interpret
  mode) on the same seeded inputs.
* ``flash_bwd_ref`` with a window, at head dims 64 and 128, against the JAX
  ``flash_attention_bwd(window=...)`` (Pallas, interpret mode); a windowed
  ``flash_attention`` differentiates on the CPU like the JAX oracle; on the
  card (stubbed) its forward runs once and its backward reaches the entry
  point of the route q, k, v take, on either route.

Tolerances: f32 throughout; 1e-5 where both sides compute the same sums in
another order at these sizes (d <= 128, V <= 1100), 1e-4 for the backward's
products and for gradients through the JAX oracle.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import mha_ref as jax_mha_ref
from repro.kernels.flash_attention.kernel import \
    flash_attention_bwd as jax_flash_bwd
from repro.kernels.lm_head import lm_head_ce as jax_ce

from repro_torch.kernels import reset_launches
from repro_torch.kernels.flash_attention import (flash_attention, flash_bwd,
                                                 flash_bwd_ref,
                                                 flash_delta_ref,
                                                 flash_fwd_ref, route)
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.lm_head import (bwd_route, lm_head_ce,
                                         lm_head_ce_stats_ref)
from repro_torch.kernels.lm_head import ops as head_ops

BF = torch.bfloat16
TN = 256            # the CE forward's tile width on the tensor-core route
EXACT = dict(rtol=1e-5, atol=1e-5)
MM = dict(rtol=1e-4, atol=1e-4)


def _np(t):
    return t.detach().cpu().numpy()


class _Lib:
    """A stand-in for a kernel library: records which entry point was
    called and with what, returns 0 (no CUDA error)."""

    def __init__(self, tiles=None):
        self.calls = []
        self.tiles = tiles or {}

    def __getattr__(self, name):
        if name in self.tiles:
            return self.tiles[name]

        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def stub(monkeypatch):
    """Both wrappers as they run on the card, with their libraries
    replaced by recorders."""
    libs = {"lm_head_ce": _Lib({"lm_head_ce_tc_tiles": lambda V: -(-V // TN),
                                "lm_head_ce_splits": lambda V: 2}),
            "flash_bwd": _Lib()}
    for mod in (head_ops, attn_ops):
        monkeypatch.setattr(mod, "on_cpu", lambda name, *ts: False)
        monkeypatch.setattr(mod, "load", lambda name, sig: libs[name])
        monkeypatch.setattr(mod, "stream", lambda: ctypes.c_void_p(0))
    reset_launches()
    return libs


# ---------------------------------------------------------------------------
# the route rules and the wrappers' entry points
# ---------------------------------------------------------------------------

def _bf(*shape):
    return torch.zeros(shape, dtype=BF)


def _shifted(*shape, dtype=BF):
    """A tensor whose base is one element past an aligned address."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(*shape)


CE_FWD_ROUTES = {
    "bf16, tied head embed.T": (lambda: (_bf(67, 96), _bf(200, 96).T),
                                "wgmma"),
    "bf16, untied (d, V) head": (lambda: (_bf(67, 96), _bf(96, 200)),
                                 "wgmma"),
    "f32, tied head": (lambda: (_bf(67, 96).float(),
                                _bf(200, 96).float().T), "simt"),
    "bf16, x's base 2 bytes off": (lambda: (_shifted(67, 96),
                                            _bf(200, 96).T), "simt"),
    "bf16, d = 90 (rows 180 bytes)": (lambda: (_bf(67, 90), _bf(200, 90).T),
                                      "simt"),
}


@pytest.mark.parametrize("case", list(CE_FWD_ROUTES))
def test_ce_forward_takes_the_backward_route(stub, case):
    """``lm_head_ce.raw`` launches the entry point of ``bwd_route(x, w)``:
    the tensor-core forward with (R, d, V, vocab) and x's and w's strides,
    partials of ceil(V / 256) tiles; or the CUDA-core forward. One launch,
    one route counted."""
    x, w = CE_FWD_ROUTES[case][0]()
    want = CE_FWD_ROUTES[case][1]
    assert bwd_route(x, w) == want
    labels = torch.zeros((x.shape[0], 1), dtype=torch.int32)
    lse, gold = lm_head_ce.raw(x, w, labels, vocab=190)
    assert lse.shape == gold.shape == (x.shape[0], 1)
    (name, args), = stub["lm_head_ce"].calls
    assert name == ("lm_head_ce_fwd_tc" if want == "wgmma"
                    else "lm_head_ce_fwd")
    assert args[6:10] == (x.shape[0], x.shape[1], 200, 190)
    assert args[-4:-1] == (x.stride(0), w.stride(0), w.stride(1))
    assert lm_head_ce.launches == 1
    assert lm_head_ce.routes == {"wgmma": int(want == "wgmma"),
                                 "simt": int(want == "simt")}


def _qkv(d, dtype=BF, *, s=40, views=True):
    """q, k, v, do as the attention layer's projections give them (views
    (B, S, H, D) -> (B, H, S, D)) or contiguous."""
    def one(h):
        t = torch.zeros((1, s, h, d), dtype=dtype).transpose(1, 2)
        return t if views else t.contiguous()
    return one(4), one(2), one(2), one(4)


FLASH_BWD_ROUTES = {
    # (d, dtype, views, shift do, window, route or the error it raises)
    "bf16 views d 64": (64, BF, True, False, None, "wgmma"),
    "bf16 contiguous d 128, window": (128, BF, False, False, 16, "wgmma"),
    "bf16 views d 32, window": (32, BF, True, False, 5, "wgmma"),
    "f32 d 64": (64, torch.float32, True, False, None, "simt"),
    "bf16 do 2 bytes off, d 64": (64, BF, True, True, None, "simt"),
    "f32 d 128": (128, torch.float32, True, False, None, "simt"),
    "f32 d 64, window": (64, torch.float32, True, False, 8, "simt"),
    "bf16 do 2 bytes off, window": (64, BF, True, True, 8, "simt"),
}


@pytest.mark.parametrize("case", list(FLASH_BWD_ROUTES))
def test_flash_bwd_route_and_entry(stub, case):
    """``flash_bwd`` launches the entry point of ``route(q, k, v, do)``:
    ``flash_bwd_tc`` or the CUDA-core ``flash_bwd``, each with the head
    dims, the masks (the window too, on both routes since the CUDA-core
    kernel has one) and the strides of all four inputs."""
    d, dtype, views, shift, window, want = FLASH_BWD_ROUTES[case]
    q, k, v, do = _qkv(d, dtype, views=views)
    if shift:
        do = _shifted(*do.shape, dtype=dtype)
    lse = torch.zeros(q.shape[:3])
    if want not in ("wgmma", "simt"):
        with pytest.raises(ValueError, match=want):
            flash_bwd(q, k, v, do, lse, lse, window=window)
        assert stub["flash_bwd"].calls == [] and flash_bwd.launches == 0
        return
    assert route(q, k, v, do) == want
    dq, dk, dv = flash_bwd(q, k, v, do, lse, lse, window=window)
    assert dq.dtype == dtype and dk.dtype == dv.dtype == torch.float32
    assert dk.shape == dv.shape == k.shape
    (name, args), = stub["flash_bwd"].calls
    assert len(args) == len(attn_ops._BWD_SIG[name][0])
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *do.stride()[:3])
    if want == "wgmma":
        assert name == "flash_bwd_tc"
        assert args[9:19] == (1, 4, 2, 40, 40, d, d, 1, window or 0, 0)
        assert args[20:32] == strides
    else:
        assert name == "flash_bwd"
        assert args[9:20] == (1, 4, 2, 40, 40, d, d, int(dtype == BF), 1,
                              window or 0, 0)
        assert args[-13:-1] == strides
    assert flash_bwd.launches == 1
    assert flash_bwd.routes == {"wgmma": int(want == "wgmma"),
                                "simt": int(want == "simt")}


def test_cpu_calls_count_no_route():
    """On CPU tensors both wrappers run their plain versions: neither the
    launch count nor either route moves."""
    reset_launches()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(9, 32).astype("float32")).to(BF)
    w = torch.from_numpy(rng.randn(70, 32).astype("float32")).to(BF).T
    lm_head_ce.raw(x, w, torch.zeros((9, 1), dtype=torch.int32), vocab=60)
    q, k, v, do = (torch.from_numpy(rng.randn(1, h, 24, 64)
                                    .astype("float32")).to(BF)
                   for h in (4, 2, 2, 4))
    o, lse = flash_fwd_ref(q, k, v, window=8)
    flash_bwd(q, k, v, do, lse, flash_delta_ref(do, o), window=8)
    for fn in (lm_head_ce, flash_bwd):
        assert fn.launches == 0
        assert fn.routes == {"wgmma": 0, "simt": 0}


# ---------------------------------------------------------------------------
# the tiled CE forward: per-tile partials and the merge
# ---------------------------------------------------------------------------

def _tiled_ce_stats(x, w, labels, vocab, tn=TN):
    """What the tensor-core CE forward computes: for each tn-column tile,
    each row's (max, sum of exp(s - max), label logit) over the tile's
    columns < vocab ((-inf, 0, 0) for a tile wholly past vocab); then the
    merge of ``ce_merge_kernel``: M = max of the tile maxima, lse = M +
    log(sum of l_t exp(m_t - M) over the tiles with m_t > -inf), gold = the
    sum of the tiles' gold. f32 throughout."""
    s = torch.matmul(x.float(), w.float())
    R, V = s.shape
    lab = labels.reshape(-1).long()
    ms, ls, gs = [], [], []
    for c0 in range(0, V, tn):
        cols = torch.arange(c0, min(c0 + tn, V))
        valid = cols < vocab
        st = s[:, c0:c0 + tn].masked_fill(~valid, float("-inf"))
        m = st.amax(-1)
        safe = torch.where(torch.isinf(m), 0.0, m)
        ls.append(torch.where(valid, torch.exp(st - safe[:, None]), 0.0)
                  .sum(-1))
        hit = (lab[:, None] == cols) & valid
        gs.append(torch.where(hit, s[:, c0:c0 + tn], 0.0).sum(-1))
        ms.append(m)
    m, l, g = (torch.stack(t) for t in (ms, ls, gs))
    M = m.amax(0)
    live = ~torch.isneginf(m)
    L = torch.where(live, l * torch.exp(torch.where(live, m - M, 0.0)),
                    0.0).sum(0)
    return (M + torch.log(torch.where(L == 0, 1.0, L)))[:, None], \
        g.sum(0)[:, None]


CE_TILE_CASES = [  # R, d, V, vocab, tied
    (1, 32, 300, 300, True),
    (5, 48, 600, 250, False),     # tiles 1 and 2 wholly past vocab
    (70, 64, 1100, 1000, True),   # a ragged last tile, partly past vocab
    (130, 32, 520, 257, False),   # one true column in the second tile
]


@pytest.mark.parametrize("R,d,V,vocab,tied", CE_TILE_CASES)
def test_tiled_ce_forward_matches_stats_ref_and_jax(R, d, V, vocab, tied):
    """The per-tile model against ``lm_head_ce_stats_ref`` (lse and gold,
    1e-5: the same f32 products, exponentials summed in another order) and
    the JAX ``lm_head_ce`` (Pallas, interpret mode: the NLL lse - gold,
    1e-5). The labels include the last true column; no tile past vocab
    turns into NaN."""
    rng = np.random.default_rng(R + V)
    x = torch.from_numpy(rng.standard_normal((R, d), np.float32))
    w = torch.from_numpy(rng.standard_normal((V, d) if tied else (d, V),
                                             np.float32))
    head = w.T if tied else w
    labels = torch.from_numpy(rng.integers(0, vocab, (R, 1)).astype(np.int32))
    labels[0, 0] = vocab - 1
    lse, gold = _tiled_ce_stats(x, head, labels, vocab)
    assert torch.isfinite(lse).all() and torch.isfinite(gold).all()
    rlse, rgold = lm_head_ce_stats_ref(x, head, labels, vocab=vocab)
    torch.testing.assert_close(lse, rlse, **EXACT)
    torch.testing.assert_close(gold, rgold, **EXACT)
    nll = jax_ce(jnp.asarray(_np(x)), jnp.asarray(_np(head)),
                 jnp.asarray(_np(labels)), vocab=vocab, block_r=8,
                 block_v=16, block_k=8, backend="pallas")
    np.testing.assert_allclose(_np(lse - gold)[:, 0], np.asarray(nll),
                               **EXACT)


def test_tile_wholly_past_vocab_gives_the_merge_identity():
    """A tile with no column < vocab gives (max, sum, gold) = (-inf, 0, 0)
    and changes neither lse nor gold: the same stats as with that tile's
    columns cut off."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((6, 16), np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 3 * TN), np.float32))
    labels = torch.from_numpy(rng.integers(0, 100, (6, 1)).astype(np.int32))
    whole = _tiled_ce_stats(x, w, labels, vocab=100)
    cut = _tiled_ce_stats(x, w[:, :TN], labels, vocab=100)
    for a, b in zip(whole, cut):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the flash backward with a window
# ---------------------------------------------------------------------------

def _attn_arrays(seed, d, s=32, h=4, hk=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, n, s, d).astype("float32") for n in (h, hk, hk, h)]


@pytest.mark.parametrize("d,window", [(64, 8), (128, 20)])
def test_flash_bwd_ref_window_matches_jax(d, window):
    """``flash_bwd_ref(window=...)`` against the JAX
    ``flash_attention_bwd(window=...)`` (Pallas, interpret mode, blocks of
    16) on the same lse and o: dq, dk, dv within 1e-4 (f32 products in
    another order)."""
    q, k, v, do = _attn_arrays(d + window, d)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_fwd_ref(tq, tk, tv, causal=True, window=window)
    got = flash_bwd_ref(tq, tk, tv, tdo, lse, flash_delta_ref(tdo, o),
                        causal=True, window=window)
    want = jax_flash_bwd(*map(jnp.asarray, (q, k, v, _np(o), do, _np(lse))),
                         causal=True, window=window, block_q=16,
                         block_kv=16, backend="pallas")
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=name, **MM)


@pytest.mark.parametrize("d,window", [(64, 6), (128, 11)])
def test_windowed_flash_attention_differentiates_like_jax(d, window):
    """On the CPU a windowed ``flash_attention`` runs its autograd Function
    (``flash_bwd_ref`` with the window): o and the q, k, v gradients of
    <o, do> against jax.vjp of the JAX oracle, 1e-4."""
    q, k, v, do = _attn_arrays(7 * d + window, d)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = flash_attention(*ts, causal=True, window=window)
    grads = torch.autograd.grad(o, ts, torch.from_numpy(do))
    jo, vjp = jax.vjp(lambda a, b, c: jax_mha_ref(a, b, c, causal=True,
                                                  window=window),
                      *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(_np(o), np.asarray(jo), **MM)
    for name, a, b in zip(("dq", "dk", "dv"), grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=name, **MM)


REFUSALS = {
    # (dtype, d, window, q's base shifted): a window and head dim 128 on
    # the CUDA-core backward, and their tensor-core twins
    "f32 window": (torch.float32, 64, 8, False),
    "f32 d 128": (torch.float32, 128, None, False),
    "f32 d 64": (torch.float32, 64, None, False),
    "bf16 window": (BF, 64, 8, False),
    "bf16 d 128, window": (BF, 128, 8, False),
    "bf16 q 2 bytes off, window": (BF, 64, 8, True),
    "bf16 q 2 bytes off, d 64": (BF, 64, None, True),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_card_refuses_a_gradient_only_on_the_simt_route(monkeypatch, case):
    """On the card (stubbed: the forward kernel records its call, the delta
    and backward libraries are recorders) a gradient through
    ``flash_attention`` is refused for none of the cases the CUDA-core
    backward once could not take (a window, head dim 128): the forward runs
    once, and the backward reaches the entry point of ``route(q, k, v)``
    with the window, on either route."""
    dtype, d, window, shifted = REFUSALS[case]
    calls = []
    libs = {"flash_bwd": _Lib(), "flash_delta": _Lib()}

    def fwd(*args, **kwargs):
        calls.append(kwargs)
        return flash_fwd_ref(*args, **kwargs)

    monkeypatch.setattr(attn_ops, "on_cpu", lambda name, *ts: False)
    monkeypatch.setattr(attn_ops, "flash_attention_fwd", fwd)
    monkeypatch.setattr(attn_ops, "load", lambda name, sig: libs[name])
    monkeypatch.setattr(attn_ops, "stream", lambda: 0)
    monkeypatch.setattr(attn_ops, "_DELTA_ENTRY", None)
    reset_launches()
    q, k, v, do = _attn_arrays(d, d)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    if shifted:
        q = torch.cat([torch.zeros(1, dtype=dtype), q.reshape(-1)])[1:] \
            .view(q.shape)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    path = route(q, k, v)
    assert (path == "simt") == (dtype == torch.float32 or shifted)
    o = flash_attention(q, k, v, window=window)
    assert calls == [dict(causal=True, window=window, sm_scale=None,
                          prefix_len=0)]
    grads = torch.autograd.grad(o, (q, k, v), torch.from_numpy(do).to(dtype))
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert len(libs["flash_delta"].calls) == 1
    (name, args), = libs["flash_bwd"].calls
    assert name == {"wgmma": "flash_bwd_tc", "simt": "flash_bwd"}[path]
    masks = args[16:19] if path == "wgmma" else args[17:20]
    assert args[14:16] == (d, d) and masks == (1, window or 0, 0)
    assert flash_bwd.routes == {"wgmma": int(path == "wgmma"),
                                "simt": int(path == "simt")}
