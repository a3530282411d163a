"""The split-KV paged decode and the CUDA rmsnorm's wrapper, on the CPU.

* ``paged_decode_split_ref`` is the plain model of what
  ``csrc/paged_decode.cu`` computes: each sequence's slots cut into ranges
  of ``split``, f32 partials (m, l, acc) per range, merged by their maxima.
  It is held against the JAX ``paged_decode_attention`` (its jnp oracle and
  the Pallas kernel in interpret mode) on the same seeded inputs, across
  split lengths: ranges wholly masked (short sequences, ranges past q_pos),
  a split that does not divide the page, wrapped caches, idle slots (exactly
  0).
* ``paged_split`` (the kernel's split length and count) reads shapes only:
  the wrapper, run as on the card with its library stubbed, passes it and
  allocates the workspace it implies, with ``kv_len`` and the block table
  on the meta device, where any read of their values would raise.
* The rmsnorm wrapper's route rule (16-byte vectors or one element a lane)
  and lean path, with the library stubbed through ``load``/``on_cpu``/
  ``stream`` as ``tests/test_torch_bwd_routes.py`` does: an autograd node
  only when a gradient is asked, each launch and route counted once.
* rmsnorm's plain version against the JAX op at every width of
  ``configs/``.

Tolerances: f32 throughout; 1e-4 for attention (softmax sums in another
order), 1e-5 for rmsnorm (elementwise after one sum).
"""

import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (
    paged_decode_attention as jax_paged, paged_decode_ref as jax_paged_ref)
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import reset_launches
from repro_torch.kernels.flash_attention import (paged_decode_attention,
                                                 paged_decode_split_ref,
                                                 paged_split)
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.rmsnorm import rmsnorm, route
from repro_torch.kernels.rmsnorm import ops as rms_ops

MM = dict(rtol=1e-4, atol=1e-4)
EW = dict(rtol=1e-5, atol=1e-5)
BF = torch.bfloat16


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# the split-and-merge model against the JAX paged decode
# ---------------------------------------------------------------------------

PAGED_CASES = {  # lens (0 = idle slot), page, n_seq_pages, g
    "ragged, ranges past q_pos": ((37, 3, 0, 12), 5, 8, 2),
    "page 4, one-token and idle slots": ((64, 1, 0, 33), 4, 16, 1),
    "wrapped caches": ((23, 57, 0, 20), 5, 4, 4),
    "page 16, g 8": ((96, 50, 17, 0), 16, 6, 8),
}


@functools.lru_cache(maxsize=None)
def _paged(case):
    """Seeded inputs (numpy) and the JAX ref's and Pallas kernel's o."""
    lens, page, nsp, g = PAGED_CASES[case]
    rng = np.random.default_rng(len(case))
    b, hk, d, cap = len(lens), 2, 32, nsp * page
    npages = b * nsp + 1
    q = rng.standard_normal((b, hk * g, 1, d), np.float32)
    kp = rng.standard_normal((npages, hk, page, d), np.float32)
    vp = rng.standard_normal((npages, hk, page, d), np.float32)
    table = rng.permutation(np.arange(1, npages)).reshape(b, nsp)
    table = table.astype(np.int32)
    pos = np.full((npages, page), -1, np.int32)
    for bi, n in enumerate(lens):
        if n == 0:
            table[bi] = 0
            continue
        for j in range(nsp):           # slot l: the newest position = l mod cap
            ar = np.arange(j * page, (j + 1) * page)
            p = ar + np.maximum((n - 1 - ar) // cap, 0) * cap
            pos[table[bi, j]] = np.where(p < n, p, -1)
    kv_len = np.array(lens, np.int32)
    args = [jnp.asarray(a) for a in (q, kp, vp)]
    kw = dict(block_table=jnp.asarray(table), kv_len=jnp.asarray(kv_len),
              pos_pages=jnp.asarray(pos))
    want = np.asarray(jax_paged_ref(*args, **kw))
    pallas = np.asarray(jax_paged(*args, backend="pallas", **kw))
    return (q, kp, vp, table, kv_len, pos), want, pallas


@pytest.mark.parametrize("split", [32, 7, 16])
@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_split_model_matches_jax_paged_decode(case, split):
    """Every split length gives the JAX op's o: 32 (the kernel's smallest),
    7 (divides no page here), 16; idle slots exactly 0."""
    (q, kp, vp, table, kv_len, pos), want, pallas = _paged(case)
    got = paged_decode_split_ref(_t(q), _t(kp), _t(vp),
                                 block_table=_t(table), kv_len=_t(kv_len),
                                 pos_pages=_t(pos), split=split).numpy()
    np.testing.assert_allclose(got, want, **MM)
    np.testing.assert_allclose(got, pallas, **MM)
    lens = PAGED_CASES[case][0]
    for bi, n in enumerate(lens):
        if n == 0:
            assert (got[bi] == 0).all()


def test_split_model_masks_whole_ranges_exactly():
    """A range past q_pos (unwrapped) adds nothing: the one-token sequence
    of the page-4 case gives the same bits with its later ranges' keys and
    values replaced by NaN, as the kernel, which never reads them."""
    (q, kp, vp, table, kv_len, pos), _, _ = _paged(
        "page 4, one-token and idle slots")
    page = PAGED_CASES["page 4, one-token and idle slots"][1]
    kw = dict(block_table=_t(table), kv_len=_t(kv_len), pos_pages=_t(pos),
              split=32)
    base = paged_decode_split_ref(_t(q), _t(kp), _t(vp), **kw)
    later = table[1, 32 // page:]              # sequence 1's pages past slot 32
    kn, vn = kp.copy(), vp.copy()
    kn[later], vn[later] = np.nan, np.nan
    got = paged_decode_split_ref(_t(q), _t(kn), _t(vn), **kw)
    assert torch.equal(got[1], base[1])


# ---------------------------------------------------------------------------
# the split rule and the paged wrapper's launch (library stubbed)
# ---------------------------------------------------------------------------

class _Lib:
    """A stand-in for a kernel library: records each entry point's call and
    returns 0 (no CUDA error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("b,hk,nsp,page,want", [
    (8, 8, 4, 512, (64, 32)),      # the serving path: 2048 blocks
    (3, 2, 4, 352, (32, 44)),
    (3, 2, 4, 4, (32, 1)),         # a cache shorter than one tile
    (64, 8, 4, 512, (416, 5)),     # many sequences: long ranges
    (256, 8, 4, 512, (512, 4)),    # the 512-slot cap
    (1, 1, 64, 512, (32, 1024)),
])
def test_paged_split_rule(b, hk, nsp, page, want):
    """Splits of whole 32-slot tiles in [32, 512] covering nsp * page
    slots, ~16 x 132 blocks in all where the cache allows."""
    split, nsplit = paged_split(b, hk, nsp, page)
    assert (split, nsplit) == want
    assert split % 32 == 0 and 32 <= split <= 512
    assert (nsplit - 1) * split < nsp * page <= nsplit * split


def test_paged_wrapper_reads_shapes_only(monkeypatch):
    """As on the card (stubbed library): one launch with the rule's split,
    a workspace of b * h * nsplit * (d + 2) f32, and kv_len and the block
    table never read on the host (they live on the meta device here)."""
    lib = _Lib()
    monkeypatch.setattr(attn_ops, "on_cpu", lambda name, *ts: False)
    monkeypatch.setattr(attn_ops, "load", lambda name, sig: lib)
    monkeypatch.setattr(attn_ops, "stream", lambda: 0)
    empties = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        dims = shape[0] if len(shape) == 1 and not isinstance(
            shape[0], int) else shape
        empties.append((tuple(dims), kw.get("dtype")))
        return real_empty(*shape, **kw)

    monkeypatch.setattr(attn_ops.torch, "empty", empty)
    reset_launches()
    b, h, hk, d, page, nsp, npages = 8, 32, 8, 64, 512, 4, 33
    q = real_empty((b, h, 1, d), dtype=BF)
    kp = real_empty((npages, hk, page, d), dtype=BF)
    meta = dict(dtype=torch.int32, device="meta")
    o = paged_decode_attention(
        q, kp, kp, block_table=real_empty((b, nsp), **meta),
        kv_len=real_empty((b,), **meta),
        pos_pages=real_empty((npages, page), dtype=torch.int32))
    assert o.shape == (b, h, 1, d) and o.dtype == BF
    (name, args), = lib.calls
    split, nsplit = paged_split(b, hk, nsp, page)
    assert name == "paged_decode"
    assert args[8:17] == (b, h, hk, page, nsp, split, d, 1, d ** -0.5)
    assert ((b * h * nsplit * (d + 2),), torch.float32) in empties
    assert paged_decode_attention.launches == 1


# ---------------------------------------------------------------------------
# rmsnorm: the route rule and the lean path (library stubbed)
# ---------------------------------------------------------------------------

@pytest.fixture
def rms_stub(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(rms_ops, "on_cpu", lambda name, *ts: False)
    monkeypatch.setattr(rms_ops, "load", lambda name, sig: lib)
    monkeypatch.setattr(rms_ops, "stream", lambda: ctypes.c_void_p(0))
    monkeypatch.setattr(rms_ops, "_ENTRY", None)
    reset_launches()
    return lib


def _shifted(n, dtype, by=1):
    """n elements whose base lies ``by`` elements past an aligned one."""
    return torch.zeros(n + by, dtype=dtype)[by:]


RMS_ROUTES = {  # x2 (rows, d), w, route
    "bf16 decode rows": (lambda: torch.zeros(8, 2048, dtype=BF),
                         lambda: torch.ones(2048), "vec"),
    "bf16 rows of a wider buffer (stride 2056)": (
        lambda: torch.zeros(8, 2056, dtype=BF)[:, :2048],
        lambda: torch.ones(2048), "vec"),
    "bf16 stride 2049": (lambda: torch.zeros(8, 2049, dtype=BF)[:, :2048],
                         lambda: torch.ones(2048), "elem"),
    "bf16 d 47": (lambda: torch.zeros(5, 47, dtype=BF),
                  lambda: torch.ones(47), "elem"),
    "bf16 d 6144": (lambda: torch.zeros(3, 6144, dtype=BF),
                    lambda: torch.ones(6144, dtype=BF), "vec"),
    "f32 d 4096 (32 vectors a lane)": (lambda: torch.zeros(3, 4096),
                                       lambda: torch.ones(4096), "vec"),
    "f32 d 6144 (48 vectors a lane)": (lambda: torch.zeros(3, 6144),
                                       lambda: torch.ones(6144), "elem"),
    "bf16 x 2 bytes off": (lambda: _shifted(8 * 64, BF).view(8, 64),
                           lambda: torch.ones(64), "elem"),
    "f32 x, bf16 w 8 bytes off": (
        lambda: torch.zeros(4, 64), lambda: _shifted(64, BF, by=4), "vec"),
    "bf16 x, f32 w 4 bytes off": (
        lambda: torch.zeros(4, 64, dtype=BF),
        lambda: _shifted(64, torch.float32), "elem"),
}


@pytest.mark.parametrize("case", list(RMS_ROUTES))
def test_rmsnorm_route_and_launch(rms_stub, case):
    """The layout picks the variant; the wrapper passes it with rows, d,
    the row stride and the dtype codes, and counts one launch on its
    route."""
    mx, mw, want = RMS_ROUTES[case]
    x, w = mx(), mw()
    assert route(x, w) == want
    out = rmsnorm(x, w, eps=1e-5)
    assert out.shape == x.shape and out.dtype == x.dtype
    (name, args), = rms_stub.calls
    assert name == "rmsnorm"
    assert bool(args[0]) == (want == "vec")
    assert args[4:9] == (x.shape[0], x.shape[1], x.stride(0),
                         int(x.dtype == BF), int(w.dtype == BF))
    assert rmsnorm.launches == 1
    assert rmsnorm.routes == {"vec": int(want == "vec"),
                              "elem": int(want == "elem")}


def test_rmsnorm_records_a_graph_only_when_a_gradient_is_asked(rms_stub):
    x, w = torch.zeros(3, 5, 64, dtype=BF), torch.ones(64)
    assert rmsnorm(x, w).grad_fn is None
    xg = x.clone().requires_grad_()
    assert rmsnorm(xg, w).grad_fn is not None
    assert rmsnorm(x, w.clone().requires_grad_()).grad_fn is not None
    with torch.no_grad():
        assert rmsnorm(xg, w).grad_fn is None
    assert rmsnorm.launches == len(rms_stub.calls) == 4
    assert rmsnorm.routes == {"vec": 4, "elem": 0}


def test_rmsnorm_takes_rows_of_any_rank(rms_stub):
    """(..., d): a contiguous x launches on its own rows (stride d); a
    strided one on rows whose last axis is contiguous; either way one
    launch and x's shape out."""
    x = torch.zeros(3, 5, 64, dtype=BF)
    assert rmsnorm(x, torch.ones(64)).shape == (3, 5, 64)
    xt = torch.zeros(5, 3, 64, dtype=BF).transpose(0, 1)
    assert rmsnorm(xt, torch.ones(64)).shape == (3, 5, 64)
    (_, a1), (_, a2) = rms_stub.calls
    assert a1[4:7] == (15, 64, 64) and a2[4:7] == (15, 64, 64)
    with pytest.raises(ValueError, match="last axis"):
        rmsnorm(torch.zeros(64, 4, dtype=BF).T, torch.ones(64))
    assert rmsnorm.launches == 2


# ---------------------------------------------------------------------------
# rmsnorm's plain version against the JAX op at every width of configs/
# ---------------------------------------------------------------------------

WIDTHS = sorted({get_config(a).d_model for a in ARCHS})


@pytest.mark.parametrize("d", WIDTHS)
def test_rmsnorm_plain_matches_jax_at_config_widths(d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((5, d), np.float32) * 3
    w = rng.standard_normal((d,), np.float32)
    got = rmsnorm(_t(x), _t(w), eps=1e-5).numpy()
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    np.testing.assert_allclose(got, np.asarray(jax_rmsnorm_ref(
        jx, jw, eps=1e-5)), **EW)
    np.testing.assert_allclose(got, np.asarray(jax_rmsnorm(
        jx, jw, eps=1e-5, block_rows=4, backend="pallas")), **EW)
