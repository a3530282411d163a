"""The split-KV flash_decode and the time-parallel ssm_scan, on the CPU.

* ``decode_split_ref`` is the plain model of what ``csrc/flash_decode.cu``
  computes: the cache's slots cut into ranges of ``split``, ranges wholly
  past q_pos or below the window skipped while the cache is unwrapped, f32
  partials (m, l, acc) per range, merged by their maxima. It is held
  against the JAX ``flash_decode`` (its jnp oracle and the Pallas kernel in
  interpret mode) on the same seeded inputs, across split lengths: ranges
  wholly masked, windows, rotated caches before and after the wrap, rows
  with no live slot (exactly 0), head dims 112 and 256 with g * d = 2048,
  and ``kv_len`` as an int and as a one-element int32 array.
* ``decode_split`` (the kernel's split length and count) reads shapes
  only: the wrapper, run as on the card with its library stubbed, passes
  it, allocates the workspace it implies and passes a ``kv_len`` tensor by
  its pointer, never reading it (it lies on the meta device, where any
  read of its value raises); each launch is counted once.
* ``selective_scan_tiled_ref`` is the plain model of the scan kernel's
  association order (runs of 16 steps walked from zero, 8 runs a tile
  composed by a doubling scan, each run's y finished by the state entering
  it, the state carried from tile to tile). It
  is held against the JAX ``ssm_scan`` (the chunked Pallas kernel in
  interpret mode) and its sequential oracle at L and dm off the kernel's
  tile, n 4, 8 and 16, with and without h0.

Tolerances: f32 throughout; 1e-4 for attention (softmax sums in another
order), 1e-5 for the scan (the same recurrence composed in another order;
|y| <~ 15 here).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import decode_ref as jax_decode_ref
from repro.kernels.ssm_scan import selective_scan_ref as jax_scan_ref
from repro.kernels.ssm_scan import ssm_scan_pallas as jax_scan_pallas

from repro_torch.kernels import reset_launches
from repro_torch.kernels.flash_attention import (decode_split,
                                                 decode_split_ref,
                                                 flash_decode,
                                                 rolling_slot_pos)
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.ssm_scan import (selective_scan_ref,
                                          selective_scan_tiled_ref)

MM = dict(rtol=1e-4, atol=1e-4)
EW = dict(rtol=1e-5, atol=1e-5)
BF = torch.bfloat16


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# the split-and-merge model against the JAX flash_decode
# ---------------------------------------------------------------------------

DECODE_CASES = {  # b, h, hk, d, skv, kv_len, window, rotated after t, bkv
    "ranges past q_pos": (2, 8, 2, 32, 200, 40, None, None, 40),
    "ranges below the window": (2, 4, 2, 32, 160, 150, 20, None, 32),
    "rolling cache before the wrap": (2, 4, 2, 32, 64, 50, 64, 50, 16),
    "wrapped, window under the cache": (2, 8, 2, 32, 96, 517, 40, 517, 32),
    "no live slot": (2, 4, 2, 32, 64, 30, None, "empty", 16),
    "d 112": (2, 4, 4, 112, 64, 50, None, None, 32),
    "paligemma d 256, g 8": (2, 8, 1, 256, 96, 80, None, None, 32),
    "d 256 wrapped": (1, 8, 1, 256, 64, 90, 64, 90, 32),
}


@functools.lru_cache(maxsize=None)
def _decode(case):
    """Seeded inputs (numpy), and the JAX oracle's and Pallas kernel's o
    (the kernel's with kv_len as an int32 array, as a traced scalar)."""
    b, h, hk, d, skv, kv_len, window, t, bkv = DECODE_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((b, h, 1, d), np.float32)
    k = rng.standard_normal((b, hk, skv, d), np.float32)
    v = rng.standard_normal((b, hk, skv, d), np.float32)
    sp = (None if t is None else np.full(skv, -1, np.int32) if t == "empty"
          else rolling_slot_pos(skv, t).numpy())
    args = [jnp.asarray(a) for a in (q, k, v)]
    kw = dict(window=window, slot_pos=None if sp is None else jnp.asarray(sp))
    want = np.asarray(jax_decode_ref(*args, kv_len=kv_len, **kw))
    pallas = np.asarray(jax_decode(*args, kv_len=jnp.asarray(kv_len,
                                                             jnp.int32),
                                   block_kv=bkv, backend="pallas", **kw))
    return (q, k, v, sp), want, pallas


@pytest.mark.parametrize("split", [32, 64, 512, 7])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_split_model_matches_jax_flash_decode(case, split):
    """Every split length gives the JAX op's o: 32 (the kernel's smallest),
    64, 512 (one range), 7 (off the 32-slot tile); kv_len as an int and as
    a one-element int32 tensor; rows with no live slot exactly 0."""
    (q, k, v, sp), want, pallas = _decode(case)
    _, _, _, _, _, kv_len, window, _, _ = DECODE_CASES[case]
    kw = dict(window=window, slot_pos=None if sp is None else _t(sp),
              split=split)
    got = decode_split_ref(_t(q), _t(k), _t(v), kv_len=kv_len, **kw).numpy()
    np.testing.assert_allclose(got, want, **MM)
    np.testing.assert_allclose(got, pallas, **MM)
    dev_len = torch.tensor([kv_len], dtype=torch.int32)
    assert torch.equal(decode_split_ref(_t(q), _t(k), _t(v), kv_len=dev_len,
                                        **kw), _t(got))
    if case == "no live slot":
        assert (got == 0).all()


def test_decode_split_model_skips_whole_ranges_exactly():
    """A range wholly past q_pos or wholly below the window (cache
    unwrapped) adds nothing: NaN in its keys and values leaves every bit,
    as in the kernel, which never reads them."""
    for case in ("ranges past q_pos", "ranges below the window"):
        (q, k, v, _), _, _ = _decode(case)
        _, _, _, _, skv, kv_len, window, _, _ = DECODE_CASES[case]
        kw = dict(kv_len=kv_len, window=window, split=32)
        base = decode_split_ref(_t(q), _t(k), _t(v), **kw)
        dead = [s for s in range(0, skv, 32)
                if s > kv_len - 1 or (window is not None and
                                      kv_len - 1 - min(s + 31, skv - 1)
                                      >= window)]
        assert dead
        kn, vn = k.copy(), v.copy()
        for s in dead:
            kn[:, :, s:s + 32], vn[:, :, s:s + 32] = np.nan, np.nan
        assert torch.equal(decode_split_ref(_t(q), _t(kn), _t(vn), **kw),
                           base)


def test_flash_decode_plain_takes_kv_len_as_a_tensor():
    """On the CPU flash_decode's plain version takes kv_len as a
    one-element int32 tensor and gives the int's bits."""
    (q, k, v, sp), want, _ = _decode("wrapped, window under the cache")
    kw = dict(window=40, slot_pos=_t(sp))
    got = flash_decode(_t(q), _t(k), _t(v), kv_len=517, **kw)
    np.testing.assert_allclose(got.numpy(), want, **MM)
    assert torch.equal(flash_decode(
        _t(q), _t(k), _t(v), kv_len=torch.tensor([517], dtype=torch.int32),
        **kw), got)


# ---------------------------------------------------------------------------
# the split rule and the decode wrapper's launch (library stubbed)
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


@pytest.mark.parametrize("b,hk,skv,want", [
    (8, 24, 576, (128, 5)),       # musicgen's decode step: 960 blocks
    (8, 1, 576, (64, 9)),         # paligemma's MQA: the 64-slot floor
    (8, 32, 576, (128, 5)),       # zamba2's shared attention (d 112)
    (64, 8, 100000, (512, 196)),  # the 512-slot cap
    (3, 2, 10, (64, 1)),          # a cache shorter than one range
    (2, 2, 1000, (64, 16)),
])
def test_decode_split_rule(b, hk, skv, want):
    """Powers of two in [64, 512] covering skv slots, ~8 x 132 blocks in
    all where the cache allows."""
    split, nsplit = decode_split(b, hk, skv)
    assert (split, nsplit) == want
    assert split & (split - 1) == 0 and 64 <= split <= 512
    assert (nsplit - 1) * split < skv <= nsplit * split


@pytest.fixture
def decode_stub(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(attn_ops, "on_cpu", lambda name, *ts: False)
    monkeypatch.setattr(attn_ops, "load", lambda name, sig: lib)
    monkeypatch.setattr(attn_ops, "stream", lambda: 0)
    monkeypatch.setattr(attn_ops, "_DECODE_ENTRY", None)
    empties = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        dims = shape[0] if len(shape) == 1 and not isinstance(
            shape[0], int) else shape
        empties.append((tuple(dims), kw.get("dtype")))
        return real_empty(*shape, **kw)

    monkeypatch.setattr(attn_ops.torch, "empty", empty)
    reset_launches()
    return lib, empties


@pytest.mark.parametrize("h,hk,d,skv", [(24, 24, 64, 576), (8, 1, 256, 576),
                                        (32, 32, 112, 300),
                                        (16, 1, 128, 40)])
def test_decode_wrapper_reads_kv_len_on_the_device(decode_stub, h, hk, d,
                                                   skv):
    """As on the card (stubbed library): with kv_len a tensor on the meta
    device (any read of its value raises) the wrapper passes its pointer
    and 0 in place of the int, the rule's split, a workspace of b * h *
    nsplit * (d + 2) f32, and counts one launch; with an int it passes the
    int and a null pointer."""
    lib, empties = decode_stub
    b = 8
    q = torch.empty((b, 1, h, d), dtype=BF).transpose(1, 2)   # strided
    k = torch.empty((b, hk, skv, d), dtype=BF)
    kv_len = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(Exception):
        int(kv_len)
    o = flash_decode(q, k, k, kv_len=kv_len, window=100)
    assert o.shape == (b, h, 1, d) and o.dtype == BF
    assert flash_decode.launches == 1
    o = flash_decode(q, k, k, kv_len=skv - 3)
    assert flash_decode.launches == 2
    split, nsplit = decode_split(b, hk, skv)
    (n1, a1), (n2, a2) = lib.calls
    assert n1 == n2 == "flash_decode"
    assert a1[4] == kv_len.data_ptr() and a2[4] is None
    assert a1[3] is None and a2[3] is None                    # no slot_pos
    assert a1[7:17] == (b, h, hk, skv, d, 1, 0, 100, split, d ** -0.5)
    assert a2[7:17] == (b, h, hk, skv, d, 1, skv - 3, 0, split, d ** -0.5)
    assert a1[17:23] == (q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                         k.stride(0), k.stride(1))
    assert empties.count(((b * h * nsplit * (d + 2),), torch.float32)) == 2


def test_decode_wrapper_checks_kv_len(decode_stub):
    """A kv_len tensor must be one int32 element; tensors on two devices
    raise before any launch (the real device rule)."""
    q = torch.empty((2, 4, 1, 64), dtype=BF)
    k = torch.empty((2, 2, 64, 64), dtype=BF)
    for bad in (torch.zeros(2, dtype=torch.int32),
                torch.zeros(1, dtype=torch.int64)):
        with pytest.raises(ValueError, match="kv_len"):
            flash_decode(q, k, k, kv_len=bad.to("meta"))
    assert flash_decode.launches == 0


def test_decode_wrapper_refuses_mixed_devices():
    """A kv_len tensor on another device than q, k, v is refused by the
    wrappers' one device rule (here: the CPU and the meta device)."""
    q = torch.zeros((2, 4, 1, 64))
    k = torch.zeros((2, 2, 64, 64))
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_decode(q, k, k, kv_len=torch.zeros(1, dtype=torch.int32,
                                                 device="meta"))


@pytest.mark.parametrize("d,g,ok", [(256, 8, True), (112, 16, True),
                                    (256, 16, False), (48, 2, False),
                                    (32, 32, False)])
def test_decode_wrapper_domain(decode_stub, d, g, ok):
    """Head dims 32, 64, 112, 128, 256 and groups of up to 16 heads with
    g * d <= 2048 launch; others raise before the launch."""
    lib, _ = decode_stub
    q = torch.empty((1, g, 1, d), dtype=BF)
    k = torch.empty((1, 1, 64, d), dtype=BF)
    if ok:
        flash_decode(q, k, k)
        assert len(lib.calls) == 1
    else:
        with pytest.raises(ValueError, match="group|head dims"):
            flash_decode(q, k, k)
        assert not lib.calls


# ---------------------------------------------------------------------------
# the scan's association order against the JAX ssm_scan
# ---------------------------------------------------------------------------

def _scan_inputs(seed, bt, L, dm, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bt, L, dm), np.float32)
    delta = (np.log1p(np.exp(rng.standard_normal((bt, L, dm))))
             * 0.1).astype(np.float32)
    A = -(np.abs(rng.standard_normal((dm, n))) + 0.1).astype(np.float32)
    B = rng.standard_normal((bt, L, n), np.float32)
    C = rng.standard_normal((bt, L, n), np.float32)
    D = rng.standard_normal((dm,), np.float32)
    h0 = rng.standard_normal((bt, dm, n), np.float32)
    return (x, delta, A, B, C, D), h0


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("bt,L,dm,n,chunk", [(2, 129, 17, 4, 43),
                                             (1, 300, 40, 8, 60),
                                             (3, 77, 24, 16, 77),
                                             (1, 256, 16, 16, 64),
                                             (2, 1, 5, 16, 1)])
def test_tiled_scan_model_matches_jax_scan(bt, L, dm, n, chunk, with_h0):
    """y and hT of the kernel's association order against the JAX op in
    Pallas interpret mode (chunked, the state carried across chunks) and
    its sequential oracle, and against the port's plain version: L and dm
    off the 128-step, 32-channel tile, one step, whole tiles."""
    args, h0 = _scan_inputs(L + n, bt, L, dm, n)
    h0 = h0 if with_h0 else None
    y, hT = selective_scan_tiled_ref(*map(_t, args),
                                     h0=None if h0 is None else _t(h0))
    jargs = [jnp.asarray(a) for a in args]
    jh0 = None if h0 is None else jnp.asarray(h0)
    jy, jhT = jax_scan_pallas(*jargs, h0=jh0, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **EW)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jhT), **EW)
    ry, rhT = jax_scan_ref(*jargs, h0=jh0)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **EW)
    np.testing.assert_allclose(hT.numpy(), np.asarray(rhT), **EW)
    py, phT = selective_scan_ref(*map(_t, args),
                                 h0=None if h0 is None else _t(h0))
    np.testing.assert_allclose(y.numpy(), py.numpy(), **EW)
    np.testing.assert_allclose(hT.numpy(), phT.numpy(), **EW)


def test_tiled_scan_model_keeps_bf16_outputs():
    """bf16 x, B, C with f32 delta (mamba1's feed): y in bf16, hT f32,
    within one bf16 rounding of the plain version."""
    args, _ = _scan_inputs(5, 2, 150, 20, 16)
    x, delta, A, B, C, D = map(_t, args)
    x, B, C = x.to(BF), B.to(BF), C.to(BF)
    y, hT = selective_scan_tiled_ref(x, delta, A, B, C, D)
    ry, rhT = selective_scan_ref(x, delta, A, B, C, D)
    assert y.dtype == BF and hT.dtype == torch.float32
    torch.testing.assert_close(y, ry, atol=1e-2, rtol=2 ** -7)
    torch.testing.assert_close(hT, rhT, **EW)
