"""The tensor-core routes of ``flash_attention_fwd`` and ``ring_flash_bwd``
on the CPU: the route rule, the ring's up-front refusal (which depends on
the inputs' dtype and layout), and the rounding model of the tensor-core
ring backward.

* ``route`` is a pure function of dtype, strides and alignment: held here on
  CPU tensors' metadata. bf16 inputs whose bases are 16-byte aligned and
  whose strides but the last are multiples of 8 elements (contiguous, or the
  projections' (B, S, H, D) -> (B, H, S, D) views) take ``"wgmma"``;
  f32, a misaligned base, a stride not a multiple of 8 take ``"simt"``.
* The tensor-core ring backward rounds p and ds to bf16 before its products:
  ``ring_bwd_tc_ref`` models that (ds once for dq; p and ds as hi/lo planes
  for dv and dk). Held against the all-f32 ``ring_bwd_ref`` and the JAX
  step's VJP (jnp) on the same seeded inputs rounded to bf16: two planes sit
  within 2^-14 of the largest |dk|, |dv|; one plane misses by far more.
"""

import jax
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ring as jax_ring

from repro_torch.kernels import reset_launches
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_delta_ref, ring_bwd_ref,
                                                 ring_bwd_tc_ref,
                                                 ring_flash_attention,
                                                 ring_flash_bwd, ring_fwd_ref,
                                                 route)
from repro_torch.kernels.flash_attention import ring as ring_mod
from repro_torch.kernels.flash_attention.ops import RING_BWD_HEAD_DIMS
from repro_torch.kernels.flash_attention.ref import _ring_p_ds

BF = torch.bfloat16


def _bf(*shape):
    return torch.zeros(shape, dtype=BF)


def _proj(b, s, h, d, dtype=BF):
    """A projection's head view: (B, S, H, D) -> (B, H, S, D)."""
    return torch.zeros((b, s, h, d), dtype=dtype).transpose(1, 2)


def _shifted(*shape):
    """A bf16 tensor whose base is 2 bytes past an aligned address."""
    n = int(np.prod(shape))
    return _bf(n + 1)[1:].view(*shape)


def _batch_stride_off8(b, h, s, d):
    """Rows contiguous, batch stride h * s * d + 4 elements (not a multiple
    of 8)."""
    n = h * s * d
    return _bf(b, n + 4)[:, :n].view(b, h, s, d)


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------

FWD_ROUTES = {
    "bf16 contiguous": (lambda: (_bf(2, 4, 70, 64), _bf(2, 2, 90, 64),
                                 _bf(2, 2, 90, 64)), "wgmma"),
    "bf16 projection views": (lambda: (_proj(2, 70, 4, 64),
                                       _proj(2, 90, 2, 64),
                                       _proj(2, 90, 2, 64)), "wgmma"),
    "bf16 d = 32 views": (lambda: (_proj(1, 9, 8, 32), _proj(1, 9, 2, 32),
                                   _proj(1, 9, 2, 32)), "wgmma"),
    "bf16 d = 128, kv a sequence slice": (
        lambda: (_bf(1, 4, 33, 128), _bf(1, 2, 100, 128)[:, :, 17:50],
                 _bf(1, 2, 100, 128)[:, :, 17:50]), "wgmma"),
    "f32": (lambda: (_bf(2, 4, 70, 64).float(), _bf(2, 2, 90, 64).float(),
                     _bf(2, 2, 90, 64).float()), "simt"),
    "f32 projection views": (lambda: (_proj(2, 70, 4, 64, torch.float32),
                                      _proj(2, 90, 2, 64, torch.float32),
                                      _proj(2, 90, 2, 64, torch.float32)),
                             "simt"),
    "bf16, q's base 2 bytes off": (lambda: (_shifted(2, 4, 70, 64),
                                            _bf(2, 2, 90, 64),
                                            _bf(2, 2, 90, 64)), "simt"),
    "bf16, v's base 2 bytes off": (lambda: (_bf(2, 4, 70, 64),
                                            _bf(2, 2, 90, 64),
                                            _shifted(2, 2, 90, 64)), "simt"),
    "bf16, k's rows 68 elements apart": (
        lambda: (_bf(2, 4, 70, 64), _bf(2, 2, 90, 68)[..., :64],
                 _bf(2, 2, 90, 64)), "simt"),
    "bf16, q's batch stride off 8": (
        lambda: (_batch_stride_off8(2, 4, 70, 64), _bf(2, 2, 90, 64),
                 _bf(2, 2, 90, 64)), "simt"),
    "bf16, k's last axis strided": (
        lambda: (_bf(2, 4, 70, 64), _bf(2, 2, 64, 90).transpose(-1, -2),
                 _bf(2, 2, 90, 64)), "simt"),
}


@pytest.mark.parametrize("case", list(FWD_ROUTES))
def test_flash_fwd_route_rule(case):
    make, want = FWD_ROUTES[case]
    assert route(*make()) == want


def _ring_bwd_inputs(do):
    q = _proj(1, 96, 8, 64)
    k, v = _bf(1, 2, 80, 64), _bf(1, 2, 80, 64)
    return q, k, v, do


RING_BWD_ROUTES = {
    "bf16, do contiguous": (lambda: _ring_bwd_inputs(_bf(1, 8, 96, 64)),
                            "wgmma"),
    "bf16, do a projection view": (
        lambda: _ring_bwd_inputs(_proj(1, 96, 8, 64)), "wgmma"),
    "bf16, do's base 2 bytes off": (
        lambda: _ring_bwd_inputs(_shifted(1, 8, 96, 64)), "simt"),
    "bf16, do's rows 72 elements apart, 4 bytes into them": (
        lambda: _ring_bwd_inputs(_bf(1, 8, 96, 72)[..., 2:66]), "simt"),
    "f32 do": (lambda: _ring_bwd_inputs(_bf(1, 8, 96, 64).float()), "simt"),
}


@pytest.mark.parametrize("case", list(RING_BWD_ROUTES))
def test_ring_bwd_route_rule(case):
    make, want = RING_BWD_ROUTES[case]
    assert route(*make()) == want


def test_routes_count_only_card_launches():
    """On CPU tensors the wrappers run their plain versions: neither the
    launch count nor either route moves."""
    reset_launches()
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rng.randn(1, h, 40, 64).astype("float32"))
                   .to(BF) for h in (4, 2, 2, 4))
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    off = torch.zeros((1, 1), dtype=torch.int32)
    ring_flash_bwd(q, k, v, do, lse, flash_delta_ref(do, o), off, off)
    for fn in (flash_attention_fwd, ring_flash_bwd):
        assert fn.launches == 0
        assert fn.routes == {"wgmma": 0, "simt": 0}


# ---------------------------------------------------------------------------
# the ring's up-front refusal on the card (the step kernels stubbed)
# ---------------------------------------------------------------------------

@pytest.fixture
def card(monkeypatch):
    """ring.py as it runs on the card, with the step kernels replaced by
    stubs: the forward runs the plain version and records that it ran, the
    backward records the cotangent it was handed and runs the plain
    version."""
    calls = {"fwd": 0, "do": []}

    def fwd(*args, **kwargs):
        calls["fwd"] += 1
        return ring_fwd_ref(*args, **kwargs)

    def bwd(q, k, v, do, *args, **kwargs):
        calls["do"].append(do)
        return ring_bwd_ref(q, k, v, do, *args, **kwargs)

    monkeypatch.setattr(ring_mod, "on_cpu", lambda name, *ts: False)
    monkeypatch.setattr(ring_mod, "ring_flash_fwd", fwd)
    monkeypatch.setattr(ring_mod, "ring_flash_bwd", bwd)
    return calls


REFUSALS = {
    # (dtype, d, q's base shifted, refused)
    "f32 d = 128": (torch.float32, 128, False, True),
    "f32 d = 64": (torch.float32, 64, False, False),
    "bf16 d = 128": (BF, 128, False, False),
    "bf16 d = 32": (BF, 32, False, False),
    "bf16 d = 128, q's base 2 bytes off": (BF, 128, True, True),
    "bf16 d = 64, q's base 2 bytes off": (BF, 64, True, False),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_ring_refusal_depends_on_dtype_and_layout(card, case):
    """A gradient on the card is refused before any launch exactly when
    ring_flash_bwd has no kernel for the head dim on the route q, k, v
    take: d = 128 runs on the tensor-core route (bf16, 16-byte rows) and
    is refused on the CUDA-core one (f32, other layouts)."""
    dtype, d, shifted, refused = REFUSALS[case]
    assert RING_BWD_HEAD_DIMS == {"wgmma": (32, 64, 112, 128, 256),
                                  "simt": (32, 64)}
    rng = np.random.RandomState(d)
    q = torch.from_numpy(rng.randn(1, 4, 32, d).astype("float32")).to(dtype)
    if shifted:
        q = torch.cat([torch.zeros(1, dtype=dtype), q.reshape(-1)])[1:] \
            .view(1, 4, 32, d)
    k, v = (torch.from_numpy(rng.randn(1, 2, 32, d).astype("float32"))
            .to(dtype) for _ in range(2))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    if refused:
        with pytest.raises(NotImplementedError, match=f"head dim {d}"):
            ring_flash_attention(q, k, v, ring_steps=2)
        assert card["fwd"] == 0
        return
    o = ring_flash_attention(q, k, v, ring_steps=2)
    assert card["fwd"] == 2
    torch.autograd.grad(o.float().sum(), (q, k, v))
    assert len(card["do"]) == 2


def test_ring_cotangent_keeps_the_promised_route(card):
    """A cotangent whose layout the tensor-core copies cannot read (here a
    view 2 bytes into its rows) is copied before the step backward, so the
    route ring_flash_attention checked up front is the one it launches."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(1, h, 32, 128).astype("float32"))
               .to(BF).requires_grad_() for h in (4, 2, 2))
    o = ring_flash_attention(q, k, v, ring_steps=1)   # o is the step's own
    g = torch.zeros((1, 4, 32, 129), dtype=BF)[..., 1:]
    assert route(q, k, v, g) == "simt"
    torch.autograd.grad(o, (q, k, v), g)
    assert [route(q, k, v, do) for do in card["do"]] == ["wgmma"]


# ---------------------------------------------------------------------------
# the rounding model of the tensor-core ring backward
# ---------------------------------------------------------------------------

def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _one_plane_bwd(q, k, v, do, lse, delta, q_start, k_start, **kw):
    """The design the tensor-core backward rejected: dk = ds^T q and dv =
    p^T do with ds and p rounded once to bf16 (ring_bwd_tc_ref keeps them
    as hi/lo planes). Returns (dk, dv) at indices 1 and 2, as the refs."""
    _, _, dof, p, ds = _ring_p_ds(q, k, v, do, lse, delta, q_start, k_start,
                                  causal=kw.get("causal", True),
                                  window=kw.get("window"), sm_scale=None,
                                  prefix_len=kw.get("prefix_len", 0))
    qf = q.float().reshape(dof.shape[:-1] + (q.shape[-1],))

    def one(x):
        return x.to(BF).float().transpose(-1, -2)

    return (None, torch.matmul(one(ds), qf).sum(2),
            torch.matmul(one(p), dof).sum(2))


PLANE_CASES = {
    "causal, crosses the diagonal": dict(q_start=30, k_start=20),
    "gqa 4, window 40": dict(q_start=60, k_start=10, window=40, g=4),
    "prefix 24, dead rows": dict(q_start=0, k_start=40, prefix_len=24),
}


@pytest.mark.parametrize("case", list(PLANE_CASES))
def test_ring_bwd_planes_match_f32_and_jax(case):
    """dk and dv of ring_bwd_tc_ref (p and ds as two bf16 planes) within
    2^-14 of the largest magnitude of the f32 ring_bwd_ref and of the JAX
    step's VJP, on bf16-rounded inputs (exact in f32); dq (ds rounded once)
    within 2^-7, the card's limit for the bf16 dq. One plane misses dk and
    dv by more than 16 times two planes' error."""
    kw = dict(PLANE_CASES[case])
    g = kw.pop("g", 2)
    qs, ks = kw.pop("q_start"), kw.pop("k_start")
    rng = np.random.RandomState(len(case))
    sq, skv, hk, d = 96, 80, 2, 64

    def rnd(*shape):
        return torch.from_numpy(rng.randn(*shape).astype("float32")) \
            .to(BF).float()

    q, k, v = rnd(1, hk * g, sq, d), rnd(1, hk, skv, d), rnd(1, hk, skv, d)
    g_o, g_lse = rnd(1, hk * g, sq, d), rnd(1, hk * g, sq)
    qst = torch.full((1, 1), qs, dtype=torch.int32)
    kst = torch.full((1, 1), ks, dtype=torch.int32)
    o, lse = ring_fwd_ref(q, k, v, qst, kst, **kw)
    g_lse = torch.where(torch.isneginf(lse), 0.0, g_lse)
    delta = flash_delta_ref(g_o, o) - g_lse
    args = (q, k, v, g_o, lse, delta, qst, kst)
    want = ring_bwd_ref(*args, **kw)
    two = ring_bwd_tc_ref(*args, **kw)
    one = _one_plane_bwd(*args, **kw)

    frozen = tuple(sorted(dict(
        causal=True, window=kw.get("window"), sm_scale=None,
        prefix_len=kw.get("prefix_len", 0), block_q=sq, block_kv=skv,
        ring_steps=1, mesh_axis="model", backend="jnp",
        interpret=None).items()))
    arrays = [t.numpy() for t in (q, k, v)]
    _, pull = jax.vjp(lambda a, b, c: jax_ring._ring_step(
        frozen, a, b, c, qst.numpy(), kst.numpy()), *arrays)
    jgrads = [torch.from_numpy(np.array(x)) for x in pull((g_o.numpy(),
                                                           g_lse.numpy()))]
    assert _rel(two[0], want[0]) <= 2.0 ** -7
    for i, name in ((1, "dk"), (2, "dv")):
        err = _rel(two[i], want[i])
        assert err <= 2.0 ** -14, (name, err)
        assert _rel(two[i], jgrads[i]) <= 2.0 ** -14, name
        assert _rel(one[i], want[i]) > 16 * err, name
    if "dead" in case:
        dead = torch.isneginf(lse)
        assert dead.any()
        assert (two[0][dead] == 0).all()
