"""The row-streaming fd2d and the folded dg_volume, on the CPU.

* ``fd2d_stream_ref`` is the plain model of what ``csrc/fd2d.cu`` computes
  on either route: f32 with a rounding after every operation, per k the
  vertical term and then the horizontal one, lap times 1/dx^2, dt^2 and
  1/dx^2 rounded to f32 as the wrapper passes them. It is held against a
  node-by-node f32 chain (bit-equal), against the JAX ``fd2d`` op run by
  its Pallas kernel in interpret mode and against the JAX oracle, at
  radii 1, 2, 4 and 8 on fields whose sides are not multiples of 4 (and
  narrower than the stencil at r = 8), FD_TOL = 2e-5.
* ``volume_folded_ref`` is the plain model of the volume kernel's order:
  P = rx F + ry G and S = sx F + sy G first, then the two sums Dr P and
  Ds S added at the end. It is held against the JAX ``dg_volume`` op (its
  Pallas kernel in interpret mode) and the JAX oracle at N = 1, 3, 5, 7
  within MM_TOL = 2e-4, and against the f64 plain version within
  (np + 16) 2^-24 of each output's summed |terms| (the bound
  ``chip_smoke.check_rounding`` holds the kernel to), on a random state
  and on a state near rest whose outputs cancel.
* The wrappers, run as on the card with their library stubbed through
  ``load`` / ``on_cpu`` / ``stream``, pick their route up front (fd2d:
  "vec" or "scalar" by width, tile width and alignment; dg_volume:
  "templated" for N = 1..7, "generic" otherwise), pass it to the C entry
  point, count it in ``wrapper.routes`` and count one launch; a tile or
  block whose shared memory exceeds the card's is refused before any
  launch.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import dg_swe as jdg
from repro.apps import fd2d as jfd

from repro_torch.apps.numerics import fd_second_derivative_weights
from repro_torch.kernels import reset_launches
from repro_torch.kernels.apps import (GRAV, dg_volume, fd2d, fd2d_ref,
                                      fd2d_stream_ref, volume_folded_ref,
                                      volume_ref)
from repro_torch.kernels.apps._common import SMEM_MAX

fd_mod = importlib.import_module("repro_torch.kernels.apps.fd2d")
dg_mod = importlib.import_module("repro_torch.kernels.apps.dg")
common = importlib.import_module("repro_torch.kernels.apps._common")

FD_TOL = dict(rtol=2e-5, atol=2e-5)
MM_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _no_persisted_winners(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(r):
    return tuple(float(x) for x in fd_second_derivative_weights(r))


# ---------------------------------------------------------------------------
# fd2d: the streaming model
# ---------------------------------------------------------------------------

def test_fd2d_stream_model_is_the_kernels_chain_of_roundings():
    """Every output of the model equals the kernel's per-node f32 chain,
    bit for bit: lap from 0, per k + w_k u[y+k, x] then + w_k u[y, x+k],
    times f32(1/dx^2), then (2 u - u2) + f32(dt^2) lap."""
    h, w, r = 9, 11, 3
    rng = np.random.default_rng(5)
    u1 = rng.standard_normal((h, w)).astype(np.float32)
    u2 = rng.standard_normal((h, w)).astype(np.float32)
    wts = _weights(r)
    dx, dt = 2.0 / w, 0.3 * (2.0 / w) / 2 ** 0.5
    got = fd2d_stream_ref(_t(u1), _t(u2), wts, dx, dt).numpy()
    f = np.float32
    inv, dt2 = f(1.0 / (dx * dx)), f(dt * dt)
    want = np.empty_like(u1)
    for y in range(h):
        for x in range(w):
            lap = f(0)
            for k in range(-r, r + 1):
                wk = f(wts[k + r])
                lap = f(lap + f(wk * u1[(y + k) % h, x]))
                lap = f(lap + f(wk * u1[y, (x + k) % w]))
            want[y, x] = f(f(f(2) * u1[y, x]) - u2[y, x]) + f(dt2 * f(lap * inv))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,r,block", [(24, 36, 1, (8, 12)),
                                         (48, 40, 2, (16, 8)),
                                         (20, 44, 4, (0, 0)),
                                         (37, 53, 8, (0, 0))])
def test_fd2d_stream_model_matches_jax(h, w, r, block):
    """The model against the JAX op in Pallas interpret mode (the
    builder's own order) and the JAX oracle, and against the port's plain
    version; (37, 53) at r = 8: both sides odd and the stencil wraps more
    than a third of the field."""
    j = jfd.FDWave(model="pallas", width=w, height=h, radius=r, block=block)
    rng = np.random.default_rng(r)
    u1 = rng.standard_normal((h, w)).astype(np.float32)
    u2 = rng.standard_normal((h, w)).astype(np.float32)
    j.o_u1, j.o_u2 = j.device.malloc(u1), j.device.malloc(u2)
    j.fd2d(j.o_u1, j.o_u2, j.o_u3)
    got = fd2d_stream_ref(_t(u1), _t(u2), j.weights, j.dx, j.dt).numpy()
    np.testing.assert_allclose(got, j.o_u3.to_host(), **FD_TOL)
    ref = jfd.reference_step(jnp.asarray(u1), jnp.asarray(u2), j.weights,
                             j.dx, j.dt)
    np.testing.assert_allclose(got, np.asarray(ref), **FD_TOL)
    np.testing.assert_allclose(
        got, fd2d_ref(_t(u1), _t(u2), j.weights, j.dx, j.dt).numpy(),
        **FD_TOL)


# ---------------------------------------------------------------------------
# dg_volume: the folded model
# ---------------------------------------------------------------------------

def _volume_terms_abs(Q, geom, dB, Dr, Ds, g=GRAV):
    """For each output, the sum of the absolute values of the terms it is
    summed from (f64), as chip_smoke's check_rounding takes it."""
    h, hu, hv = Q[..., 0], Q[..., 1], Q[..., 2]
    u, v = hu / h, hv / h
    gh2 = 0.5 * g * h * h
    F = torch.stack([hu.abs(), (hu * u).abs() + gh2, (hu * v).abs()], -1)
    G = torch.stack([hv.abs(), (hu * v).abs(), (hv * v).abs() + gh2], -1)
    a = geom.abs()[:, :, None, None]
    dr, ds = Dr.abs(), Ds.abs()
    mag = (a[:, 0] * torch.einsum("nm,emf->enf", dr, F)
           + a[:, 1] * torch.einsum("nm,emf->enf", ds, F)
           + a[:, 2] * torch.einsum("nm,emf->enf", dr, G)
           + a[:, 3] * torch.einsum("nm,emf->enf", ds, G))
    src = torch.stack([torch.zeros_like(h), g * h * dB[..., 0].abs(),
                       g * h * dB[..., 1].abs()], -1)
    return mag + src


def _within_rounding(got, args):
    a64 = [t.double() for t in args]
    np_ = args[0].shape[1]
    bound = (np_ + 16) * 2.0 ** -24 * _volume_terms_abs(*a64)
    err = (got.double() - volume_ref(*a64)).abs()
    assert bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.parametrize("n,nx,eb", [(1, 3, 6), (3, 3, 6), (5, 2, 8),
                                     (7, 2, 4)])
def test_volume_folded_model_matches_jax(n, nx, eb):
    """The model against the JAX op in Pallas interpret mode and the JAX
    oracle at N = 1, 3, 5, 7 (np 3, 10, 21, 36) on a jittered mesh with a
    sloped bottom, and against the f64 plain version within the rounding
    bound."""
    bath = lambda x, y: 0.2 * x - 0.1 * y  # noqa: E731
    j = jdg.DGVolume(model="pallas", nx=nx, ny=nx, n=n, eb=eb, jitter=0.2,
                     bathymetry=bath)
    rng = np.random.RandomState(n)
    Q = np.stack([2.0 + 0.1 * rng.randn(j.E, j.np_),
                  0.3 * rng.randn(j.E, j.np_),
                  0.3 * rng.randn(j.E, j.np_)], -1).astype(np.float32)
    jargs = (j.o_geom.data, j.o_db.data, j.o_dr.data, j.o_ds.data)
    args = (_t(Q), *(_t(a) for a in jargs))
    got = volume_folded_ref(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(j.rhs_volume(Q)),
                               **MM_TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jdg.volume_ref(jnp.asarray(Q), *jargs)),
        **MM_TOL)
    _within_rounding(got, args)


def test_volume_folded_model_within_rounding_near_rest():
    """Near rest on a flat bottom each output is a cancelling sum of terms
    ~rx F (the main path's state after its steps): the folded order stays
    within (np + 16) 2^-24 of the summed |terms| at N = 5, where an
    error relative to the result could not hold."""
    sol = jdg.DGVolume(model="jnp", nx=8, ny=8, n=5, jitter=0.1)
    rng = np.random.RandomState(11)
    Q = np.stack([1.0 + 1e-4 * rng.randn(sol.E, sol.np_),
                  1e-4 * rng.randn(sol.E, sol.np_),
                  1e-4 * rng.randn(sol.E, sol.np_)], -1).astype(np.float32)
    args = (_t(Q), *(_t(np.asarray(a.data)) for a in (
        sol.o_geom, sol.o_db, sol.o_dr, sol.o_ds)))
    got = volume_folded_ref(*args)
    _within_rounding(got, args)
    _within_rounding(volume_ref(*args), args)


# ---------------------------------------------------------------------------
# the wrappers' routes (library stubbed)
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


@pytest.fixture
def stub(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(common, "on_cpu", lambda name, *ts: False)
    for mod in (fd_mod, dg_mod):
        monkeypatch.setattr(mod, "load", lambda name, sig: lib)
        monkeypatch.setattr(mod, "stream", lambda: 0)
    monkeypatch.setattr(fd_mod, "_ENTRY", None)
    monkeypatch.setattr(dg_mod, "_VOL_ENTRY", None)
    reset_launches()
    return lib


def _field(h, w, lead=0):
    """A contiguous (h, w) f32 field starting ``lead`` floats past a
    16-byte boundary."""
    return torch.zeros(h * w + 4)[lead:lead + h * w].view(h, w)


@pytest.mark.parametrize("h,w,block,leads,want", [
    (24, 40, (8, 16), (0, 0, 0), "vec"),
    (8192, 8192, (32, 256), (0, 0, 0), "vec"),
    (24, 42, (8, 16), (0, 0, 0), "scalar"),        # w % 4 != 0
    (24, 40, (8, 18), (0, 0, 0), "scalar"),        # bw % 4 != 0
    (24, 40, (0, 0), (0, 0, 0), "vec"),            # one tile, w % 4 == 0
    (33, 70, (0, 0), (0, 0, 0), "scalar"),
    (24, 40, (8, 16), (1, 0, 0), "scalar"),        # u1 off alignment
    (24, 40, (8, 16), (0, 2, 0), "scalar"),        # u2
    (24, 40, (8, 16), (0, 0, 3), "scalar"),        # out
])
def test_fd2d_picks_its_route_up_front(stub, h, w, block, leads, want):
    """The route from widths and alignment, passed to the entry point as
    its first argument and counted; one launch; the tile as clamped to
    the field."""
    u1, u2, out = (_field(h, w, lead) for lead in leads)
    wts = _weights(4)
    got = fd2d(u1, u2, weights=wts, dx=0.01, dt=0.001, block=block, out=out)
    assert got is out
    assert fd2d.launches == 1
    assert fd2d.routes == {"vec": int(want == "vec"),
                           "scalar": int(want == "scalar")}
    assert fd_mod.route(u1, u2, out, min(block[1] or w, w)) == want
    ((name, args),) = stub.calls
    assert name == "fd2d"
    assert args[0] == (want == "vec")
    assert args[1:4] == (u1.data_ptr(), u2.data_ptr(), out.data_ptr())
    assert args[4:7] == (h, w, 4)
    assert list(args[7]) == pytest.approx(list(wts), rel=1e-7)
    assert args[8:10] == (1.0 / (0.01 * 0.01), 0.001 * 0.001)
    assert args[10:12] == (min(block[0] or h, h), min(block[1] or w, w))


def test_fd2d_ring_fits_every_tile():
    """The rings' shared memory depends on r and on the tile's width up
    to 4 x 256 columns, not on its height: the widest strip at r = 8 fits,
    and the main path's (32, 256) tile at r = 4 takes 9 rows of 264 floats
    of u1 and 5 rows of 256 of u2."""
    assert fd_mod._smem(4, 256) == 4 * (9 * 264 + 5 * 256)
    assert fd_mod._smem(8, 8192) == fd_mod._smem(8, 1024) == 4 * (
        13 * 1040 + 5 * 1024)
    assert fd_mod._smem(1, 1) == 4 * (6 * (128 + 8) + 5 * 128)
    assert max(fd_mod._smem(r, bw) for r in range(1, 9)
               for bw in (1, 255, 256, 1024, 1 << 20)) <= SMEM_MAX


def _volume_args(E, np_, lead=0):
    q = _field(E * np_, 3, lead).view(E, np_, 3)
    return (q, _field(E, 4), _field(E * np_, 2).view(E, np_, 2),
            torch.zeros(np_, np_), torch.zeros(np_, np_))


@pytest.mark.parametrize("np_,E,eb,want", [(3, 37, 8, "templated"),
                                           (21, 131072, 64, "templated"),
                                           (36, 10, 1, "templated"),
                                           (45, 9, 1, "generic"),
                                           (4, 300, 200, "generic")])
def test_dg_volume_picks_its_instance_up_front(stub, np_, E, eb, want):
    """N = 1..7 (np 3..36) take the templated instances, any other np the
    generic one: the flag goes to the entry point first, the route is
    counted, one launch."""
    args = _volume_args(E, np_, lead=1)
    out = dg_volume(*args, eb=eb)
    assert out.shape == (E, np_, 3)
    assert dg_volume.launches == 1
    assert dg_volume.routes == {"templated": int(want == "templated"),
                                "generic": int(want == "generic")}
    ((name, a),) = stub.calls
    assert name == "dg_volume"
    assert a[0] == (want == "templated")
    assert a[1:6] == tuple(t.data_ptr() for t in args)
    assert a[6] == out.data_ptr()
    assert a[7:10] == (E, np_, eb) and a[10] == pytest.approx(GRAV)


def test_dg_volume_fits_its_chunk_to_shared_memory(stub):
    """A block takes min(eb, 64) elements at a time, fewer where their
    staged inputs and P/S would pass the card's 227 KB (N = 8 at 128
    elements would); the main path's np = 21 at eb = 64 leaves room for
    three blocks an SM. Only an np whose Dr and Ds alone pass it is
    refused, before the launch."""
    assert dg_mod._volume_smem(21, 64, False) < SMEM_MAX // 3
    assert dg_mod._volume_smem_at(45, 128, True) > SMEM_MAX
    assert dg_mod._volume_smem(45, 128, True) <= SMEM_MAX
    assert dg_mod._volume_smem(36, 128, False) <= SMEM_MAX
    dg_volume(*_volume_args(200, 45), eb=128)
    assert dg_volume.routes["generic"] == 1
    with pytest.raises(ValueError, match="shared memory"):
        dg_volume(*_volume_args(2, 300), eb=1)
    assert len(stub.calls) == 1 and dg_volume.launches == 1
