"""The templated sem_apply and the CUDA flash_delta, on the CPU.

* ``sem_route`` sends nq 2..10 (N = 1..9) to the templated instances of
  ``csrc/sem.cu`` and every other nq to the generic kernel; the wrapper,
  run as on the card with its library stubbed through ``load`` /
  ``on_cpu`` / ``stream``, passes the route to the C entry point first,
  counts it in ``sem_apply.routes`` and counts one launch, and refuses nq
  = 25, eb = 0 and mismatched shapes before any launch.
* ``flash_delta.route`` picks "vec" (16-byte vectors) for one dtype, d
  whole vectors, 16-byte aligned bases and (b, h, s) strides of whole
  vectors, "scalar" otherwise (a transposed do stays "vec"; a view one
  element off alignment, d = 36 in bf16 or mixed dtypes go "scalar"); the
  stubbed wrapper passes the route, the dtypes and both tensors' strides
  and refuses what the kernel cannot take.
* The port's CPU ``sem_apply`` (its plain version) against the JAX
  ``SEMOperator(model="pallas")`` (the Pallas kernel in interpret mode)
  and ``repro.apps.sem.apply_ref`` at the main path's N = 7 (nq 8), with
  eb = 1, within MM_TOL = 2e-4 (f32 contractions summed in another
  order); and the f32 plain version within (2 nq + 16) 2^-24 of each
  output's summed |terms| of the f64 result, the bound
  ``chip_smoke.check_rounding`` holds the kernel to.
* The port's CPU ``flash_delta`` against the JAX ``flash_delta_builder``
  run through ``Device("pallas")`` in interpret mode, as the JAX ring
  backward builds it, in bf16 and f32, d = 32/64/128, do contiguous and
  transposed, within EW = 1e-5.
* No module of ``src/repro_torch`` imports ``triton`` (nor ``jax`` or
  ``repro``): the port has no Triton kernel left.
"""

import ast
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import sem as jsem
from repro.core import Device
from repro.kernels.flash_attention.kernel import flash_delta_builder

from repro_torch.apps import sem as tsem
from repro_torch.kernels import reset_launches
from repro_torch.kernels.apps import apply_ref, sem_apply, sem_route
from repro_torch.kernels.flash_attention import flash_delta, flash_delta_ref

sem_mod = importlib.import_module("repro_torch.kernels.apps.sem")
common = importlib.import_module("repro_torch.kernels.apps._common")
attn_ops = importlib.import_module("repro_torch.kernels.flash_attention.ops")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MM_TOL = dict(rtol=2e-4, atol=2e-4)
EW = dict(rtol=1e-5, atol=1e-5)
BF = torch.bfloat16


@pytest.fixture(autouse=True)
def _no_persisted_winners(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))


def _t(a):
    return torch.from_numpy(np.array(a))


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
    monkeypatch.setattr(attn_ops, "on_cpu", lambda name, *ts: False)
    for mod in (sem_mod, attn_ops):
        monkeypatch.setattr(mod, "load", lambda name, sig: lib)
        monkeypatch.setattr(mod, "stream", lambda: 0)
    monkeypatch.setattr(sem_mod, "_ENTRY", None)
    monkeypatch.setattr(attn_ops, "_DELTA_ENTRY", None)
    reset_launches()
    return lib


# ---------------------------------------------------------------------------
# sem_apply: the route rule and the wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq", range(1, 25))
def test_sem_route_by_nq(nq):
    """nq 2..10 (N = 1..9: the main path's 8, sem_solve's default 5, the
    tests' 2 and 4) on the templated instances, 1 and 11..24 generic."""
    assert sem_route(nq) == ("templated" if 2 <= nq <= 10 else "generic")


@pytest.mark.parametrize("nq,E,eb", [(8, 32768, 32), (5, 512, 32),
                                     (2, 7, 4), (10, 3, 1), (11, 5, 2),
                                     (24, 2, 1), (1, 3, 8)])
def test_sem_apply_passes_its_route_up_front(stub, nq, E, eb):
    """The route goes to the entry point first, then the four pointers,
    E, nq and eb; one launch, counted by route."""
    u = torch.zeros(E, nq, nq, nq)
    geo, dmat = torch.zeros(E, 7, nq, nq, nq), torch.zeros(nq, nq)
    out = sem_apply(u, geo, dmat, eb=eb)
    assert out.shape == u.shape
    want = sem_route(nq)
    assert sem_apply.launches == 1
    assert sem_apply.routes == {"templated": int(want == "templated"),
                                "generic": int(want == "generic")}
    ((name, a),) = stub.calls
    assert name == "sem_apply"
    assert a[0] == (want == "templated")
    assert a[1:5] == (u.data_ptr(), geo.data_ptr(), dmat.data_ptr(),
                      out.data_ptr())
    assert a[5:8] == (E, nq, eb)


@pytest.mark.parametrize("case", ["nq 25", "eb 0", "geo", "dmat", "u 3-d",
                                  "not contiguous", "float64"])
def test_sem_apply_refuses_before_any_launch(stub, case):
    u, geo, dmat = (torch.zeros(3, 4, 4, 4), torch.zeros(3, 7, 4, 4, 4),
                    torch.zeros(4, 4))
    kw = {}
    if case == "nq 25":
        u, geo, dmat = (torch.zeros(1, 25, 25, 25),
                        torch.zeros(1, 7, 25, 25, 25), torch.zeros(25, 25))
    elif case == "eb 0":
        kw = dict(eb=0)
    elif case == "geo":
        geo = torch.zeros(3, 6, 4, 4, 4)
    elif case == "dmat":
        dmat = torch.zeros(4, 5)
    elif case == "u 3-d":
        u = torch.zeros(3, 4, 16)
    elif case == "not contiguous":
        u = u.transpose(1, 3)
    else:
        u = u.double()
    with pytest.raises(ValueError):
        sem_apply(u, geo, dmat, **kw)
    assert not stub.calls and sem_apply.launches == 0
    assert sem_apply.routes == {"templated": 0, "generic": 0}


# ---------------------------------------------------------------------------
# flash_delta: the route rule and the wrapper
# ---------------------------------------------------------------------------

def _rows(b, h, s, d, dtype, *, transposed=False, lead=0):
    """A (b, h, s, d) tensor: contiguous, or the transposed view of a (b,
    s, h, d) one; its storage ``lead`` elements past an allocation."""
    shape = (b, s, h, d) if transposed else (b, h, s, d)
    n = b * h * s * d
    t = torch.zeros(n + lead, dtype=dtype)[lead:].view(shape)
    return t.transpose(1, 2) if transposed else t


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("d", [32, 36, 64, 112, 128, 256])
@pytest.mark.parametrize("layout", ["contiguous", "transposed", "offset"])
def test_flash_delta_route(dtype, d, layout):
    """"vec" when d is whole 16-byte vectors and the bases and strides
    allow them (a transposed do keeps it); "scalar" for bf16 d = 36 and a
    view one element off alignment."""
    do = _rows(2, 3, 5, d, dtype, transposed=layout == "transposed",
               lead=int(layout == "offset"))
    o = _rows(2, 3, 5, d, dtype)
    n = 16 // do.element_size()
    want = "vec" if d % n == 0 and layout != "offset" else "scalar"
    assert flash_delta.route(do, o) == want
    assert flash_delta.route(o, do) == want


def test_flash_delta_route_of_mixed_dtypes_is_scalar():
    assert flash_delta.route(_rows(1, 2, 3, 64, BF),
                             _rows(1, 2, 3, 64, torch.float32)) == "scalar"


@pytest.mark.parametrize("dtype,d,transposed,lead,want", [
    (BF, 64, True, 0, "vec"),               # the train step's do
    (BF, 128, False, 0, "vec"),
    (torch.float32, 112, True, 0, "vec"),
    (BF, 36, False, 0, "scalar"),
    (BF, 64, False, 1, "scalar"),
])
def test_flash_delta_passes_route_dtypes_and_strides(stub, dtype, d,
                                                     transposed, lead, want):
    """The route first, then the pointers, (B, H, Sq, D), the dtype codes
    and both tensors' (b, h, s) strides in elements; one launch, counted
    by route."""
    do = _rows(2, 3, 5, d, dtype, transposed=transposed, lead=lead)
    o = _rows(2, 3, 5, d, dtype)
    delta = flash_delta(do, o)
    assert delta.shape == (2, 3, 5) and delta.dtype == torch.float32
    assert flash_delta.launches == 1
    assert flash_delta.routes == {"vec": int(want == "vec"),
                                  "scalar": int(want == "scalar")}
    ((name, a),) = stub.calls
    assert name == "flash_delta"
    assert a[0] == (want == "vec")
    assert a[1:4] == (do.data_ptr(), o.data_ptr(), delta.data_ptr())
    code = 1 if dtype == BF else 0
    assert a[4:10] == (2, 3, 5, d, code, code)
    assert a[10:16] == (*do.stride()[:3], *o.stride()[:3])


@pytest.mark.parametrize("case", ["shapes", "3-d", "float16",
                                  "last axis strided", "65536 heads"])
def test_flash_delta_refuses_before_any_launch(stub, case):
    do, o = _rows(2, 3, 5, 64, BF), _rows(2, 3, 5, 64, BF)
    if case == "65536 heads":
        do = o = torch.zeros(1, 1, 1, 8, dtype=BF).expand(1, 65536, 1, 8)
    elif case == "shapes":
        o = _rows(2, 3, 6, 64, BF)
    elif case == "3-d":
        do, o = do[0], o[0]
    elif case == "float16":
        do, o = do.half(), o.half()
    else:
        do = torch.zeros(2, 3, 5, 128, dtype=BF)[..., ::2]
    with pytest.raises(ValueError):
        flash_delta(do, o)
    assert not stub.calls and flash_delta.launches == 0


def test_flash_delta_launches_nothing_for_empty_rows(stub):
    """No rows (or d = 0): zeros of (B, H, Sq), no launch."""
    assert flash_delta(_rows(2, 3, 0, 64, BF), _rows(2, 3, 0, 64, BF)
                       ).shape == (2, 3, 0)
    z = flash_delta(_rows(2, 3, 4, 0, BF), _rows(2, 3, 4, 0, BF))
    assert z.shape == (2, 3, 4) and not z.any()
    assert not stub.calls and flash_delta.launches == 0


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def test_sem_apply_matches_jax_pallas_at_the_main_paths_order():
    """N = 7 (nq 8) on a 2 x 1 x 1 deformed mesh, eb = 1: the port's CPU
    sem_apply (its plain version) against the JAX operator's Pallas
    kernel in interpret mode and the JAX oracle; the torch operator's
    apply_local gives the same."""
    j = jsem.SEMOperator(model="pallas", ex=2, ey=1, ez=1, n=7, deform=0.12,
                         eb=1)
    t = tsem.SEMOperator(ex=2, ey=1, ez=1, n=7, deform=0.12, eb=1,
                         device="cpu")
    assert (j.E, j.nq, j.eb) == (2, 8, 1)
    u = np.random.RandomState(7).randn(j.E, 8, 8, 8).astype(np.float32)
    geo, dmat = np.asarray(j.o_geo.data), np.asarray(j.o_dmat.data)
    got = sem_apply(_t(u), _t(geo), _t(dmat), eb=1).numpy()
    ref = np.asarray(jsem.apply_ref(jnp.asarray(u), j.o_geo.data,
                                    j.o_dmat.data))
    np.testing.assert_allclose(got, ref, **MM_TOL)
    np.testing.assert_allclose(got, np.asarray(j.apply_local(u)), **MM_TOL)
    np.testing.assert_allclose(t.apply_local(_t(u)).numpy(), got, **MM_TOL)


def test_sem_plain_within_rounding_bound_of_f64():
    """The f32 plain version on the N = 7 operator's factors is within
    (2 nq + 16) 2^-24 of each output's summed |terms| (apply_ref of the
    absolute values, in f64) of the f64 result: the bound chip_smoke
    holds the kernel to at the main path's state."""
    op = tsem.SEMOperator(ex=2, ey=2, ez=1, n=7, device="cpu")
    u = _t(np.random.RandomState(8).randn(op.E, 8, 8, 8).astype(np.float32))
    ref64 = apply_ref(u.double(), op.geo.double(), op.dmat.double())
    mag = apply_ref(u.double().abs(), op.geo.double().abs(),
                    op.dmat.double().abs())
    err = (apply_ref(u, op.geo, op.dmat).double() - ref64).abs()
    assert (err <= (2 * 8 + 16) * 2.0 ** -24 * mag).all()
    assert float((mag / ref64.abs().clamp_min(1e-30)).max()) > 10


def _jax_delta(do, o, dtype, block_q):
    b, h, sq, d = do.shape
    kern = Device("pallas").build_kernel(flash_delta_builder, dict(
        b=b, h=h, sq=sq, dv=d, block_q=block_q, dtype=dtype))
    (delta,) = kern.run(jnp.asarray(do, dtype), jnp.asarray(o, dtype))
    return np.asarray(delta)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("transposed", [False, True])
def test_flash_delta_matches_jax_flash_delta_builder(dtype, d, transposed):
    """delta = rowsum(do o) in f32 from bf16 or f32 inputs, do contiguous
    or a transposed view (the train step's layout), against the JAX
    builder's Pallas kernel in interpret mode."""
    b, h, sq = 2, 3, 16
    rng = np.random.default_rng(d + transposed)
    do = rng.standard_normal((b, sq, h, d) if transposed else (b, h, sq, d),
                             np.float32)
    o = rng.standard_normal((b, h, sq, d), np.float32)
    tdt = BF if dtype == "bfloat16" else torch.float32
    tdo, to = _t(do).to(tdt), _t(o).to(tdt)
    if transposed:
        tdo, do = tdo.transpose(1, 2), do.transpose(0, 2, 1, 3)
    assert tdo.shape == (b, h, sq, d)
    got = flash_delta(tdo, to).numpy()
    want = _jax_delta(do, o, dtype, block_q=8)
    np.testing.assert_allclose(got, want, **EW)
    np.testing.assert_allclose(got, flash_delta_ref(tdo, to).numpy(), **EW)


# ---------------------------------------------------------------------------
# the port has no Triton kernel left
# ---------------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_triton_jax_or_repro():
    files = []
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert os.path.join(ROOT, "src", "repro_torch", "kernels",
                        "flash_attention", "ops.py") in files
    assert not os.path.exists(os.path.join(
        ROOT, "src", "repro_torch", "kernels", "flash_attention", "delta.py"))
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("triton", "jax", "jaxlib", "repro")]
    assert not bad, bad
