"""The six builders the port writes in its kernel language (fd2d, sem_ax,
dg_swe_volume, dg_swe_surface, matmul, rmsnorm) and the app drivers built
on them, against the JAX package on the CPU.

Each builder's ``torch`` and ``loops`` expansions take the same numpy
inputs, made from a seed, as the JAX builder's ``jnp`` expansion, and are
held to it and to the port's plain version of the kernel: the FD stencil
within 1e-6 of the largest |reference| against JAX (the same order of f32
sums) and 2e-5 against the plain version (another order; the app tests'
FD tolerance); the contractions (SEM, DG, matmul) at ``MM_TOL`` (rtol =
atol = 2e-4); rmsnorm in f32 within 1e-6 of the largest |reference|, in
bf16 within one bf16 rounding (2^-8 relative). The drivers with
``model="torch"``/``"loops"`` run against the JAX drivers with
``model="jnp"``/``"loops"`` at ``tests/test_torch_apps.py``'s tolerances:
20 FD steps within 1e-4, the SEM operator and 10 LSERK steps within
``MM_TOL``. A persisted tune winner could change the drivers' blocks, so
every test points ``REPRO_CACHE_DIR`` at an empty directory.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.apps import dg_swe as jdg
from repro.apps import fd2d as jfd
from repro.apps import sem as jsem
from repro.kernels.matmul import matmul_builder as jmatmul_builder
from repro.kernels.rmsnorm.kernel import rmsnorm_builder as jrmsnorm_builder

from repro_torch import core as tcore
from repro_torch.apps import dg_swe as tdg
from repro_torch.apps import fd2d as tfd
from repro_torch.apps import sem as tsem
from repro_torch.apps.numerics import fd_second_derivative_weights
from repro_torch.kernels import KERNELS, launch_counts, reset_launches
from repro_torch.kernels.apps import (apply_ref, fd2d_ref, surface_ref,
                                      volume_ref)
from repro_torch.kernels.matmul import matmul_builder, matmul_ref
from repro_torch.kernels.rmsnorm import rmsnorm_builder, rmsnorm_ref
from repro_torch.launch import apps as tapps

MM_TOL = dict(rtol=2e-4, atol=2e-4)
FD_TOL = dict(rtol=2e-5, atol=2e-5)
PORT = ("torch", "loops")


@pytest.fixture(autouse=True)
def _no_persisted_winners(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax(builder, defines, arrays):
    k = jcore.Device("jnp").build_kernel(builder, defines)
    return [np.asarray(o) for o in k.run(*[jnp.asarray(a) for a in arrays])]


def _port(backend, builder, defines, arrays):
    k = tcore.Device(backend, device="cpu").build_kernel(builder, defines)
    return [o for o in k.run(*[_t(a) for a in arrays])]


def _within(got, ref, rel):
    err = float(np.abs(got.astype(np.float64) - ref).max())
    assert err <= rel * float(np.abs(ref).max()), (err, rel)


def _swe_state(E, n, rng, *, dh=0.1, dm=0.3):
    return np.stack([1.5 + dh * rng.randn(E, n), dm * rng.randn(E, n),
                     dm * rng.randn(E, n)], -1).astype(np.float32)


@pytest.mark.parametrize("r", [1, 2, 4])
def test_fd2d_builder_matches_jax_and_the_plain_step(r):
    h, w = 24, 32
    weights = tuple(float(x) for x in fd_second_derivative_weights(r))
    d = dict(w=w, h=h, bh=8, bw=16, r=r, dx=2.0 / w, dt=0.02,
             weights=weights, dtype="float32")
    rng = np.random.RandomState(r)
    u1, u2 = (rng.randn(h, w).astype(np.float32) for _ in "12")
    (ref,) = _jax(jfd.fd2d_builder, d, [u1, u2])
    plain = fd2d_ref(_t(u1), _t(u2), weights, d["dx"], d["dt"]).numpy()
    for be in PORT:
        (got,) = _port(be, tfd.fd2d_builder, d, [u1, u2])
        _within(got.numpy(), ref, 1e-6)
        np.testing.assert_allclose(got.numpy(), plain, **FD_TOL)


def test_sem_builder_matches_jax_and_the_plain_operator():
    E, nq, eb = 8, 4, 2
    rng = np.random.RandomState(0)
    u = rng.randn(E, nq, nq, nq).astype(np.float32)
    geo = rng.randn(E, 7, nq, nq, nq).astype(np.float32)
    dmat = rng.randn(nq, nq).astype(np.float32)
    d = dict(E=E, nq=nq, eb=eb, dtype="float32")
    (ref,) = _jax(jsem.sem_builder, d, [u, geo, dmat])
    plain = apply_ref(_t(u), _t(geo), _t(dmat)).numpy()
    for be in PORT:
        (got,) = _port(be, tsem.sem_builder, d, [u, geo, dmat])
        np.testing.assert_allclose(got.numpy(), ref, err_msg=be, **MM_TOL)
        np.testing.assert_allclose(got.numpy(), plain, err_msg=be, **MM_TOL)


def test_dg_volume_builder_matches_jax_and_the_plain_rhs():
    E, np_, eb = 32, 10, 4
    rng = np.random.RandomState(1)
    q = _swe_state(E, np_, rng)
    geom = rng.randn(E, 4).astype(np.float32)
    db = rng.randn(E, np_, 2).astype(np.float32)
    dr, ds = (rng.randn(np_, np_).astype(np.float32) for _ in "rs")
    d = dict(E=E, np_=np_, eb=eb, g=9.81, dtype="float32")
    arrays = [q, geom, db, dr, ds]
    (ref,) = _jax(jdg.dg_volume_builder, d, arrays)
    plain = volume_ref(*map(_t, arrays)).numpy()
    for be in PORT:
        (got,) = _port(be, tdg.dg_volume_builder, d, arrays)
        np.testing.assert_allclose(got.numpy(), ref, err_msg=be, **MM_TOL)
        np.testing.assert_allclose(got.numpy(), plain, err_msg=be, **MM_TOL)


def test_dg_surface_builder_matches_jax_and_the_plain_rhs():
    E, np_, nfp3, eb = 16, 6, 9, 4
    rng = np.random.RandomState(2)
    qm, qp = _swe_state(E, nfp3, rng), _swe_state(E, nfp3, rng)
    theta = rng.randn(E, nfp3)
    nrm = np.stack([np.cos(theta), np.sin(theta),
                    np.abs(rng.randn(E, nfp3))], -1).astype(np.float32)
    lift = rng.randn(np_, nfp3).astype(np.float32)
    d = dict(E=E, np_=np_, nfp3=nfp3, eb=eb, g=9.81, dtype="float32")
    arrays = [qm, qp, nrm, lift]
    (ref,) = _jax(jdg.dg_surface_builder, d, arrays)
    plain = surface_ref(*map(_t, arrays)).numpy()
    for be in PORT:
        (got,) = _port(be, tdg.dg_surface_builder, d, arrays)
        np.testing.assert_allclose(got.numpy(), ref, err_msg=be, **MM_TOL)
        np.testing.assert_allclose(got.numpy(), plain, err_msg=be, **MM_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_builder_matches_jax_and_the_plain_product(dtype):
    M, K, N = 32, 48, 24
    rng = np.random.RandomState(3)
    a, b = rng.randn(M, K), rng.randn(K, N)
    tdt = getattr(torch, dtype)
    at, bt = (torch.from_numpy(x).to(tdt) for x in (a, b))
    # the values as rounded to dtype, for both packages
    a, b = at.float().numpy(), bt.float().numpy()
    d = dict(M=M, K=K, N=N, bm=8, bk=16, bn=8, dtype=dtype,
             out_dtype="float32")
    (ref,) = jcore.Device("jnp").build_kernel(jmatmul_builder, d).run(
        jnp.asarray(a, dtype), jnp.asarray(b, dtype))
    plain = matmul_ref(at, bt, out_dtype=torch.float32).numpy()
    for be in PORT:
        (got,) = tcore.Device(be, device="cpu").build_kernel(
            matmul_builder, d).run(at, bt)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=be,
                                   **MM_TOL)
        np.testing.assert_allclose(got.numpy(), plain, err_msg=be, **MM_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_builder_matches_jax_and_the_plain_norm(dtype):
    rows, dd = 12, 64
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(rows, dd)).to(getattr(torch, dtype))
    w = torch.from_numpy(rng.randn(dd).astype(np.float32))
    d = dict(rows=rows, d=dd, block_rows=4, eps=1e-6, dtype=dtype,
             wdtype="float32")
    (ref,) = jcore.Device("jnp").build_kernel(jrmsnorm_builder, d).run(
        jnp.asarray(x.float().numpy(), dtype), jnp.asarray(w.numpy()))
    ref = np.asarray(ref.astype(jnp.float32))
    plain = rmsnorm_ref(x, w, eps=1e-6).float().numpy()
    rel = 1e-6 if dtype == "float32" else 2.0 ** -8
    for be in PORT:
        (got,) = tcore.Device(be, device="cpu").build_kernel(
            rmsnorm_builder, d).run(x, w)
        assert got.dtype == x.dtype
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=rel,
                                   atol=rel * np.abs(ref).max())
        np.testing.assert_allclose(got.float().numpy(), plain, rtol=rel,
                                   atol=rel * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the drivers through the host API
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jmodel,tmodel", [("jnp", "torch"),
                                           ("loops", "loops")])
def test_fd_wave_through_the_host_api_matches_jax(jmodel, tmodel):
    j = jfd.FDWave(model=jmodel, width=32, height=32, radius=2,
                   block=(8, 16)).run(20)
    t = tfd.FDWave(model=tmodel, width=32, height=32, radius=2,
                   block=(8, 16), device="cpu")
    assert t.model == tmodel and t.occa.backend == tmodel
    assert t.fd2d.defines == {k: j.fd2d.defines[k] for k in t.fd2d.defines}
    ptrs = {m.data.data_ptr() for m in (t.o_u1, t.o_u2, t.o_u3)}
    t.run(20)
    assert {m.data.data_ptr() for m in (t.o_u1, t.o_u2, t.o_u3)} == ptrs
    np.testing.assert_allclose(t.solution, j.solution, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("jmodel,tmodel", [("jnp", "torch"),
                                           ("loops", "loops")])
def test_sem_operator_through_the_host_api_matches_jax(jmodel, tmodel):
    kw = dict(ex=2, ey=2, ez=2, n=3, deform=0.1, eb=2)
    j = jsem.SEMOperator(model=jmodel, **kw)
    t = tsem.SEMOperator(model=tmodel, device="cpu", **kw)
    assert t.kernel.defines == dict(E=8, nq=4, eb=2, dtype="float32")
    u = np.random.RandomState(1).randn(j.nglob).astype(np.float32)
    np.testing.assert_allclose(t.apply_global(_t(u)).numpy(),
                               np.asarray(j.apply_global(jnp.asarray(u))),
                               **MM_TOL)


@pytest.mark.parametrize("jmodel,tmodel", [("jnp", "torch"),
                                           ("loops", "loops")])
def test_swe_solver_through_the_host_api_matches_jax(jmodel, tmodel):
    kw = dict(nx=4, ny=4, n=3, jitter=0.0, eb=8)
    j = jdg.SWESolver(model=jmodel, **kw)
    t = tdg.SWESolver(model=tmodel, device="cpu", **kw)
    assert (t.eb, t.surf_eb) == (8, 8)
    Q0 = _swe_state(t.E, t.np_, np.random.RandomState(5), dh=0.05, dm=0.1)
    Qj, Qt = jnp.asarray(Q0), _t(Q0)
    reset_launches()
    for _ in range(10):
        Qj = j.step(Qj, 2e-4)
        Qt = t.step(Qt, 2e-4)
    assert launch_counts() == {name: 0 for name in KERNELS}
    np.testing.assert_allclose(Qt.numpy(), np.asarray(Qj), **MM_TOL)


def test_drivers_take_model_and_refuse_cuda_on_the_cpu():
    for make in (lambda **k: tfd.FDWave(width=8, height=8, **k),
                 lambda **k: tsem.SEMOperator(ex=1, ey=1, ez=1, n=1, **k),
                 lambda **k: tdg.SWESolver(nx=2, ny=2, n=1, **k)):
        assert make(device="cpu").model == "torch"
        assert make(model="loops", device="cpu").occa.backend == "loops"
        with pytest.raises(ValueError, match="on the card"):
            make(model="cuda", device="cpu")


@pytest.mark.parametrize("app", ["fd", "sem", "swe"])
def test_cli_takes_the_model(app):
    extra = {"fd": ["--size", "32", "--steps", "10"],
             "sem": ["--n", "3", "--elems", "2"],
             "swe": ["--nx", "4", "--steps", "3"]}[app]
    out = tapps.main([app, "--model", "loops", "--device", "cpu"] + extra)
    key = out.get("app") or out.get("op") or out.get("solver")
    assert key.model == "loops"
