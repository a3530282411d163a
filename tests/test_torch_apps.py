"""The paper apps of the PyTorch port against the JAX package, on the CPU.

Inputs come from numpy with a seed and go through the JAX function and the
port's counterpart. The numerics copy and the apps' host-built arrays
(their "weights") must be bit-equal; each kernel's plain version is held
against the JAX oracle and against the JAX app running its Pallas kernel
(interpret mode) with ``tests/test_apps.py``'s tolerances: 2e-5 for the FD
step (a short stencil sum in f32), 2e-4 for the SEM and DG contractions
(f32 sums in another order). Whole-slice runs compare 20 FD steps and 50
LSERK steps (1e-4, 2e-4), the assembled SEM operator (2e-4) and the PCG
solve. A persisted autotune winner could change the JAX apps' blocks, so
every test points ``REPRO_CACHE_DIR`` at an empty directory.
"""

import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import dg_swe as jdg
from repro.apps import fd2d as jfd
from repro.apps import numerics as jnum
from repro.apps import sem as jsem

from repro_torch.apps import dg_swe as tdg
from repro_torch.apps import fd2d as tfd
from repro_torch.apps import numerics as tnum
from repro_torch.apps import sem as tsem
from repro_torch.kernels import KERNELS, launch_counts, reset_launches
from repro_torch.kernels.apps import (dg_surface, dg_volume, fd2d,
                                      sem_apply)
from repro_torch.launch import apps as tapps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FD_TOL = dict(rtol=2e-5, atol=2e-5)
MM_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _no_persisted_winners(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _swe_state(E, np_, rng, *, dh=0.1, dm=0.3):
    return np.stack([2.0 + dh * rng.randn(E, np_), dm * rng.randn(E, np_),
                     dm * rng.randn(E, np_)], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# numerics: a verbatim copy
# ---------------------------------------------------------------------------

def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n", range(1, 7))
@pytest.mark.filterwarnings("ignore:invalid value encountered")
def test_numerics_copy_equals_jax_package(n):
    x = np.linspace(-1, 1, 9)
    for alpha, beta in ((0.0, 0.0), (1.0, 1.0), (2.0 * n + 1.0, 0.0)):
        for fn in ("jacobi_p", "grad_jacobi_p"):
            _same(getattr(tnum, fn)(x, alpha, beta, n),
                  getattr(jnum, fn)(x, alpha, beta, n))
        _same(tnum.jacobi_gq(alpha, beta, n), jnum.jacobi_gq(alpha, beta, n))
        _same(tnum.jacobi_gl(alpha, beta, n), jnum.jacobi_gl(alpha, beta, n))
    for fn in ("gll_nodes_weights", "dmatrix_1d",
               "fd_second_derivative_weights", "triangle_nodes"):
        _same(getattr(tnum, fn)(n), getattr(jnum, fn)(n))
    _same(tnum.vandermonde_1d(n, x), jnum.vandermonde_1d(n, x))
    r, s = jnum.triangle_nodes(n)
    _same(tnum.vandermonde_2d(n, r, s), jnum.vandermonde_2d(n, r, s))
    _same(tnum.dmatrices_2d(n, r, s), jnum.dmatrices_2d(n, r, s))
    fmask = jnum.face_mask(n, r, s)
    _same(tnum.face_mask(n, r, s), fmask)
    V = jnum.vandermonde_2d(n, r, s)
    _same(tnum.lift_matrix(n, r, s, V, fmask),
          jnum.lift_matrix(n, r, s, V, fmask))


# ---------------------------------------------------------------------------
# the apps' host-built arrays: bit-equal ("weights carried across")
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius", [1, 2, 4])
def test_fd_driver_arrays_equal_jax(radius):
    j = jfd.FDWave(model="jnp", width=32, height=48, radius=radius,
                   block=(16, 16))
    t = tfd.FDWave(width=32, height=48, radius=radius, block=(16, 16),
                   device="cpu")
    assert t.weights == j.weights
    assert (t.dx, t.dt, t.omega) == (j.dx, j.dt, j.omega)
    np.testing.assert_array_equal(_np(t.u1), np.asarray(j.o_u1.data))
    np.testing.assert_array_equal(_np(t.u2), np.asarray(j.o_u2.data))
    np.testing.assert_array_equal(t.analytic(), j.analytic())


@pytest.mark.parametrize("kw", [dict(ex=2, ey=2, ez=1, n=3, deform=0.12),
                                dict(ex=1, ey=2, ez=3, n=2, deform=0.0,
                                     alpha=2.5)])
def test_sem_driver_arrays_equal_jax(kw):
    j = jsem.SEMOperator(model="jnp", eb=2, **kw)
    t = tsem.SEMOperator(device="cpu", **kw)
    np.testing.assert_array_equal(_np(t.geo), np.asarray(j.o_geo.data))
    np.testing.assert_array_equal(_np(t.dmat), np.asarray(j.o_dmat.data))
    np.testing.assert_array_equal(t.gid, j.gid)
    np.testing.assert_array_equal(_np(t.gid_t), np.asarray(j.gid_j))
    np.testing.assert_array_equal(t.mass, j.mass)
    assert (t.E, t.nglob, t.nq) == (j.E, j.nglob, j.nq)


@pytest.mark.parametrize("kw", [dict(nx=4, ny=4, n=3, jitter=0.2),
                                dict(nx=3, ny=3, n=2, jitter=0.0)])
def test_dg_driver_arrays_equal_jax(kw):
    bath = lambda x, y: 0.15 * x + 0.1 * y + 0.4  # noqa: E731
    j = jdg.SWESolver(model="jnp", bathymetry=bath, **kw)
    t = tdg.SWESolver(bathymetry=bath, device="cpu", **kw)
    pairs = [(t.geom, j.o_geom.data), (t.db, j.o_db.data),
             (t.dr, j.o_dr.data), (t.ds, j.o_ds.data),
             (t.nrm, j.o_nrm.data), (t.lift, j.o_lift.data),
             (t.vmapM, j.vmapM), (t.vmapP, j.vmapP), (t.bnd, j.bnd),
             (t.nrm_xy, j.nrm_j)]
    for a, b in pairs:
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_array_equal(t.dB, j.dB)
    assert (t.E, t.np_, t.nfp3) == (j.E, j.np_, j.nfp3)
    assert (tdg._LSERK_A, tdg._LSERK_B) == (jdg._LSERK_A, jdg._LSERK_B)


# ---------------------------------------------------------------------------
# each kernel's plain version vs the JAX oracle and the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius", [1, 2])
def test_fd_step_matches_jax(radius):
    j = jfd.FDWave(model="pallas", width=32, height=48, radius=radius,
                   block=(16, 16))
    rng = np.random.RandomState(radius)
    u1 = rng.standard_normal((48, 32)).astype(np.float32)
    u2 = rng.standard_normal((48, 32)).astype(np.float32)
    j.o_u1, j.o_u2 = j.device.malloc(u1), j.device.malloc(u2)
    j.fd2d(j.o_u1, j.o_u2, j.o_u3)
    ref = jfd.reference_step(jnp.asarray(u1), jnp.asarray(u2), j.weights,
                             j.dx, j.dt)
    out = torch.empty((48, 32))
    got = fd2d(_t(u1), _t(u2), weights=j.weights, dx=j.dx, dt=j.dt, out=out)
    assert got is out
    np.testing.assert_allclose(_np(got), np.asarray(ref), **FD_TOL)
    np.testing.assert_allclose(_np(got), j.o_u3.to_host(), **FD_TOL)


def test_sem_apply_matches_jax():
    j = jsem.SEMOperator(model="pallas", ex=2, ey=2, ez=1, n=3, deform=0.12,
                         eb=2)
    t = tsem.SEMOperator(ex=2, ey=2, ez=1, n=3, deform=0.12, device="cpu")
    u = np.random.RandomState(0).randn(j.E, j.nq, j.nq, j.nq).astype(
        np.float32)
    got = _np(t.apply_local(_t(u)))
    ref = jsem.apply_ref(jnp.asarray(u), j.o_geo.data, j.o_dmat.data)
    np.testing.assert_allclose(got, np.asarray(ref), **MM_TOL)
    np.testing.assert_allclose(got, np.asarray(j.apply_local(u)), **MM_TOL)


def test_dg_volume_matches_jax():
    bath = lambda x, y: 0.2 * x - 0.1 * y  # noqa: E731
    j = jdg.DGVolume(model="pallas", nx=4, ny=4, n=3, jitter=0.2, eb=8,
                     bathymetry=bath)
    t = tdg.DGVolume(nx=4, ny=4, n=3, jitter=0.2, bathymetry=bath,
                     device="cpu")
    Q = _swe_state(j.E, j.np_, np.random.RandomState(3))
    got = _np(t.rhs_volume(_t(Q)))
    ref = jdg.volume_ref(jnp.asarray(Q), j.o_geom.data, j.o_db.data,
                         j.o_dr.data, j.o_ds.data)
    np.testing.assert_allclose(got, np.asarray(ref), **MM_TOL)
    np.testing.assert_allclose(got, np.asarray(j.rhs_volume(Q)), **MM_TOL)


def test_dg_surface_matches_jax():
    j = jdg.SWESolver(model="pallas", nx=3, ny=3, n=2, jitter=0.0)
    t = tdg.SWESolver(nx=3, ny=3, n=2, jitter=0.0, device="cpu")
    rng = np.random.RandomState(4)
    qm = _swe_state(j.E, j.nfp3, rng, dh=0.05, dm=0.1)
    qp = _swe_state(j.E, j.nfp3, rng, dh=0.05, dm=0.1)
    got = _np(dg_surface(_t(qm), _t(qp), t.nrm, t.lift))
    ref = jdg.surface_ref(jnp.asarray(qm), jnp.asarray(qp), j.o_nrm.data,
                          j.o_lift.data)
    (pallas,) = j.surf_kernel.run(jnp.asarray(qm), jnp.asarray(qp),
                                  j.o_nrm.data, j.o_lift.data)
    np.testing.assert_allclose(got, np.asarray(ref), **MM_TOL)
    np.testing.assert_allclose(got, np.asarray(pallas), **MM_TOL)
    # the whole right-hand side (face gather, wall mirror, both kernels)
    Q = _swe_state(j.E, j.np_, rng, dh=0.05, dm=0.1)
    np.testing.assert_allclose(_np(t.rhs(_t(Q))),
                               np.asarray(j.rhs(jnp.asarray(Q))), **MM_TOL)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def test_fd_wave_run_matches_jax():
    j = jfd.FDWave(model="jnp", width=32, height=32, radius=1,
                   block=(8, 8)).run(20)
    t = tfd.FDWave(width=32, height=32, radius=1, block=(8, 8),
                   device="cpu").run(20)
    assert t.current_time == j.current_time
    np.testing.assert_allclose(t.solution, j.solution, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t.analytic(), j.analytic(), rtol=0, atol=0)


def test_fd_wave_rotates_three_buffers_in_place():
    t = tfd.FDWave(width=16, height=24, radius=2, device="cpu")
    ptrs = {b.data_ptr() for b in (t.u1, t.u2, t.u3)}
    prev = t.u1.clone()
    t.timestep()
    assert {b.data_ptr() for b in (t.u1, t.u2, t.u3)} == ptrs
    assert torch.equal(t.u2, prev)


def test_sem_apply_global_matches_jax():
    j = jsem.SEMOperator(model="jnp", ex=2, ey=2, ez=2, n=3, deform=0.1,
                         eb=2)
    t = tsem.SEMOperator(ex=2, ey=2, ez=2, n=3, deform=0.1, device="cpu")
    u = np.random.RandomState(1).randn(j.nglob).astype(np.float32)
    np.testing.assert_allclose(_np(t.apply_global(_t(u))),
                               np.asarray(j.apply_global(jnp.asarray(u))),
                               **MM_TOL)


def _example_pcg():
    path = os.path.join(ROOT, "examples", "sem_solve.py")
    spec = importlib.util.spec_from_file_location("_sem_solve_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.pcg


def test_pcg_solve_matches_jax():
    # tol 1e-5: the example's 1e-7 sits at the f32 rounding floor of the
    # residual, where the iteration that first dips below it is decided by
    # summation order (both packages wander between 3e-8 and 5e-7 there)
    n, e, tol = 4, 2, 1e-5
    (x, y, z), _, _ = jsem.make_box_mesh(e, e, e, n, deform=0.0)
    u_star = np.cos(np.pi * x) * np.cos(np.pi * y) * np.cos(np.pi * z)
    f = (3 * np.pi ** 2 + 1.0) * u_star
    t = tsem.SEMOperator(ex=e, ey=e, ez=e, n=n, deform=0.0, alpha=1.0,
                         device="cpu")
    rhs_t = tsem.scatter_add(_t((t.mass * f).astype(np.float32)), t.gid_t,
                             t.nglob)
    diag_t = tsem.scatter_add(_t(t.mass.astype(np.float32)), t.gid_t,
                              t.nglob)
    u_t, iters_t = tapps.pcg(t.apply_global, rhs_t, 1.0 / diag_t, tol=tol)
    j = jsem.SEMOperator(model="jnp", ex=e, ey=e, ez=e, n=n, deform=0.0,
                         alpha=1.0, eb=2)
    rhs = jsem.scatter_add(jnp.asarray((j.mass * f).astype(np.float32)),
                           j.gid_j, j.nglob)
    diag = jsem.scatter_add(jnp.asarray(j.mass.astype(np.float32)), j.gid_j,
                            j.nglob)
    u, iters = _example_pcg()(j.apply_global, rhs, 1.0 / diag, tol=tol)
    assert abs(iters_t - iters) <= 1, (iters_t, iters)
    np.testing.assert_allclose(_np(u_t), np.asarray(u), rtol=0, atol=1e-4)
    err = np.abs(_np(tsem.gather(u_t, t.gid_t)) - u_star).max()
    assert err < 0.05


def test_swe_steps_match_jax_and_conserve_mass():
    kw = dict(nx=4, ny=4, n=3, jitter=0.0)
    j = jdg.SWESolver(model="jnp", **kw)
    t = tdg.SWESolver(device="cpu", **kw)
    x, y = j.mesh["x"], j.mesh["y"]
    h0 = 1.0 + 0.1 * np.exp(-20 * (x ** 2 + y ** 2))
    Q0 = np.stack([h0, 0 * h0, 0 * h0], -1).astype(np.float32)
    Qj, Qt = jnp.asarray(Q0), _t(Q0)
    m0 = t.mass(Qt)
    for _ in range(50):
        Qj = j.step(Qj, 2e-4)
        Qt = t.step(Qt, 2e-4)
    np.testing.assert_allclose(_np(Qt), np.asarray(Qj), **MM_TOL)
    assert np.isfinite(_np(Qt)).all()
    assert abs(t.mass(Qt) - m0) / m0 < 1e-5
    assert abs(m0 - float(j.mass(jnp.asarray(Q0)))) / m0 < 1e-6


def test_stable_dt_follows_mesh_and_wave_speed():
    t = tdg.SWESolver(nx=4, ny=4, n=3, jitter=0.0, device="cpu")
    Q = torch.zeros((t.E, t.np_, 3))
    Q[..., 0] = 1.0
    c = float(np.sqrt(tdg.GRAV))
    assert tdg.stable_dt(t, Q) == pytest.approx(0.5 * 0.5 / (16 * c))
    Q[..., 1] = 2.0                       # |u| = 2 adds to the speed
    assert tdg.stable_dt(t, Q) == pytest.approx(0.5 * 0.5 / (16 * (c + 2)))


@pytest.mark.parametrize("argv,key,limit", [
    (["fd"], "err", 5e-2), (["sem"], "err", 0.05), (["swe"], "drift", 1e-5)])
def test_cli_on_cpu_meets_the_examples_assertions(argv, key, limit):
    out = tapps.main(argv + ["--device", "cpu"])
    assert out[key] < limit


# ---------------------------------------------------------------------------
# devices and wrappers
# ---------------------------------------------------------------------------

def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: tfd.FDWave(), lambda: tsem.SEMOperator(),
             lambda: tdg.DGVolume(), lambda: tdg.SWESolver(),
             lambda: tapps.fd_wave(), lambda: tapps.sem_solve(),
             lambda: tapps.swe_run(), lambda: tapps.main(["swe"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_cpu_calls_do_not_count_as_launches():
    reset_launches()
    t = tdg.SWESolver(nx=2, ny=2, n=1, device="cpu")
    t.step(_t(_swe_state(t.E, t.np_, np.random.RandomState(0))), 1e-4)
    op = tsem.SEMOperator(ex=1, ey=1, ez=1, n=1, device="cpu")
    op.apply_global(torch.ones(op.nglob))
    tfd.FDWave(width=8, height=8, device="cpu").run(2)
    assert launch_counts() == {name: 0 for name in KERNELS}


def test_app_wrappers_raise_on_other_dtypes_and_devices():
    f64 = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        fd2d(f64, f64, weights=(1.0, -2.0, 1.0), dx=0.5, dt=0.1)
    u = torch.zeros((2, 3, 3, 3))
    with pytest.raises(ValueError, match="float32"):
        sem_apply(u, torch.zeros((2, 7, 3, 3, 3)), torch.zeros((3, 3),
                                                                dtype=torch.float64))
    m = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fd2d(torch.empty((4, 4), **m), torch.empty((4, 4), **m),
             weights=(1.0, -2.0, 1.0), dx=0.5, dt=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        sem_apply(torch.empty((2, 3, 3, 3), **m),
                  torch.empty((2, 7, 3, 3, 3), **m), torch.empty((3, 3), **m))
    with pytest.raises(ValueError, match="CUDA"):
        dg_volume(torch.empty((2, 3, 3), **m), torch.empty((2, 4), **m),
                  torch.empty((2, 3, 2), **m), torch.empty((3, 3), **m),
                  torch.empty((3, 3), **m))
    with pytest.raises(ValueError, match="CUDA"):
        dg_surface(torch.empty((2, 6, 3), **m), torch.empty((2, 6, 3), **m),
                   torch.empty((2, 6, 3), **m), torch.empty((3, 6), **m))
    with pytest.raises(ValueError, match="weights"):
        fd2d(torch.zeros((4, 4)), torch.zeros((4, 4)), weights=(1.0, -2.0),
             dx=0.5, dt=0.1)


def test_apps_path_loads_no_jax_module():
    code = ("import sys\n"
            "from repro_torch.launch.apps import main\n"
            "for argv in (['fd', '--size', '16', '--steps', '4'],\n"
            "             ['sem', '--n', '4', '--elems', '2'],\n"
            "             ['swe', '--nx', '2', '--n', '1', '--steps', '2']):\n"
            "    main(argv + ['--device', 'cpu'])\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stderr[-2000:]
