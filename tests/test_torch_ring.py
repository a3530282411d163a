"""Ring attention in the port against the JAX package, on the CPU: the
exact merge, the step's plain forward and backward, the local ring
(``ring_steps`` chunks in one process), the distributed ring over 2 and 4
spawned gloo ranks, ``gqa_forward`` under ring rules, and the reduced
``llama3_2_1b`` prefill through ``build_prefill_step(ring=True)``.

Every comparison feeds the same numpy inputs (seeded) to both packages;
tolerance 1e-4 throughout (f32 math with sums and merges in another order).
The JAX side runs ``backend="jnp"``, whose local ring its own tests hold
against ``flash_attention`` (``tests/test_mesh_shard.py``). The spawned
ranks import torch and the port only (``_torch_ring_workers.py``); each
spawn has a 60 s rendezvous timeout and a joint deadline, so a hang fails
the test instead of stalling the run.
"""

import dataclasses
import importlib.util
import multiprocessing as mp
import pickle
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ring_workers as workers
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import ring as jax_ring
from repro.kernels.flash_attention import ring_flash
from repro.layers import attention as jax_attn
from repro.models import LM as JaxLM

from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 ring_flash_attention,
                                                 ring_flash_fwd, ring_merge,
                                                 ring_step_ref)
from repro_torch.kernels.flash_attention.ring import _RingStep
from repro_torch.layers import attention as attn

TOL = dict(rtol=1e-4, atol=1e-4)
JKW = dict(causal=True, block_q=32, block_kv=32, backend="jnp")


def _np(t):
    return t.detach().cpu().numpy()


def _qkv(seed, b=1, h=4, hk=2, s=128, d=32):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, s, d).astype("float32"),
            rng.randn(b, hk, s, d).astype("float32"),
            rng.randn(b, hk, s, d).astype("float32"))


def _jax_grads(fn, arrays):
    """o and the q/k/v gradients of (o ** 2).sum() of a JAX attention."""
    o = fn(*arrays)
    g = jax.grad(lambda *a: (fn(*a) ** 2).sum(), argnums=(0, 1, 2))(*arrays)
    return [np.asarray(o)] + [np.asarray(x) for x in g]


def _torch_grads(fn, arrays):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    o = fn(*ts)
    g = torch.autograd.grad((o ** 2).sum(), ts)
    return [_np(o)] + [_np(x) for x in g]


def _assert_all_close(got, want, what=""):
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=f"{what} {name}", **TOL)


# ---------------------------------------------------------------------------
# the merge and one step
# ---------------------------------------------------------------------------

def _partials(seed, dead):
    rng = np.random.RandomState(seed)
    o = [rng.randn(1, 2, 6, 8).astype("float32") for _ in range(2)]
    lse = [rng.randn(1, 2, 6).astype("float32") for _ in range(2)]
    for which, rows in dead:        # partials that saw no key: o = 0
        lse[which][..., rows] = -np.inf
        o[which][..., rows, :] = 0.0
    return o, lse


@pytest.mark.parametrize("dead", [(), ((0, [1, 4]),), ((1, [0, 5]),),
                                  ((0, [2]), (1, [2, 3]))])
def test_ring_merge_matches_jax_with_dead_partials(dead):
    o, lse = _partials(0, dead)
    jo, jl = jax_ring.ring_merge((o[0], lse[0]), (o[1], lse[1]))
    to, tl = ring_merge(*((torch.from_numpy(a), torch.from_numpy(b))
                          for a, b in zip(o, lse)))
    np.testing.assert_allclose(_np(to), np.asarray(jo), **TOL)
    np.testing.assert_array_equal(np.isinf(_np(tl)), np.isinf(np.asarray(jl)))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)

    # gradients through the guarded merge: finite and equal to JAX's
    def jloss(o0, l0, o1, l1):
        m_o, m_l = jax_ring.ring_merge((o0, l0), (o1, l1))
        return (m_o ** 2).sum() + jnp.where(jnp.isinf(m_l), 0.0, m_l).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(o[0], lse[0], o[1], lse[1])
    ts = [torch.from_numpy(a.copy()).requires_grad_(True)
          for a in (o[0], lse[0], o[1], lse[1])]
    m_o, m_l = ring_merge((ts[0], ts[1]), (ts[2], ts[3]))
    loss = (m_o ** 2).sum() + torch.where(torch.isinf(m_l), 0.0, m_l).sum()
    for g, w in zip(torch.autograd.grad(loss, ts), want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


STEP_CASES = {
    "diagonal": dict(q_start=32, k_start=40, causal=True),
    "before": dict(q_start=100, k_start=0, causal=True),
    "after (all masked)": dict(q_start=0, k_start=64, causal=True),
    "window": dict(q_start=48, k_start=40, causal=True, window=13),
    "prefix": dict(q_start=8, k_start=20, causal=True, prefix_len=30),
    "full": dict(q_start=0, k_start=0, causal=False),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_ring_step_ref_and_plain_step_match_jax(case):
    kw = STEP_CASES[case]
    rng = np.random.RandomState(5)
    q = rng.randn(2, 4, 40, 32).astype("float32")
    k = rng.randn(2, 1, 24, 32).astype("float32")
    v = rng.randn(2, 1, 24, 32).astype("float32")
    want = jax_ring.ring_step_ref(q, k, v, **kw)
    got = ring_step_ref(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)

    # the (o, lse) step of the port's wrapper vs the JAX op's kernel
    jo, jl = ring_flash.raw(q, k, v, backend="jnp", block_q=40, block_kv=24,
                            **kw)
    qs, ks = kw["q_start"], kw["k_start"]
    mk = {n: kw[n] for n in ("causal", "window", "prefix_len") if n in kw}
    to, tl = ring_flash_fwd(*map(torch.from_numpy, (q, k, v)),
                            torch.tensor([[qs]], dtype=torch.int32),
                            torch.tensor([[ks]], dtype=torch.int32), **mk)
    np.testing.assert_allclose(_np(to), np.asarray(jo), **TOL)
    np.testing.assert_array_equal(np.isinf(_np(tl)), np.isinf(np.asarray(jl)))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    if case == "after (all masked)":
        assert (_np(to) == 0).all() and np.isneginf(_np(tl)).all()


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_ring_step_backward_matches_jax_vjp(case):
    """_RingStep's backward (flash_delta, delta - g_lse, the step backward)
    against jax.vjp of the JAX ``_ring_step`` with the same cotangents for
    o and lse."""
    kw = STEP_CASES[case]
    rng = np.random.RandomState(6)
    q = rng.randn(1, 4, 40, 32).astype("float32")
    k = rng.randn(1, 2, 24, 32).astype("float32")
    v = rng.randn(1, 2, 24, 32).astype("float32")
    g_o = rng.randn(1, 4, 40, 32).astype("float32")
    g_l = rng.randn(1, 4, 40).astype("float32")
    qs = np.full((1, 1), kw["q_start"], np.int32)
    ks = np.full((1, 1), kw["k_start"], np.int32)
    mk = dict(causal=kw["causal"], window=kw.get("window"), sm_scale=None,
              prefix_len=kw.get("prefix_len", 0))
    frozen = tuple(sorted(dict(mk, block_q=40, block_kv=24, ring_steps=1,
                               mesh_axis="model", backend="jnp",
                               interpret=None).items()))
    (jo, jl), pull = jax.vjp(
        lambda a, b, c: jax_ring._ring_step(frozen, a, b, c, qs, ks), q, k, v)
    want = pull((g_o, g_l))
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (q, k, v)]
    to, tl = _RingStep.apply(*ts, torch.from_numpy(qs), torch.from_numpy(ks),
                             mk["causal"], mk["window"], None,
                             mk["prefix_len"])
    np.testing.assert_allclose(_np(to), np.asarray(jo), **TOL)
    got = torch.autograd.grad((to, tl), ts, (torch.from_numpy(g_o),
                                              torch.from_numpy(g_l)))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=name, **TOL)


# ---------------------------------------------------------------------------
# the local ring (one process)
# ---------------------------------------------------------------------------

LOCAL_CASES = {
    "gqa": (dict(s=128), 4, {}),
    "mha d64": (dict(h=2, hk=2, s=96, d=64), 3, {}),
    "window 48": (dict(s=128), 4, dict(window=48)),
    "prefix 24": (dict(s=128), 4, dict(prefix_len=24)),
    "5 steps, block_kv 40": (dict(s=160), 5, {}),
}


@pytest.mark.parametrize("case", list(LOCAL_CASES))
def test_local_ring_matches_jax_fwd_and_grads(case):
    shape, n, extra = LOCAL_CASES[case]
    arrays = _qkv(2, **shape)
    jkw = dict(JKW, **extra)
    if case.startswith("5 steps"):
        jkw.update(block_q=64, block_kv=40)
    want_ring = _jax_grads(lambda *a: jax_ring.ring_flash_attention(
        *a, ring_steps=n, **jkw), arrays)
    want_flash = _jax_grads(lambda *a: jax_flash(*a, **jkw), arrays)
    got = _torch_grads(lambda *a: ring_flash_attention(
        *a, ring_steps=n, causal=True, **extra), arrays)
    _assert_all_close(got, want_ring, f"{case} vs JAX ring")
    _assert_all_close(got, want_flash, f"{case} vs JAX flash")
    if not extra:   # the port's flash_attention takes no prefix_len
        _assert_all_close(got, _torch_grads(flash_attention, arrays),
                          f"{case} vs port flash")


def test_local_ring_rejects_non_dividing_steps():
    q, k, v = map(torch.from_numpy, _qkv(3))
    with pytest.raises(ValueError, match="does not divide"):
        ring_flash_attention(q, k, v, ring_steps=3)
    with pytest.raises(ValueError, match="does not divide"):
        ring_flash_attention(q, k, v, ring_steps=0)


def _chip_smoke():
    """``chip_smoke.py`` at the repository's root, as a module (its
    imports at load time are the standard library's)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,extra", [(4, {}), (2, dict(window=40)),
                                     (4, dict(prefix_len=24))])
def test_schedule_replay_matches_jax_local_ring(n, extra):
    """The distributed schedule replayed rank by rank (chip_smoke's
    ``ring_schedule_replay``, which holds the schedule on one card): the
    same offsets as the distributed form, held against the JAX local ring
    at n steps."""
    arrays = _qkv(4)
    want = _jax_grads(lambda *a: jax_ring.ring_flash_attention(
        *a, ring_steps=n, **JKW, **extra), arrays)
    replay = _chip_smoke().ring_schedule_replay
    got = _torch_grads(lambda *a: replay(*a, n=n, causal=True, **extra),
                       arrays)
    _assert_all_close(got, want, f"replay n={n} {extra}")


# ---------------------------------------------------------------------------
# the distributed ring over spawned gloo ranks
# ---------------------------------------------------------------------------

RING_CASES = {
    "gqa": (0, {}),
    "window 48": (1, dict(window=48)),
    "prefix 24": (2, dict(prefix_len=24)),
}


def _spawn(tmp, world, jobs, payloads, timeout=240):
    """Run ``jobs`` on ``world`` spawned gloo ranks; their results by job,
    one per rank. Fails (after killing the ranks) on a hang or an error."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=workers.main,
                         args=(r, world, str(tmp / "rdv"), str(tmp), jobs,
                               payloads))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    errs = sorted(tmp.glob("*.err"))
    assert not errs, "\n".join(e.read_text() for e in errs)
    assert not hung, f"{len(hung)} of {world} ranks still running after " \
                     f"{timeout} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    out = {}
    for job in jobs:
        out[job] = []
        for r in range(world):
            with open(tmp / f"{job}_{r}.pkl", "rb") as f:
                out[job].append(pickle.load(f))
    return out


def _ring_payload():
    return {"cases": {name: (_qkv(10 + seed, s=128),
                             dict(causal=True, **extra))
                      for name, (seed, extra) in RING_CASES.items()}}


def _layer_payload():
    cfg = dataclasses.replace(reduced(get_config("llama3_2_1b")), d_model=64,
                              n_heads=4, n_kv_heads=2, head_dim=16)
    rng = np.random.RandomState(7)
    d, h, hk, hd = 64, 4, 2, 16
    params = {n: (rng.randn(*s) * s[0] ** -0.5).astype("float32")
              for n, s in (("wq", (d, h * hd)), ("wk", (d, hk * hd)),
                           ("wv", (d, hk * hd)), ("wo", (h * hd, d)))}
    return dict(cfg=cfg, params=params,
                x=rng.randn(2, 64, d).astype("float32"))


@pytest.fixture(scope="module")
def jax_llama():
    jm = JaxLM(jax_reduced(jax_get_config("llama3_2_1b")))
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _prefill_payload(jax_llama, ring):
    _, jp = jax_llama
    toks = np.random.RandomState(8).randint(
        1, reduced(get_config("llama3_2_1b")).vocab_size, (2, 16))
    return dict(params=jp, tokens=toks, max_len=20, ring=ring)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, jax_llama):
    tmp = tmp_path_factory.mktemp("world2")
    return _spawn(tmp, 2, ["ring", "layer", "prefill"],
                  {"ring": _ring_payload(), "layer": _layer_payload(),
                   "prefill": _prefill_payload(jax_llama, True)})


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world4")
    return _spawn(tmp, 4, ["ring"], {"ring": _ring_payload()})


@pytest.fixture(scope="module")
def world1(tmp_path_factory, jax_llama):
    tmp = tmp_path_factory.mktemp("world1")
    return _spawn(tmp, 1, ["prefill"],
                  {"prefill": _prefill_payload(jax_llama, True)})


def _check_distributed_ring(results, world, case):
    seed, extra = RING_CASES[case]
    arrays = _qkv(10 + seed, s=128)
    want = _jax_grads(lambda *a: jax_ring.ring_flash_attention(
        *a, ring_steps=world, **JKW, **extra), arrays)
    got = [np.concatenate([r[case][j] for r in results], axis=2)
           for j in range(4)]
    _assert_all_close(got, want, f"world {world} {case}")


@pytest.mark.parametrize("case", list(RING_CASES))
def test_distributed_ring_world2_matches_jax(world2, case):
    _check_distributed_ring(world2["ring"], 2, case)


@pytest.mark.parametrize("case", list(RING_CASES))
def test_distributed_ring_world4_matches_jax(world4, case):
    _check_distributed_ring(world4["ring"], 4, case)


@pytest.mark.parametrize("fixture", ["world2", "world4"])
def test_distributed_ring_rejects_contradicting_steps(fixture, request):
    for r in request.getfixturevalue(fixture)["ring"]:
        assert "contradicts" in r["contradicts"], r["contradicts"]


def test_gqa_forward_under_ring_rules_matches_plain(world2):
    """The layer check of the JAX subprocess test: gqa_forward under
    Rules(ring_axis="model") equals it without rules, on every rank, and so
    do the gradients of x and the four projections."""
    p = _layer_payload()
    want = jax_attn.gqa_forward(
        {k: jnp.asarray(v) for k, v in p["params"].items()},
        jnp.asarray(p["x"]), p["cfg"])
    for r in world2["layer"]:
        assert r["ring_axis"] == "model"
        assert r["ring_calls"] == {"plain": 0, "ring": 1}
        np.testing.assert_allclose(r["plain"][0], np.asarray(want), **TOL)
        for a, b in zip(r["ring"], r["plain"]):
            np.testing.assert_allclose(a, b, **TOL)


def test_build_prefill_step_ring_world2_matches_jax(world2, jax_llama):
    jm, jp = jax_llama
    p = _prefill_payload(jax_llama, True)
    jl, jc = jm.prefill(jp, jnp.asarray(p["tokens"], jnp.int32),
                        max_len=p["max_len"])
    n_layers = reduced(get_config("llama3_2_1b")).n_layers
    for r in world2["prefill"]:
        assert r["ring_axis"] == "model" and r["pos"] == int(jc["pos"])
        assert r["ring_calls"] == n_layers       # every layer took the ring
        np.testing.assert_allclose(r["logits"], np.asarray(jl), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(r[key],
                                       np.asarray(jc["stacks"][0][key]),
                                       **TOL)


def test_make_shardings_world1_leaves_ring_axis_none(world1, jax_llama):
    """One rank: the ring is off (as ``make_shardings`` and
    ``ring_axis_for`` turn it off for a one-shard axis) and the prefill is
    the one-device prefill."""
    jm, jp = jax_llama
    p = _prefill_payload(jax_llama, True)
    jl, _ = jm.prefill(jp, jnp.asarray(p["tokens"], jnp.int32),
                       max_len=p["max_len"])
    r, = world1["prefill"]
    assert r["ring_axis"] is None and r["ring_calls"] == 0
    np.testing.assert_allclose(r["logits"], np.asarray(jl), **TOL)


def test_ring_axis_for_and_rules_without_a_mesh():
    from repro_torch.parallel import Rules, current_rules, ring_axis_for
    from repro_torch.parallel import use_rules

    assert ring_axis_for(None, 64) is None
    assert current_rules() is None
    rules = Rules(mesh=None, ring_axis="model")
    with use_rules(rules):
        assert current_rules() is rules
        assert attn._ring_target(64) == (None, None)   # no mesh: no ring
    assert current_rules() is None
