"""The port's sharded steps on spawned gloo ranks (2 and 4, CPU) against
the single-device JAX functions on the same weights (``from_jax_params``
of one JAX init), at the reduced f32 configs:

- ``build_prefill_step`` on a (1, 2) mesh: the logits;
- ``Engine(mesh=)`` on (1, 2) and (2, 2): the greedy tokens of JAX's
  ``Engine`` on traffic that refills slots mid-flight;
- ``generate(mesh=)`` on the static path at (1, 2) and (2, 2): JAX's
  prefill + ``greedy_step`` loop;
- ``build_train_step`` at (1, 2), (2, 1) with zero1, (2, 1) with fsdp and
  (2, 2) with accum_steps=2 (llama3_2_1b), and (2, 1) on deepseek_v2_lite
  (MoE: the router's statistics are global-batch means): two steps'
  losses, gradient norms and parameters against JAX's jitted step;
- ``TrainLoop(mesh=, zero1=True)`` at (2, 1), resuming JAX's init from a
  step-0 checkpoint: its history against JAX's step over the same data.

JAX's sharded serve path and its own ``TrainLoop`` fail on this JAX
version (the reference failures of ROADMAP C); sharding does not change
the function, so the single-device JAX functions are the references.
Tolerance 1e-4 throughout; AdamW's eps is 1e-6 on both sides (see
``test_torch_train_step.py``). The ranks import torch and the port only
(``_torch_mesh_workers.py``); each spawn has a 60 s rendezvous timeout
and a joint deadline.
"""

import dataclasses
import functools
import multiprocessing as mp
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_workers as workers
from repro.checkpoint import CheckpointManager as JaxCkpt
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data import SyntheticLMData as JaxData
from repro.launch.mesh import make_local_mesh
from repro.models import LM as JaxLM
from repro.optim import AdamW as JaxAdamW
from repro.optim import WarmupCosine as JaxWarmupCosine
from repro.parallel.steps import build_train_step as jax_build_train_step
from repro.serving import Engine as JaxEngine

TOL = dict(rtol=1e-4, atol=1e-4)
EPS = 1e-6
B, S = 4, 16


def spawn(tmp, world, jobs, payloads, timeout=240):
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


_INIT = {}


def jax_model(arch="llama3_2_1b", **changes):
    """(JAX LM, its params as numpy) of reduced ``arch`` with the config
    ``changes`` (drawn once)."""
    cfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), **changes)
    jm = JaxLM(cfg)
    key = (arch, tuple(sorted(changes.items())))
    if key not in _INIT:
        _INIT[key] = jax.tree.map(
            np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    return jm, _INIT[key]


def _traffic(vocab):
    rng = np.random.default_rng(3)
    return [(rng.integers(0, vocab, size=n).tolist(), m)
            for n, m in ((5, 6), (9, 4), (3, 7), (7, 5))]


ENGINE = dict(batch=2, max_len=32, page_size=8)


def _batches(vocab, n=2):
    rng = np.random.default_rng(7)
    return [{"tokens": rng.integers(0, vocab, (B, S + 1)).astype(np.int32)}
            for _ in range(n)]


def _prompts(vocab, b):
    return np.random.RandomState(4).randint(0, vocab, (b, 5)).astype(
        np.int32)


# (mesh, options, arch, config changes): zero1 and fsdp shard a replicated
# dim only from 1024 rows, so those cases take d_model 1024
WIDE = dict(d_model=1024)
TRAINS = {"train:12": ((1, 2), {}, "llama3_2_1b", {}),
          "train:21z": ((2, 1), dict(zero1=True), "llama3_2_1b", WIDE),
          "train:21f": ((2, 1), dict(fsdp=True), "llama3_2_1b", WIDE),
          "train:moe": ((2, 1), {}, "deepseek_v2_lite", {}),
          "train:22a": ((2, 2), dict(accum_steps=2), "llama3_2_1b", {})}


def _payloads(tmp, world):
    jm, jp = jax_model()
    vocab = jm.cfg.vocab_size
    p = {}
    if world == 2:
        p["prefill"] = dict(mesh=(1, 2), params=jp, max_len=20,
                            tokens=_prompts(vocab, 2).astype(np.int64))
        p["engine:12"] = dict(mesh=(1, 2), params=jp, engine=ENGINE,
                              traffic=_traffic(vocab))
        p["static:12"] = dict(mesh=(1, 2), params=jp, gen=6,
                              prompts=_prompts(vocab, 2))
        p["loop:21"] = dict(mesh=(2, 1), params=jp, loop=dict(
            global_batch=B, seq_len=S, steps=3, ckpt_dir=str(tmp / "loop"),
            ckpt_every=100, zero1=True))
        names = ("train:12", "train:21z", "train:21f", "train:moe")
    else:
        p["engine:22"] = dict(mesh=(2, 2), params=jp, engine=ENGINE,
                              traffic=_traffic(vocab))
        p["static:22"] = dict(mesh=(2, 2), params=jp, gen=6,
                              prompts=_prompts(vocab, 4))
        names = ("train:22a",)
    for name in names:
        mesh, options, arch, changes = TRAINS[name]
        _, params = jax_model(arch, **changes)
        p[name] = dict(mesh=mesh, arch=arch, params=params, options=options,
                       batches=_batches(vocab), cfg_changes=changes)
    return p


def _jax_loop_checkpoint(tmp):
    """JAX's init as a step-0 checkpoint for the TrainLoop job."""
    jm, jp = jax_model()
    jopt = JaxAdamW(schedule=JaxWarmupCosine(peak_lr=3e-3, warmup_steps=5,
                                             total_steps=3))
    JaxCkpt(str(tmp / "loop")).save(0, (jax.tree.map(jnp.asarray, jp),
                                        jopt.init(jp)), async_=False)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh2")
    _jax_loop_checkpoint(tmp)
    p = _payloads(tmp, 2)
    return spawn(tmp, 2, list(p), p)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh4")
    p = _payloads(tmp, 4)
    return spawn(tmp, 4, list(p), p)


def test_prefill_logits_match_jax_at_1x2(world2):
    jm, jp = jax_model()
    toks = _prompts(jm.cfg.vocab_size, 2)
    want, _ = jm.prefill(jax.tree.map(jnp.asarray, jp), jnp.asarray(toks),
                         max_len=20)
    for r in world2["prefill"]:
        assert r["tp"]
        # this rank's kv heads: 2 of reduced llama's 2 x 2, one a rank
        assert r["k_shape"][2] == jm.cfg.n_kv_heads // 2
        np.testing.assert_allclose(r["logits"], np.asarray(want), **TOL)


@functools.lru_cache(maxsize=None)
def _jax_engine_tokens():
    jm, jp = jax_model()
    eng = JaxEngine(jm, jax.tree.map(jnp.asarray, jp), **ENGINE)
    traffic = _traffic(jm.cfg.vocab_size)
    rids = [eng.submit(p, m) for p, m in traffic]
    out = eng.drain(max_steps=500)
    return [out[r] for r in rids]


@pytest.mark.parametrize("mesh", ["12", "22"])
def test_engine_tokens_match_jax(world2, world4, mesh):
    want = _jax_engine_tokens()
    res = (world2 if mesh == "12" else world4)[f"engine:{mesh}"]
    for r in res:
        assert r["tokens"] == want
        assert r["eager"]
        assert r["pool"][2] == 1        # (n, pages, kv heads / 2, page, hd)


def _jax_static(b, gen=6):
    jm, jp = jax_model()
    jp = jax.tree.map(jnp.asarray, jp)
    toks = _prompts(jm.cfg.vocab_size, b)
    logits, cache = jm.prefill(jp, jnp.asarray(toks), max_len=5 + gen)
    tok = jnp.argmax(logits[:, :jm.cfg.vocab_size], axis=-1)
    step = jax.jit(jm.greedy_step)
    out = []
    for _ in range(gen):
        out.append(np.asarray(tok))
        tok, _, cache = step(jp, tok[:, None], cache)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("mesh,b", [("12", 2), ("22", 4)])
def test_static_generate_matches_jax(world2, world4, mesh, b):
    want = _jax_static(b)
    for r in (world2 if mesh == "12" else world4)[f"static:{mesh}"]:
        assert not r["engine"]
        np.testing.assert_array_equal(r["tokens"], want)


@functools.lru_cache(maxsize=None)
def _jax_train(arch, accum_steps=1, changes=()):
    jm, jp = jax_model(arch, **dict(changes))
    jp = jax.tree.map(jnp.asarray, jp)
    jopt = JaxAdamW(schedule=JaxWarmupCosine(peak_lr=3e-3, warmup_steps=2,
                                             total_steps=3), eps=EPS)
    state = jopt.init(jp)
    step, _ = jax_build_train_step(jm, jopt, make_local_mesh(),
                                   accum_steps=accum_steps)
    losses, norms = [], []
    for bt in _batches(jax_model()[0].cfg.vocab_size):
        jp, state, loss, met = step(jp, state, {
            k: jnp.asarray(v) for k, v in bt.items()})
        losses.append(float(loss))
        norms.append(float(met["grad_norm"]))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    mflat = jax.tree_util.tree_flatten_with_path(state["m"])[0]
    return (losses, norms,
            {jax.tree_util.keystr(p): np.asarray(a) for p, a in flat},
            {jax.tree_util.keystr(p): np.asarray(a) for p, a in mflat})


@pytest.mark.parametrize("job", list(TRAINS))
def test_train_step_matches_jax(world2, world4, job):
    mesh, options, arch, changes = TRAINS[job]
    losses, norms, params, moments = _jax_train(
        arch, options.get("accum_steps", 1), tuple(sorted(changes.items())))
    res = (world4 if mesh == (2, 2) else world2)[job]
    for r in res:
        assert r["stats"]["eager"] and r["stats"]["steps"] == 2
        assert r["step"] == 2
        np.testing.assert_allclose(r["losses"], losses, **TOL)
        np.testing.assert_allclose(r["norms"], norms, **TOL)
        assert sorted(r["params"]) == sorted(params)
        for k, v in params.items():
            np.testing.assert_allclose(r["params"][k], v, **TOL,
                                       err_msg=f"{job} {k}")
        for k, v in moments.items():
            np.testing.assert_allclose(r["m"][k], v, **TOL,
                                       err_msg=f"{job} m {k}")
    # fsdp keeps parameters sliced at rest, zero1 only the moments
    full = [tuple(v.shape) for k, v in sorted(params.items())]
    if options.get("fsdp"):
        assert res[0]["local_shapes"] != full
        assert res[0]["local_shapes"] == res[0]["moment_shapes"]
    if options.get("zero1"):
        assert res[0]["moment_shapes"] != full
    if mesh[1] > 1:        # tensor parallel: the embedding is a vocab shard
        vpad = params["['embed']"].shape[0]
        assert (vpad // mesh[1], params["['embed']"].shape[1]) in \
            res[0]["local_shapes"]


def test_trainloop_on_a_mesh_matches_jax_history(world2):
    jm, jp = jax_model()
    jp = jax.tree.map(jnp.asarray, jp)
    jopt = JaxAdamW(schedule=JaxWarmupCosine(peak_lr=3e-3, warmup_steps=5,
                                             total_steps=3))
    state = jopt.init(jp)
    data = JaxData(vocab_size=jm.cfg.vocab_size, seq_len=S, global_batch=B)
    grad_fn = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    update = jax.jit(jopt.update)
    want = []
    for step in range(3):
        (loss, _), g = grad_fn(jp, {"tokens": jnp.asarray(data.batch(step))})
        jp, state, _ = update(g, state, jp)
        want.append(float(loss))
    for r in world2["loop:21"]:
        np.testing.assert_allclose(r["history"], want, **TOL)
