"""The test process's side of the tensor-parallel tests
(``test_torch_tp_*.py``): the reduced configs' weights, the spawned gloo
ranks (``_torch_tp_workers``), and the single-device JAX functions the
ranks' results are held against. Each case's weights are one draw of the
port's init at seed 0 (numpy): the ranks take them through
``from_jax_params`` and JAX takes the same arrays, so both run on the same
weights. JAX's own sharded serve and train paths are among the reference
failures (ROADMAP C); sharding does not change the function.
"""

import dataclasses
import multiprocessing as mp
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np

import _torch_tp_workers as workers
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import LM as JaxLM
from repro.optim import AdamW as JaxAdamW
from repro.optim import WarmupCosine as JaxWarmupCosine
from repro.serving import Engine as JaxEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE = dict(batch=2, max_len=32, page_size=8)
_CASES = {}


def case(arch, **changes):
    """(JAX LM, params as numpy, changes) of reduced ``arch`` with the
    config ``changes``, given to both packages through
    ``dataclasses.replace`` (drawn once)."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import LM

    key = (arch, tuple(sorted(changes.items())))
    if key not in _CASES:
        cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
        tp = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        params = _numpy(tp)
        jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)),
                                   **changes)
        _CASES[key] = (JaxLM(jcfg), params, changes)
    return _CASES[key]


def _numpy(t):
    if isinstance(t, dict):
        return {k: _numpy(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_numpy(v) for v in t]
    return t.detach().numpy().copy()


def jparams(params):
    return jax.tree.map(jnp.asarray, params)


def prompts(vocab, b, n, seed=4):
    return np.random.RandomState(seed).randint(0, vocab, (b, n)).astype(
        np.int32)


def prefix(cfg, b, seed=5):
    if not cfg.num_prefix_embeddings:
        return None
    return np.random.RandomState(seed).randn(
        b, cfg.num_prefix_embeddings, cfg.d_model).astype(np.float32)


def batches(cfg, b, s, n=2, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bt = {"tokens": rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(
            np.int32)}
        p = prefix(cfg, b, seed=seed + len(out))
        if p is not None:
            bt["prefix_embeddings"] = p
        out.append(bt)
    return out


def traffic(vocab):
    """Four requests on an engine of two slots, so slots refill mid-flight;
    the prompts of one length, so JAX's engine compiles one prefill."""
    rng = np.random.default_rng(3)
    return [(rng.integers(0, vocab, size=6).tolist(), m) for m in (5, 3, 6, 4)]


class Ranks:
    """``world`` spawned gloo ranks running ``jobs``; :meth:`join` returns
    their results by job, one per rank (after killing them on a hang or
    an error, it fails)."""

    def __init__(self, tmp, world, jobs, payloads, timeout=240):
        self.tmp, self.world, self.jobs = tmp, world, list(jobs)
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=workers.main,
                                  args=(r, world, str(tmp / "rdv"), str(tmp),
                                        self.jobs, payloads))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout
        self._out = None

    def join(self):
        if self._out is not None:
            return self._out
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        hung = [p for p in self.procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        errs = sorted(self.tmp.glob("*.err"))
        assert not errs, "\n".join(e.read_text() for e in errs)
        assert not hung, f"{len(hung)} of {self.world} ranks still running"
        assert all(p.exitcode == 0 for p in self.procs), \
            [p.exitcode for p in self.procs]
        out = {}
        for job in self.jobs:
            out[job] = []
            for r in range(self.world):
                with open(self.tmp / f"{job}_{r}.pkl", "rb") as f:
                    out[job].append(pickle.load(f))
        self._out = out
        return out


def run(tmp, world, payloads, references):
    """Start the ranks on ``payloads``, compute ``references`` (a dict of
    no-argument functions: the JAX side) while they run, then join them:
    (the ranks' results by job, the references by key)."""
    ranks = Ranks(tmp, world, list(payloads), payloads)
    want = {k: fn() for k, fn in references.items()}
    return ranks.join(), want


def jax_prefill(jm, params, toks, pre, max_len):
    logits, _ = jm.prefill(jparams(params), jnp.asarray(toks),
                           prefix_embeddings=None if pre is None
                           else jnp.asarray(pre), max_len=max_len)
    return np.asarray(logits)


def jax_static(jm, params, toks, gen, pre=None, max_len=None):
    """JAX's prefill (optionally with the prefix) and jitted greedy_step
    loop: ((B, gen) tokens, the prefill's logits)."""
    jp = jparams(params)
    max_len = max_len or toks.shape[1] + gen + (
        0 if pre is None else pre.shape[1])
    logits, cache = jm.prefill(jp, jnp.asarray(toks),
                               prefix_embeddings=None if pre is None
                               else jnp.asarray(pre), max_len=max_len)
    first = np.asarray(logits)
    tok = jnp.argmax(logits[:, :jm.cfg.vocab_size], axis=-1)
    step = jax.jit(jm.greedy_step)
    out = []
    for _ in range(gen):
        out.append(np.asarray(tok))
        tok, _, cache = step(jp, tok[:, None], cache)
    return np.stack(out, axis=1), first


def jax_engine(jm, params, traffic_, engine=ENGINE):
    eng = JaxEngine(jm, jparams(params), **engine)
    rids = [eng.submit(p, m) for p, m in traffic_]
    out = eng.drain(max_steps=500)
    return [out[r] for r in rids]


def optimizer_kw():
    return dict(peak_lr=3e-3, warmup_steps=2, total_steps=3)


def jax_train(jm, params, bts):
    """JAX's train step on one device over ``bts`` (the body of its
    ``build_train_step``: ``value_and_grad`` of ``LM.loss`` and AdamW's
    update, jitted): (losses, gradient norms, {path: final parameter})."""
    jp = jparams(params)
    jopt = JaxAdamW(schedule=JaxWarmupCosine(**optimizer_kw()), eps=1e-6)
    state = jopt.init(jp)

    @jax.jit
    def step(p, s, batch):
        (loss, met), grads = jax.value_and_grad(jm.loss, has_aux=True)(p,
                                                                       batch)
        p, s, om = jopt.update(grads, s, p)
        return p, s, loss, dict(met, **om)

    losses, norms = [], []
    for bt in bts:
        jp, state, loss, met = step(jp, state, {
            k: jnp.asarray(v) for k, v in bt.items()})
        losses.append(float(loss))
        norms.append(float(met["grad_norm"]))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    return losses, norms, {jax.tree_util.keystr(p): np.asarray(a)
                           for p, a in flat}


def check_train(res, want):
    losses, norms, params = want
    for r in res:
        assert r["stats"]["eager"] and r["stats"]["steps"] == len(losses)
        np.testing.assert_allclose(r["losses"], losses, **TOL)
        np.testing.assert_allclose(r["norms"], norms, **TOL)
        assert sorted(r["params"]) == sorted(params)
        for k, v in params.items():
            np.testing.assert_allclose(r["params"][k], v, **TOL, err_msg=k)
