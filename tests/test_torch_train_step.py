"""The port's compiled train step (``parallel.build_train_step``) against
the JAX package, on the CPU, where the step runs eagerly (the model
options it takes are held in ``tests/test_torch_lm_options.py``).

* ``build_train_step`` against JAX's ``build_train_step(...,
  make_local_mesh(), accum_steps=k)`` (``batch_shapes=None``: JAX's own
  ``TrainLoop`` passes shapes, and that path fails on this JAX version) for
  k = 1 and 2 on reduced ``llama3_2_1b``, ``deepseek_v2_lite`` (MoE, MLA),
  ``zamba2_7b`` (groups of mamba2 layers with the shared block) and
  ``paligemma_3b`` (prefix embeddings): three steps, the losses, every
  parameter and moment, the metrics' keys and the optimizer's step count.
* ``TrainLoop`` through the step: a restore after an injected failure (from
  a checkpoint, or the fresh state) copies into the step's leaves in place
  and resumes the failure-free history; the same with the compiled step's
  bookkeeping (``TrainGraphStep``: eager first call, one capture, replays,
  refusals) run on the CPU with the capture stubbed, since only the card
  captures.
* ``make_corpus`` and ``TextLMData`` bit-equal to JAX's; the CLI's
  ``--remat``.

Tolerances, all f32: 1e-4 (``tests/test_torch_train.py``'s ``MM``) for
losses, gradients, parameters and moments, whose sums run in another
order; bit equality where the arithmetic is the same (the loop's
histories) and for data.
"""

import contextlib
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data import TextLMData as JaxTextData
from repro.data import make_corpus as jax_make_corpus
from repro.launch.mesh import make_local_mesh
from repro.models import LM as JaxLM
from repro.optim import AdamW as JaxAdamW
from repro.optim import WarmupCosine as JaxWarmupCosine
from repro.parallel.steps import build_train_step as jax_build_train_step

from repro_torch.checkpoint import manager as ckpt_manager
from repro_torch.configs import get_config, reduced
from repro_torch.data import TextLMData, make_corpus
from repro_torch.kernels import (add_launches, launch_counts, launch_state,
                                 launches_since, reset_launches, rmsnorm)
from repro_torch.launch import train as train_mod
from repro_torch.models import LM, from_jax_params
from repro_torch.optim import AdamW, WarmupCosine
from repro_torch.parallel import TrainGraphStep, build_train_step
from repro_torch.parallel import steps as steps_mod
from repro_torch.runtime import FailureInjector
from repro_torch.tree import leaves, leaves_with_path, unflatten

MM = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["llama3_2_1b", "deepseek_v2_lite", "zamba2_7b", "paligemma_3b"]
B, S = 2, 16


def _np(t):
    return t.detach().cpu().numpy()


def _assert_tree_close(jtree, ttree, tol, what=""):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = list(leaves_with_path(ttree))
    assert len(jflat) == len(tflat)
    for (path, a), (key, b) in zip(jflat, tflat):
        assert jax.tree_util.keystr(path) == key
        np.testing.assert_allclose(_np(b), np.asarray(a), **tol,
                                   err_msg=f"{what}{key}")


_INIT = {}


def _models(arch, vocab=None, **kw):
    """(port LM, port params requiring grad, JAX LM, JAX params) on reduced
    ``arch`` (with ``vocab`` tokens, if given) and the LM options ``kw``,
    both from the JAX init (drawn once for each config)."""
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    if vocab is not None:
        jcfg = dataclasses.replace(jcfg, vocab_size=vocab)
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    if (arch, vocab) not in _INIT:
        _INIT[arch, vocab] = jax.tree.map(
            np.asarray, jax.jit(JaxLM(jcfg).init)(jax.random.PRNGKey(0)))
    host = _INIT[arch, vocab]
    tp = from_jax_params(host, device="cpu")
    tp = unflatten(tp, [p.requires_grad_() for p in leaves(tp)])
    return (LM(cfg, device="cpu", **kw), tp, JaxLM(jcfg, **kw),
            jax.tree.map(jnp.asarray, host))


def _batches(cfg, seed, n, b=B, s=S):
    """``n`` numpy batches of tokens (b, s + 1) and, for a frontend, prefix
    embeddings (b, P, d) in f32."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bt = {"tokens": rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(
            np.int32)}
        if cfg.frontend:
            bt["prefix_embeddings"] = rng.standard_normal(
                (b, cfg.num_prefix_embeddings, cfg.d_model), np.float32)
        out.append(bt)
    return out


def _schedule(cls):
    return cls(peak_lr=3e-3, warmup_steps=2, total_steps=3)


# AdamW's eps for the comparisons of whole steps: its update lr g / (|g| +
# eps) is not continuous in g where |g| is near eps. With the default 1e-8,
# one element of reduced deepseek_v2_lite's dense w_down whose two
# micro-batches' gradients cancel to ~3e-9 (f32 rounding of ~1e-7 of the
# largest gradient, on both sides) moved by 0.09 lr = 1.3e-4 more in JAX
# than in the port; at 1e-6 a rounding-sized gradient moves a parameter by
# at most ~lr * 1e-3. Both packages run the same eps.
EPS = 1e-6


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, accum):
    """Three steps of ``build_train_step`` against JAX's jitted step on the
    same batches: the losses, every parameter and moment within 1e-4, the
    metrics' keys (for accum_steps > 1 JAX's {"ce": loss, "moe_lb": 0,
    "moe_z": 0}), and the optimizer's step: the same 0-dim int32 tensor,
    advanced in place to JAX's count."""
    tm, tp, jm, jp = _models(arch)
    topt = AdamW(schedule=_schedule(WarmupCosine), eps=EPS)
    jopt = JaxAdamW(schedule=_schedule(JaxWarmupCosine), eps=EPS)
    tstate, jstate = topt.init(tp), jopt.init(jp)
    step, info = build_train_step(tm, topt, accum_steps=accum)
    assert info == {"accum_steps": accum, "cuda_graph": False}
    jstep, _ = jax_build_train_step(jm, jopt, make_local_mesh(),
                                    accum_steps=accum)
    count = tstate["step"]
    for i, bt in enumerate(_batches(tm.cfg, 7, 3)):
        p2, s2, loss, met = step(tp, tstate, {
            k: torch.from_numpy(v) for k, v in bt.items()})
        assert p2 is tp and s2 is tstate and tstate["step"] is count
        jp, jstate, jloss, jmet = jstep(jp, jstate, {
            k: jnp.asarray(v) for k, v in bt.items()})
        np.testing.assert_allclose(float(loss), float(jloss), **MM,
                                   err_msg=f"loss, step {i}")
        assert sorted(met) == sorted(jmet)
        for k in ("ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), **MM,
                                       err_msg=k)
        if accum > 1:
            assert met["moe_lb"] == met["moe_z"] == 0.0
            assert float(met["ce"]) == float(loss)
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == int(jstate["step"]) == 3
    _assert_tree_close(jp, tp, MM, "params ")
    _assert_tree_close(jstate["m"], tstate["m"], MM, "m ")
    _assert_tree_close(jstate["v"], tstate["v"], MM, "v ")


def test_accumulation_splits_the_batch_as_jax():
    """With accum_steps = 2 the step's gradients are the mean of the two
    halves' (JAX's micro-batches), not the whole batch's; a batch the
    steps do not divide raises."""
    tm, tp, _, _ = _models("llama3_2_1b")
    bt = {k: torch.from_numpy(v) for k, v in
          _batches(tm.cfg, 3, 1, b=4)[0].items()}
    want = [torch.zeros(p.shape) for p in leaves(tp)]
    for half in (bt["tokens"][:2], bt["tokens"][2:]):
        loss, _ = tm.loss(tp, {"tokens": half})
        for w, g in zip(want, torch.autograd.grad(loss, leaves(tp))):
            w.add_(g)

    class Keep(AdamW):
        def update(self, grads, state, params):
            self.grads = leaves(grads)
            return params, state, {"grad_norm": 0.0, "lr": 0.0}

    opt = Keep()
    step, _ = build_train_step(tm, opt, accum_steps=2)
    step(tp, opt.init(tp), bt)
    for g, w in zip(opt.grads, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w / 2, rtol=0, atol=0)
    with pytest.raises(ValueError, match="accum_steps=3"):
        build_train_step(tm, opt, accum_steps=3)[0](tp, opt.init(tp), bt)
    with pytest.raises(ValueError, match="accum_steps"):
        build_train_step(tm, opt, accum_steps=0)


# ---------------------------------------------------------------------------
# TrainLoop through the step; the compiled step's bookkeeping on the CPU
# ---------------------------------------------------------------------------

class _Stream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def graph_on_cpu(monkeypatch):
    """``TrainGraphStep`` runnable on the CPU: streams and the allocator's
    cache are no-ops; ``steps.capture`` runs fn's Python once and then
    restores every leaf of the step's (params, opt_state) (a capture runs
    nothing), and its replay reruns fn (taking back the launches fn's
    Python counted: the step adds the capture's) and copies the loss and
    metrics into the capture's outputs, as a replay writes them. Returns
    the list of replays."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    replays, steps = [], []
    real_init = TrainGraphStep.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        steps.append(self)

    monkeypatch.setattr(TrainGraphStep, "__init__", init)

    def fake_capture(fn):
        state = leaves(steps[-1]._pair)
        saved = [t.detach().clone() for t in state]
        out = fn()
        with torch.no_grad():
            for t, c in zip(state, saved):
                t.copy_(c)

        def replay():
            before = launch_state()
            new = fn()
            add_launches(launches_since(before), -1)
            for a, b in zip(leaves(out[2:]), leaves(new[2:])):
                if torch.is_tensor(a):
                    a.copy_(b)
            replays.append(1)
        return replay, out

    monkeypatch.setattr(steps_mod, "capture", fake_capture)
    return replays


def _loop(steps, **kw):
    model = LM(reduced(get_config("llama3_2_1b")), device="cpu")
    return train_mod.TrainLoop(model=model, global_batch=4, seq_len=16,
                               steps=steps, verbose=False, **kw)


def _spy_builds(monkeypatch, compiled):
    """Route ``TrainLoop``'s ``build_train_step`` through a spy that records
    each build and each call's (params, opt_state) pair; ``compiled``
    returns a ``TrainGraphStep`` (runnable on the CPU under
    ``graph_on_cpu``)."""
    builds, pairs = [], []

    def spy(model, optimizer, **kw):
        step, info = build_train_step(model, optimizer, **kw)
        if compiled:
            step = TrainGraphStep(step, device=model.device)
        builds.append(step)

        def called(params, opt_state, batch):
            pairs.append((params, opt_state))
            return step(params, opt_state, batch)
        return called, info

    monkeypatch.setattr(train_mod, "build_train_step", spy)
    return builds, pairs


@pytest.mark.parametrize("compiled", [False, True], ids=["eager", "graph"])
@pytest.mark.parametrize("ckpt", [True, False], ids=["restore", "fresh"])
def test_trainloop_restores_in_place_and_resumes(tmp_path, monkeypatch,
                                                 request, ckpt, compiled):
    """A failure injected at step 3 restores the checkpoint of step 2,
    waiting for its writer (or, without checkpoints, the fresh initial
    state) into the leaves of the
    one built step's (params, opt_state) in place, and the history goes on
    as the failure-free run's, bit for bit: its steps 2.. again after the
    restore (0.. after a fresh start), then the rest; the final parameters
    and moments equal the failure-free run's. Compiled, every step after
    the first is a replay of the one capture, also after the restore."""
    if compiled:
        replays = request.getfixturevalue("graph_on_cpu")
    kw = dict(ckpt_dir=str(tmp_path / "ck"), ckpt_every=2) if ckpt else {}
    # a slow writer: the checkpoint of step 2 is still being written when
    # step 3 fails, and the restore must wait for it
    real_save = ckpt_manager.save_tree

    def slow_save(*a, **k):
        time.sleep(0.5)
        return real_save(*a, **k)

    monkeypatch.setattr(ckpt_manager, "save_tree", slow_save)
    clean = _loop(5).run()
    builds, pairs = _spy_builds(monkeypatch, compiled)
    out = _loop(5, injector=FailureInjector([3]), **kw).run()
    h = clean["history"]
    want = h[:3] + h[2:] if ckpt else h[:3] + h
    assert out["history"] == want
    assert len(builds) == 1
    assert all(p is pairs[0][0] and o is pairs[0][1] for p, o in pairs)
    assert out["params"] is pairs[0][0] and out["opt"] is pairs[0][1]
    for a, b in zip(leaves((out["params"], out["opt"])),
                    leaves((clean["params"], clean["opt"])), strict=True):
        assert torch.equal(a.detach(), b.detach())
    if compiled:
        step = builds[0]
        assert step.captures == 1 and len(replays) == len(want) - 1


def test_graph_step_bookkeeping_on_cpu(graph_on_cpu):
    """``TrainGraphStep``: the first call eager, the second captures and
    replays, later ones replay; the replays' losses are the eager steps'
    (the same function); another (params, opt_state) object or a batch of
    another shape raises and runs nothing; a replay adds the capture's
    launch counts."""
    replays = graph_on_cpu
    tm, tp, _, _ = _models("llama3_2_1b")
    opt = AdamW(schedule=_schedule(WarmupCosine))
    state = opt.init(tp)
    eager_p = unflatten(tp, [p.detach().clone().requires_grad_()
                             for p in leaves(tp)])
    eager_s = opt.init(eager_p)
    step = TrainGraphStep(lambda p, s, b: steps_mod.train_step(
        tm, opt, p, s, b), device=torch.device("cpu"))
    batches = [{k: torch.from_numpy(v) for k, v in bt.items()}
               for bt in _batches(tm.cfg, 17, 4)]
    for i, bt in enumerate(batches):
        want = steps_mod.train_step(tm, opt, eager_p, eager_s, bt)[2]
        got = step(tp, state, bt)[2]
        assert torch.equal(got, want), i
    assert step.captures == 1 and len(replays) == 3
    assert int(state["step"]) == 4
    for p, c in (({}, state), (tp, opt.init(tp))):
        with pytest.raises(ValueError, match="first call"):
            step(p, c, batches[0])
    with pytest.raises(ValueError, match="captured for"):
        step(tp, state, {"tokens": batches[0]["tokens"][:1]})
    assert len(replays) == 3 and int(state["step"]) == 4
    reset_launches()
    step.counts = {"rmsnorm": (5, {"vec": 5, "elem": 0})}
    step(tp, state, batches[0])
    assert launch_counts()["rmsnorm"] == 5 and rmsnorm.routes["vec"] == 5
    reset_launches()


# ---------------------------------------------------------------------------
# data and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts,host", [(1, 0), (2, 1)])
def test_text_data_bit_equal(hosts, host):
    corpus = make_corpus(5000, seed=3)
    assert corpus == jax_make_corpus(5000, seed=3)
    assert make_corpus() == jax_make_corpus()
    kw = dict(seq_len=33, global_batch=4, seed=3, num_hosts=hosts,
              host_id=host)
    ours, theirs = TextLMData(corpus, **kw), JaxTextData(corpus, **kw)
    assert ours.vocab == theirs.vocab == 256
    for step in (0, 1, 7):
        got = ours.batch(step)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, theirs.batch(step))


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_train_cli_takes_remat(capsys, remat):
    out = train_mod.main(["--reduced", "--device", "cpu", "--steps", "2",
                          "--remat", remat])
    assert len(out["history"]) == 2 and out["final_step"] == 2
    assert "done on cpu" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train_mod.main(["--reduced", "--device", "cpu", "--remat", "all"])


def test_train_entry_points_raise_without_cuda(monkeypatch):
    """Without a card the train CLI and ``TrainLoop`` on a card model
    raise (the model refuses the default device) instead of training on
    the CPU; ``build_train_step`` takes the model's device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mod.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mod.main(["--reduced", "--steps", "1", "--device", "cuda"])
    tm = LM(reduced(get_config("llama3_2_1b")), device="cpu")
    step, info = build_train_step(tm, AdamW())
    assert not isinstance(step, TrainGraphStep) and not info["cuda_graph"]
