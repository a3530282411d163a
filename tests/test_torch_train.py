"""The PyTorch port's training path against the JAX package, on the CPU.

On the same numpy inputs: the fused CE head and the flash backward (the
autograd Functions the card runs, here through their plain versions)
against the JAX ops through their jnp oracles and the Pallas kernels in
interpret mode; rmsnorm's gradient; ``LM.loss`` and every gradient on
reduced ``llama3_2_1b`` against ``jax.value_and_grad(LM.loss)`` under the
Pallas backend; AdamW, the schedule and the global norm; the synthetic
data; checkpoints across the packages; and the port's ``TrainLoop``
against a loop composed from the JAX package's parts (its own
``TrainLoop`` needs a mesh).

Tolerances, all f32: 1e-5 for elementwise results and the optimizer,
1e-4 for matmul-like outputs (NLL, gradients, losses) whose sums run in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCkpt
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data import SyntheticLMData as JaxData
from repro.kernels.flash_attention import mha_ref as jax_mha_ref
from repro.kernels.flash_attention.kernel import \
    flash_attention_bwd as jax_flash_bwd
from repro.kernels.lm_head import lm_head_ce as jax_ce
from repro.kernels.lm_head import lm_head_ce_ref as jax_ce_ref
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.layers.common import use_kernel_backend
from repro.models import LM as JaxLM
from repro.optim import AdamW as JaxAdamW
from repro.optim import WarmupCosine as JaxWarmupCosine
from repro.optim import global_norm as jax_global_norm

from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticLMData
from repro_torch.kernels import KERNELS, launch_counts, reset_launches
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_fwd,
                                                 flash_bwd, flash_delta,
                                                 flash_fwd_ref)
from repro_torch.kernels.lm_head import lm_head_ce, lm_head_logits
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.launch.train import TrainLoop, validate_host_batch
from repro_torch.models import LM, from_jax_params
from repro_torch.optim import AdamW, WarmupCosine, global_norm
from repro_torch.runtime import ChaosError, FailureInjector
from repro_torch.tree import leaves, leaves_with_path, unflatten

EW = dict(rtol=1e-5, atol=1e-5)
MM = dict(rtol=1e-4, atol=1e-4)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def pair():
    """(torch LM, JAX LM, JAX params) on reduced llama3_2_1b in f32."""
    jm = JaxLM(jax_reduced(jax_get_config("llama3_2_1b")))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = LM(reduced(get_config("llama3_2_1b")), device="cpu")
    return tm, jm, jp


def _torch_params(jp):
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return unflatten(tp, [p.requires_grad_() for p in leaves(tp)])


def _assert_tree_close(jtree, ttree, tol, what=""):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = list(leaves_with_path(ttree))
    assert len(jflat) == len(tflat)
    for (path, a), (key, b) in zip(jflat, tflat):
        assert jax.tree_util.keystr(path) == key
        np.testing.assert_allclose(_np(b), np.asarray(a), **tol,
                                   err_msg=f"{what}{key}")


# ---------------------------------------------------------------------------
# fused CE head: NLL and dx/dw, padded vocab, ragged rows, tied head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,d,V,vocab,tied", [(13, 16, 96, 70, False),
                                              (24, 16, 64, 64, True),
                                              (5, 8, 128, 100, True)])
def test_ce_matches_jax(R, d, V, vocab, tied):
    rng = np.random.default_rng(R + V)
    x = rng.standard_normal((R, d), np.float32)
    w = rng.standard_normal((V, d) if tied else (d, V), np.float32)
    labels = rng.integers(0, vocab, (R, 1)).astype(np.int32)
    g = rng.standard_normal((R,), np.float32)
    tx, tw = _t(x, True), _t(w, True)
    head = tw.T if tied else tw
    nll = lm_head_ce(tx, head, _t(labels), vocab=vocab)
    dx, dw = torch.autograd.grad(nll, (tx, tw), _t(g))
    jw = jnp.asarray(w).T if tied else jnp.asarray(w)
    args = (jnp.asarray(x), jw, jnp.asarray(labels))
    for fn in (lambda x_, w_: jax_ce_ref(x_, w_, args[2], vocab=vocab),
               lambda x_, w_: jax_ce(x_, w_, args[2], vocab=vocab, block_r=8,
                                     block_v=16, block_k=8,
                                     backend="pallas")):
        out, vjp = jax.vjp(fn, *args[:2])
        jdx, jdw = vjp(jnp.asarray(g))
        np.testing.assert_allclose(_np(nll), np.asarray(out), **MM)
        np.testing.assert_allclose(_np(dx), np.asarray(jdx), **MM)
        np.testing.assert_allclose(_np(dw), np.asarray(jdw).T if tied
                                   else np.asarray(jdw), **MM)


def test_ce_raw_stats_and_launch_free_on_cpu():
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((6, 8), np.float32))
    w = _t(rng.standard_normal((8, 32), np.float32))
    lab = _t(np.array([[0], [3], [29], [5], [1], [2]], np.int32))
    reset_launches()
    lse, gold = lm_head_ce.raw(x, w, lab, vocab=30)
    logits = x @ w
    np.testing.assert_allclose(_np(lse[:, 0]), _np(torch.logsumexp(
        logits[:, :30], -1)), **EW)
    np.testing.assert_allclose(_np(gold[:, 0]), _np(
        logits.gather(1, lab.long())[:, 0]), **EW)
    assert launch_counts() == {name: 0 for name in KERNELS}


# ---------------------------------------------------------------------------
# flash backward: GQA groups, ragged lengths, strided q, rows that see nothing
# ---------------------------------------------------------------------------

# every case is held against jax.vjp of the oracle; the Pallas interpret
# run (seconds a case) covers each group size and each length once
_PALLAS_BWD_CASES = {(1, 5), (2, 9), (4, 17)}


@pytest.mark.parametrize("g,s", [(1, 5), (2, 9), (4, 17), (4, 5), (1, 17)])
def test_flash_backward_matches_jax(g, s):
    rng = np.random.default_rng(10 * g + s)
    b, hk, d = 2, 2, 32
    h = hk * g
    q = rng.standard_normal((b, s, h, d), np.float32)   # (B, S, H, D)
    k = rng.standard_normal((b, hk, s, d), np.float32)
    v = rng.standard_normal((b, hk, s, d), np.float32)
    do = rng.standard_normal((b, h, s, d), np.float32)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    o = flash_attention(tq.transpose(1, 2), tk, tv, causal=True)
    dq, dk, dv = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    dq = dq.transpose(1, 2)
    jq = jnp.asarray(q).transpose(0, 2, 1, 3)
    jk, jv, jdo = jnp.asarray(k), jnp.asarray(v), jnp.asarray(do)
    np.testing.assert_allclose(_np(o), np.asarray(jax_mha_ref(jq, jk, jv)),
                               **MM)
    _, vjp = jax.vjp(lambda a, b_, c: jax_mha_ref(a, b_, c), jq, jk, jv)
    refs = [vjp(jdo)]
    if (g, s) in _PALLAS_BWD_CASES:
        lse = flash_fwd_ref(tq.detach().transpose(1, 2), tk.detach(),
                            tv.detach())[1]
        refs.append(jax_flash_bwd(jq, jk, jv, jnp.asarray(_np(o)), jdo,
                                  jnp.asarray(_np(lse)), causal=True,
                                  backend="pallas"))
    for ref in refs:
        for got, exp in zip((dq, dk, dv), ref):
            np.testing.assert_allclose(_np(got), np.asarray(exp), **MM)


def test_flash_bwd_rows_that_see_no_key_give_zero():
    """Sq > Skv under the causal mask: the first rows see no key (lse =
    -inf). Their dq is exactly 0, nothing is NaN, and dk/dv equal those of
    the visible rows alone."""
    rng = np.random.default_rng(3)
    q = _t(rng.standard_normal((1, 4, 7, 32), np.float32))
    k = _t(rng.standard_normal((1, 2, 4, 32), np.float32))
    v = _t(rng.standard_normal((1, 2, 4, 32), np.float32))
    do = _t(rng.standard_normal((1, 4, 7, 32), np.float32))
    o, lse = flash_fwd_ref(q, k, v, causal=True)
    assert torch.isinf(lse[:, :, :3]).all()
    dq, dk, dv = flash_bwd(q, k, v, do, lse, flash_delta(do, o))
    assert torch.isfinite(dq).all() and (dq[:, :, :3] == 0).all()
    vis = slice(3, 7)
    dq2, dk2, dv2 = flash_bwd(q[:, :, vis], k, v, do[:, :, vis],
                              lse[:, :, vis].contiguous(),
                              flash_delta(do[:, :, vis], o[:, :, vis]))
    np.testing.assert_allclose(_np(dq[:, :, vis]), _np(dq2), **EW)
    np.testing.assert_allclose(_np(dk), _np(dk2), **EW)
    np.testing.assert_allclose(_np(dv), _np(dv2), **EW)


def test_rmsnorm_grad_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 64), np.float32) * 2
    w = rng.standard_normal((64,), np.float32)
    gy = rng.standard_normal((3, 5, 64), np.float32)
    tx, tw = _t(x, True), _t(w, True)
    dx, dw = torch.autograd.grad(rmsnorm(tx, tw, eps=1e-5), (tx, tw), _t(gy))
    _, vjp = jax.vjp(lambda a, b_: jax_rmsnorm(a, b_, eps=1e-5, block_rows=4,
                                               backend="pallas"),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(gy))
    np.testing.assert_allclose(_np(dx), np.asarray(jdx), **EW)
    np.testing.assert_allclose(_np(dw), np.asarray(jdw), **MM)


def test_untracked_wrappers_raise_under_grad():
    """The decode LM head and the raw flash forward record no graph: asked
    for a gradient they raise instead of cutting it."""
    x = torch.randn(3, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        lm_head_logits(x, torch.randn(8, 16))
    q = torch.randn(1, 2, 3, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        flash_attention_fwd(q, q, q)
    with torch.no_grad():
        lm_head_logits(x, torch.randn(8, 16))
        flash_attention_fwd(q, q, q)


# ---------------------------------------------------------------------------
# the model: loss and every gradient against JAX's Pallas run
# ---------------------------------------------------------------------------

def test_loss_and_grads_match_jax_pallas(pair):
    tm, jm, jp = pair
    toks = np.random.default_rng(0).integers(0, tm.cfg.vocab_size, (2, 17))
    toks = toks.astype(np.int32)
    with use_kernel_backend("pallas"):
        (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
            jp, {"tokens": jnp.asarray(toks)})
    tp = _torch_params(jp)
    loss, met = tm.loss(tp, {"tokens": torch.from_numpy(toks)})
    grads = unflatten(tp, torch.autograd.grad(loss, leaves(tp)))
    loss, ce = float(loss.detach()), float(met["ce"].detach())
    np.testing.assert_allclose(loss, float(jl), **MM)
    assert loss == ce                                    # dense: total == ce
    assert float(met["moe_lb"]) == float(jmet["moe_lb"]) == 0.0
    _assert_tree_close(jg, grads, MM, "grad ")


def test_check_labels_and_host_batch_raise(pair):
    tm = pair[0]
    vocab = tm.cfg.vocab_size
    with pytest.raises(ValueError, match="out of range"):
        tm._check_labels(torch.tensor([[0, vocab]]))
    with pytest.raises(ValueError, match="out of range"):
        tm._check_labels(torch.tensor([[-1, 2]]))
    tm._check_labels(torch.tensor([[0, vocab - 1]]))
    with pytest.raises(ValueError, match="out of range"):
        validate_host_batch(np.array([[1, vocab]]), vocab)
    validate_host_batch(np.zeros((0, 3)), vocab)
    params = tm.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="out of range"):
        tm.loss(params, {"tokens": torch.tensor([[1, 2, vocab + 3]])})


def test_forward_logits_match_jax(pair):
    tm, jm, jp = pair
    toks = np.random.default_rng(2).integers(0, 512, (2, 6)).astype(np.int32)
    jl, _ = jm.forward(jp, jnp.asarray(toks))
    tl, aux = tm.forward(_torch_params(jp), torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **MM)
    assert not tl.requires_grad and tuple(aux.shape) == (2,)


# ---------------------------------------------------------------------------
# optimizer, schedule, data
# ---------------------------------------------------------------------------

def test_schedule_and_global_norm_match_jax():
    sched, jsched = (WarmupCosine(3e-3, 5, 40, 0.1),
                     JaxWarmupCosine(3e-3, 5, 40, 0.1))
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        np.testing.assert_allclose(float(sched(step)), float(jsched(step)),
                                   rtol=1e-6)
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((3, 4), np.float32),
            "b": [rng.standard_normal((7,), np.float32)]}
    np.testing.assert_allclose(
        float(global_norm(jax.tree.map(torch.from_numpy, tree))),
        float(jax_global_norm(jax.tree.map(jnp.asarray, tree))), rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_matches_jax(clip):
    rng = np.random.default_rng(6)
    params = {"w": rng.standard_normal((4, 6), np.float32),
              "n": np.ones((6,), np.float32),
              "s": [rng.standard_normal((2, 3), np.float32)]}
    opt = AdamW(schedule=WarmupCosine(1e-2, 2, 10), clip_norm=clip)
    jopt = JaxAdamW(schedule=JaxWarmupCosine(1e-2, 2, 10), clip_norm=clip)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    jparams = jax.tree.map(jnp.asarray, params)
    tstate, jstate = opt.init(tp), jopt.init(jparams)
    for step in range(3):
        grads = jax.tree.map(
            lambda a: rng.standard_normal(a.shape, np.float32) * 3, params)
        tp, tstate, tm = opt.update(jax.tree.map(torch.from_numpy, grads),
                                    tstate, tp)
        jparams, jstate, jmet = jopt.update(jax.tree.map(jnp.asarray, grads),
                                            jstate, jparams)
        _assert_tree_close(jparams, tp, EW, f"step {step} ")
        _assert_tree_close(jstate["m"], tstate["m"], EW)
        _assert_tree_close(jstate["v"], tstate["v"], EW)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jmet[key]),
                                       rtol=1e-6)


def test_adamw_keeps_bf16_params_bf16():
    p = {"w": torch.ones((3,), dtype=torch.bfloat16)}
    opt = AdamW()
    st = opt.init(p)
    out, st, _ = opt.update({"w": torch.full((3,), 0.5)}, st, p)
    assert out["w"].dtype == torch.bfloat16 and st["m"]["w"].dtype == \
        torch.float32


@pytest.mark.parametrize("hosts,host", [(1, 0), (2, 1)])
def test_synthetic_data_bit_equal(hosts, host):
    kw = dict(vocab_size=512, seq_len=33, global_batch=4, seed=3,
              num_hosts=hosts, host_id=host)
    ours, theirs = SyntheticLMData(**kw), JaxData(**kw)
    for step in (0, 1, 7):
        np.testing.assert_array_equal(ours.batch(step), theirs.batch(step))


# ---------------------------------------------------------------------------
# checkpoints: JAX's layout, both directions at f32, bf16 by bit pattern
# ---------------------------------------------------------------------------

def test_checkpoint_crosses_packages_f32(tmp_path, pair):
    _, jm, jp = pair
    tree = (jp, {"step": jnp.asarray(7, jnp.int32)})
    JaxCkpt(str(tmp_path / "j")).save(3, tree, async_=False)
    tp = _torch_params(jp)
    template = (jax.tree.map(lambda t: torch.empty_like(t, device="meta"),
                             tp), {"step": torch.empty((), dtype=torch.int32,
                                                       device="meta")})
    step, got, meta = CheckpointManager(str(tmp_path / "j")).restore(
        template, device="cpu")
    assert step == 3 and meta["step"] == 3 and int(got[1]["step"]) == 7
    _assert_tree_close(jp, got[0], dict(rtol=0, atol=0))

    mgr = CheckpointManager(str(tmp_path / "t"))
    mgr.save(5, (tp, {"step": torch.tensor(9, dtype=torch.int32)}))
    mgr.wait()
    jtemplate = jax.eval_shape(lambda: tree)
    jstep, jgot, _ = JaxCkpt(str(tmp_path / "t")).restore(jtemplate)
    assert jstep == 5 and int(jgot[1]["step"]) == 9
    _assert_tree_close(jgot[0], tp, dict(rtol=0, atol=0))


def test_checkpoint_bf16_roundtrip_and_keep_k(tmp_path):
    t = {"w": torch.randn(4, 3).to(torch.bfloat16), "s": [torch.arange(3)]}
    save_tree(t, str(tmp_path / "a"))
    back = restore_tree(t, str(tmp_path / "a"))
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], t["w"]) and torch.equal(back["s"][0],
                                                          t["s"][0])
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_tree({"w": torch.empty(5, 3), "s": [torch.empty(3)]},
                     str(tmp_path / "a"))
    mgr = CheckpointManager(str(tmp_path / "k"), keep=2)
    for s in (10, 20, 30):
        mgr.save(s, {"x": torch.full((3,), float(s))})
    mgr.wait()
    assert mgr.all_steps() == [20, 30]
    _, tree, meta = mgr.restore({"x": torch.empty(3)})
    assert float(tree["x"][0]) == 30.0 and meta["step"] == 30


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

def test_trainloop_history_matches_composed_jax_loop(tmp_path, pair):
    """Three steps of the port's TrainLoop (resuming the JAX init from a
    step-0 checkpoint) against value_and_grad(LM.loss) + AdamW.update on
    the same SyntheticLMData batches."""
    tm, jm, jp = pair
    steps, gb, sl = 3, 2, 16
    jopt = JaxAdamW(schedule=JaxWarmupCosine(peak_lr=3e-3, warmup_steps=5,
                                             total_steps=steps))
    jstate = jopt.init(jp)
    JaxCkpt(str(tmp_path)).save(0, (jp, jstate), async_=False)
    data = JaxData(vocab_size=tm.cfg.vocab_size, seq_len=sl, global_batch=gb)
    grad_fn = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    params, want = jp, []
    for step in range(steps):
        (loss, _), g = grad_fn(params, {"tokens": jnp.asarray(
            data.batch(step))})
        params, jstate, _ = jopt.update(g, jstate, params)
        want.append(float(loss))
    out = TrainLoop(model=tm, global_batch=gb, seq_len=sl, steps=steps,
                    ckpt_dir=str(tmp_path), ckpt_every=100, verbose=False,
                    device="cpu").run()
    np.testing.assert_allclose(out["history"], want, **MM)
    assert out["final_step"] == steps and out["tuned"] == {}
    _assert_tree_close(params, out["params"], MM, "params ")


def _loop(tmp_path, steps, **kw):
    model = LM(reduced(get_config("llama3_2_1b")), device="cpu")
    return TrainLoop(model=model, global_batch=8, seq_len=32, steps=steps,
                     ckpt_dir=str(tmp_path / "ck"), ckpt_every=10,
                     verbose=False, **kw)


def test_training_loss_decreases(tmp_path):
    h = _loop(tmp_path, 40).run()["history"]
    assert np.mean(h[-5:]) < np.mean(h[:5]) - 0.3, (h[:5], h[-5:])


def test_training_resume_continues(tmp_path):
    _loop(tmp_path, 20).run()
    out = _loop(tmp_path, 30).run()        # resumes from step 20
    assert out["final_step"] == 30
    assert len(out["history"]) == 10      # only 10 new steps


def test_training_recovers_from_injected_failure(tmp_path):
    out = _loop(tmp_path, 25, injector=FailureInjector([15])).run()
    assert out["final_step"] == 25
    assert len(out["history"]) > 25 - 10  # re-ran some steps after restore


def test_training_gives_up_after_max_retries(tmp_path):
    inj = FailureInjector([5], fail_once=False)
    with pytest.raises(ChaosError):
        _loop(tmp_path, 10, injector=inj, max_retries=2).run()


def test_trainloop_device_must_match_model(tmp_path):
    loop = _loop(tmp_path, 1)
    loop.device = "cuda"
    with pytest.raises((ValueError, RuntimeError)):
        loop.run()
