"""The model options of JAX's train step, ``LM(remat=, fused_head=,
ce_chunks=)``, against the JAX package on the CPU.

* Remat: "full" and "dots" give "none"'s loss and gradients bit for bit in
  the port and JAX's ``LM(remat=...)``'s within 1e-4, on reduced
  ``llama3_2_1b``, ``deepseek_v2_lite``, ``zamba2_7b`` and
  ``paligemma_3b``; in the backward "dots" recomputes no 2-D product
  (``aten.mm``) and "full" does.
* The einsum head (``fused_head=False``) with ``ce_chunks`` 1, 4 and 5 (5
  does not divide the 16 labels: JAX reduces it to 4): the loss and every
  gradient against JAX's; its logits with the padded vocab at -1e30; the
  greedy static and paged decode steps' tokens.

Tolerances, all f32: 1e-4 for losses, logits and gradients, whose sums run
in another order; bit equality for remat against none and for tokens.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.serving import Engine as JaxEngine

from repro_torch.configs import get_config, reduced
from repro_torch.models import LM
from repro_torch.serving import Engine
from repro_torch.tree import leaves, leaves_with_path, unflatten

from test_torch_train_step import (ARCHS, MM, _assert_tree_close, _batches,
                                   _models, _np)

# ---------------------------------------------------------------------------
# LM(remat=...)
# ---------------------------------------------------------------------------

class _CountOps(TorchDispatchMode):
    """Counts the aten ops dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] = self.ops.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(tm, tp, bt, count=False):
    batch = {k: torch.from_numpy(v) for k, v in bt.items()}
    loss, _ = tm.loss(tp, batch)
    mode = _CountOps() if count else contextlib.nullcontext()
    with mode:
        grads = torch.autograd.grad(loss, leaves(tp))
    return loss.detach(), grads, (mode.ops if count else None)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_value(arch):
    """``remat="full"`` and ``"dots"``: the loss and every gradient equal
    "none"'s bit for bit, and JAX's ``LM(remat=...)``'s within 1e-4. In
    the backward, "full" recomputes the layers' 2-D products (more
    ``aten.mm`` than "none"), "dots" keeps them (as many as "none") and
    recomputes the rest (more elementwise ops than "none")."""
    bt = _batches(reduced(get_config(arch)), 11, 1)[0]
    runs = {}
    for remat in ("none", "full", "dots"):
        tm, tp, jm, jp = _models(arch, remat=remat)
        assert tm.remat == remat
        runs[remat] = _loss_and_grads(tm, tp, bt, count=True)
        if remat == "none":
            continue
        (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in bt.items()})
        loss, grads, _ = runs[remat]
        np.testing.assert_allclose(float(loss), float(jl), **MM)
        _assert_tree_close(jg, unflatten(tp, grads), MM, f"{remat} grad ")
    base_loss, base_grads, base_ops = runs["none"]
    for remat in ("full", "dots"):
        loss, grads, _ = runs[remat]
        assert torch.equal(loss, base_loss), remat
        for a, b in zip(grads, base_grads, strict=True):
            assert torch.equal(a, b), remat
    mm = torch.ops.aten.mm.default
    assert runs["full"][2][mm] > base_ops[mm] == runs["dots"][2][mm]
    mul = torch.ops.aten.mul.Tensor
    assert runs["dots"][2][mul] > base_ops[mul]


def test_lm_options_are_checked():
    cfg = reduced(get_config("llama3_2_1b"))
    with pytest.raises(ValueError, match="remat"):
        LM(cfg, device="cpu", remat="some")
    with pytest.raises(ValueError, match="ce_chunks"):
        LM(cfg, device="cpu", ce_chunks=0)
    tm = LM(cfg, device="cpu")
    assert (tm.remat, tm.fused_head, tm.ce_chunks) == ("none", True, 1)


# ---------------------------------------------------------------------------
# the einsum head: LM(fused_head=False, ce_chunks=k)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunks", [1, 4, 5])
def test_unfused_head_loss_matches_jax(chunks):
    """``fused_head=False``: the CE over the einsum head's full logits
    (chunks 1) or over sequence chunks with rematerialised logits (4; 5
    does not divide the 16 labels and is reduced to 4, as JAX reduces it):
    the loss and every gradient against JAX's ``LM(fused_head=False,
    ce_chunks=k)`` within 1e-4, and the head's own gradient nonzero."""
    tm, tp, jm, jp = _models("llama3_2_1b", fused_head=False,
                             ce_chunks=chunks)
    bt = _batches(tm.cfg, 13, 1)[0]
    loss, grads, _ = _loss_and_grads(tm, tp, bt)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in bt.items()})
    np.testing.assert_allclose(float(loss), float(jl), **MM)
    _assert_tree_close(jg, unflatten(tp, grads), MM, "grad ")
    embed = dict(zip((k for k, _ in leaves_with_path(tp)), grads))
    assert float(embed["['embed']"].abs().max()) > 0


def test_unfused_head_logits_match_jax():
    """The einsum head's logits (f32; a vocab of 500 padded to 512, the
    pad columns at -1e30) against JAX's ``forward`` with
    ``fused_head=False``."""
    tm, tp, jm, jp = _models("llama3_2_1b", vocab=500, fused_head=False)
    assert tm.vpad == 512
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab_size, (2, 6))
    jl, _ = jm.forward(jp, jnp.asarray(toks, jnp.int32))
    tl, _ = tm.forward(tp, torch.from_numpy(toks))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **MM)
    assert torch.all(tl[..., 500:] == -1e30)


def test_unfused_greedy_steps_match_jax():
    """With ``fused_head=False``, ``greedy_step`` on a static cache and
    ``paged_greedy_step`` on the engine's paged one pick their tokens by
    ``greedy_token`` over the einsum head's logits: eight static and four
    paged steps give JAX's tokens, and the logits within 1e-4."""
    tm, tp, jm, jp = _models("llama3_2_1b", vocab=500, fused_head=False)
    assert not jm.fused_head
    rng = np.random.default_rng(5)
    prompts = rng.integers(1, tm.cfg.vocab_size, (2, 5))
    with torch.no_grad():
        tl, tc = tm.prefill(tp, torch.from_numpy(prompts), max_len=16)
        jl, jc = jm.prefill(jp, jnp.asarray(prompts, jnp.int32), max_len=16)
        tok = np.asarray(jm.greedy_token(jl))[:, None]
        jstep = jax.jit(jm.greedy_step)
        for i in range(8):
            tn, tl, tc = tm.greedy_step(tp, torch.from_numpy(tok), tc)
            jn, jl, jc = jstep(jp, jnp.asarray(tok), jc)
            np.testing.assert_array_equal(_np(tn), np.asarray(jn))
            np.testing.assert_allclose(_np(tl), np.asarray(jl), **MM,
                                       err_msg=f"static step {i}")
            tok = np.asarray(jn)[:, None]
        plist = [rng.integers(0, tm.cfg.vocab_size, 3).tolist()
                 for _ in range(2)]
        engines = []
        for cls, model, params in ((JaxEngine, jm, jp), (Engine, tm, tp)):
            eng = cls(model, params, batch=2, max_len=32, page_size=8)
            for p in plist:
                eng.submit(p, 16)
            eng.step()
            engines.append(eng)
        jeng, teng = engines
        np.testing.assert_array_equal(teng._pending, jeng._pending)
        jpaged = jax.jit(jm.paged_greedy_step)
        tok, jc = teng._pending.reshape(2, 1), jeng.cache
        for i in range(4):
            tn, tl, _ = tm.paged_greedy_step(tp, torch.from_numpy(tok),
                                             teng.cache)
            jn, jl, jc = jpaged(jp, jnp.asarray(tok, jnp.int32), jc)
            np.testing.assert_array_equal(_np(tn), np.asarray(jn))
            np.testing.assert_allclose(_np(tl), np.asarray(jl), **MM,
                                       err_msg=f"paged step {i}")
            tok = _np(tn)[:, None]
