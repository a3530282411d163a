"""Training the wide architectures (paligemma_3b's prefix-LM mask at
d = 256, deepseek_v2_lite's MLA at d_qk 192 / d_v 128, zamba2_7b's shared
attention at d = 112), on the CPU.

* The port's ``TrainLoop`` on reduced ``paligemma_3b`` and
  ``musicgen_medium`` (models with a frontend stub) against a loop composed
  of the JAX package's parts (its own ``TrainLoop`` needs a mesh), starting
  from the JAX init through a step-0 checkpoint: every step feeds the
  frontend's prefix embeddings, drawn as the JAX ``TrainLoop`` draws them
  (``src/repro/launch/train.py``), and the port's draw is bit-equal to it.
* ``flash_bwd_ref`` against the JAX ``flash_attention_bwd`` (Pallas,
  interpret mode) at d = 256 with a group of 8 query heads and the prefix
  (none, off the tile, one whole tile, past Sq, with a window), at
  (d_qk, d_v) = (192, 128) and at d = 112.
* ``flash_bwd`` on the card (its library stubbed): both routes take every
  new domain, and each entry point receives the head dims (d_v too) and the
  masks (``prefix_len`` too); dv comes out (B, Hk, Skv, d_v) and do must
  match o, not q.

Tolerances, all f32: 1e-4 for losses, parameters and the backward's
products, whose sums run in another order.
"""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCkpt
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data import SyntheticLMData as JaxData
from repro.kernels.flash_attention.kernel import \
    flash_attention_bwd as jax_flash_bwd
from repro.models import LM as JaxLM
from repro.optim import AdamW as JaxAdamW
from repro.optim import WarmupCosine as JaxWarmupCosine

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import reset_launches
from repro_torch.kernels.flash_attention import (flash_bwd, flash_bwd_ref,
                                                 flash_delta_ref,
                                                 flash_fwd_ref, route)
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.launch.train import TrainLoop, prefix_embeddings
from repro_torch.models import LM
from repro_torch.tree import leaves_with_path

BF = torch.bfloat16
MM = dict(rtol=1e-4, atol=1e-4)


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


def _jax_prefix(seed, step, global_batch, cfg):
    """The JAX TrainLoop's draw of a step's prefix embeddings."""
    rs = np.random.Generator(np.random.Philox(
        key=[seed * 2654435761 + 7, step]))
    return jnp.asarray(rs.standard_normal(
        (global_batch, cfg.num_prefix_embeddings, cfg.d_model), np.float32),
        jnp.dtype(cfg.dtype))


# ---------------------------------------------------------------------------
# the training loop feeds the frontend's prefix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["paligemma_3b", "musicgen_medium"])
def test_trainloop_with_prefix_matches_composed_jax_loop(tmp_path, arch):
    """Three steps of the port's TrainLoop (resuming the JAX init from a
    step-0 checkpoint, seed 3) against value_and_grad(LM.loss) +
    AdamW.update on the same SyntheticLMData tokens and the same prefix
    embeddings: the loss history and the final parameters within 1e-4."""
    jcfg = jax_reduced(jax_get_config(arch))
    jm = JaxLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = LM(reduced(get_config(arch)), device="cpu")
    assert tm.cfg.frontend and tm.cfg.num_prefix_embeddings == 8
    steps, gb, sl, seed = 3, 2, 16, 3
    jopt = JaxAdamW(schedule=JaxWarmupCosine(peak_lr=3e-3, warmup_steps=5,
                                             total_steps=steps))
    jstate = jopt.init(jp)
    JaxCkpt(str(tmp_path)).save(0, (jp, jstate), async_=False)
    data = JaxData(vocab_size=jcfg.vocab_size, seq_len=sl, global_batch=gb,
                   seed=seed)
    grad_fn = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    params, want = jp, []
    for step in range(steps):
        batch = {"tokens": jnp.asarray(data.batch(step)),
                 "prefix_embeddings": _jax_prefix(seed, step, gb, jcfg)}
        (loss, _), g = grad_fn(params, batch)
        params, jstate, _ = jopt.update(g, jstate, params)
        want.append(float(loss))
    out = TrainLoop(model=tm, global_batch=gb, seq_len=sl, steps=steps,
                    ckpt_dir=str(tmp_path), ckpt_every=100, seed=seed,
                    verbose=False, device="cpu").run()
    np.testing.assert_allclose(out["history"], want, **MM)
    assert out["final_step"] == steps
    _assert_tree_close(params, out["params"], MM, "params ")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7)])
def test_prefix_draw_is_bit_equal_to_jax(dtype, seed, step):
    """``prefix_embeddings`` gives the JAX TrainLoop's array bit for bit,
    in the config's dtype (f32, and bf16 after one rounding on each side);
    the next data step draws another."""
    cfg = dataclasses.replace(get_config("paligemma_3b"), dtype=dtype)
    jcfg = dataclasses.replace(jax_get_config("paligemma_3b"), dtype=dtype)
    got = prefix_embeddings(seed, step, 2, cfg)
    want = _jax_prefix(seed, step, 2, jcfg)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (2, 256, 2048) == want.shape
    np.testing.assert_array_equal(_np(got.float()),
                                  np.asarray(want, np.float32))
    assert not torch.equal(got, prefix_embeddings(seed, step + 1, 2, cfg))


# ---------------------------------------------------------------------------
# the plain backward against the JAX Pallas backward at the new shapes
# ---------------------------------------------------------------------------

JAX_BWD_CASES = [  # sq, skv, h, hk, d, dv, prefix_len, window
    (32, 32, 8, 1, 256, 256, 0, None),
    (32, 32, 8, 1, 256, 256, 5, None),      # off the 16-row tile
    (32, 32, 8, 1, 256, 256, 16, None),     # one whole tile
    (16, 32, 8, 1, 256, 256, 40, None),     # past Sq and Skv: all visible
    (32, 48, 8, 1, 256, 256, 27, 6),        # a window, the prefix before it
    (16, 32, 4, 2, 192, 128, 0, None),      # MLA
    (16, 32, 4, 2, 112, 112, 0, 9),         # zamba2's shared attention
]


@pytest.mark.parametrize("case", JAX_BWD_CASES)
def test_flash_bwd_ref_matches_jax_at_wide_shapes(case):
    """``flash_bwd_ref`` against the JAX ``flash_attention_bwd`` (Pallas,
    interpret mode, blocks of 16) on the same o and lse: dq (B, H, Sq,
    d_qk), dk (B, Hk, Skv, d_qk) and dv (B, Hk, Skv, d_v) within 1e-4."""
    sq, skv, h, hk, d, dv, prefix, window = case
    rng = np.random.default_rng(sq + skv + d + prefix)
    q, k = (rng.standard_normal((1, n, s, d), np.float32)
            for n, s in ((h, sq), (hk, skv)))
    v = rng.standard_normal((1, hk, skv, dv), np.float32)
    do = rng.standard_normal((1, h, sq, dv), np.float32)
    kw = dict(causal=True, window=window, prefix_len=prefix)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_fwd_ref(tq, tk, tv, **kw)
    got = flash_bwd_ref(tq, tk, tv, tdo, lse, flash_delta_ref(tdo, o), **kw)
    want = jax_flash_bwd(*map(jnp.asarray, (q, k, v, _np(o), do, _np(lse))),
                         block_q=16, block_kv=16, backend="pallas", **kw)
    assert [tuple(a.shape) for a in got] == [(1, h, sq, d), (1, hk, skv, d),
                                             (1, hk, skv, dv)]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=name, **MM)


# ---------------------------------------------------------------------------
# flash_bwd's entry points at the new domains (library stubbed)
# ---------------------------------------------------------------------------

class _Lib:
    """A stand-in for the kernel library: records each call, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def card(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(attn_ops, "on_cpu", lambda name, *ts: False)
    monkeypatch.setattr(attn_ops, "load", lambda name, sig: lib)
    monkeypatch.setattr(attn_ops, "stream", lambda: ctypes.c_void_p(0))
    reset_launches()
    return lib


def _views(b, s, heads, d, dtype, shift=False):
    """(b, heads, s, d) as the projections give it, the (b, s, heads, d)
    -> (b, heads, s, d) view; with ``shift`` its base one element past
    16-byte alignment (the tensor-core route refuses it by layout)."""
    n = b * s * heads * d
    buf = torch.zeros(n + 1, dtype=dtype)
    t = (buf[1:] if shift else buf[:n]).view(b, s, heads, d)
    return t.transpose(1, 2)


WIDE_ROUTES = {
    # (d, d_v, dtype, do shifted, prefix_len, window, route)
    "bf16 d 256, prefix": (256, 256, BF, False, 24, None, "wgmma"),
    "bf16 d 256, prefix and window": (256, 256, BF, False, 70, 9, "wgmma"),
    "bf16 d_qk 192, d_v 128": (192, 128, BF, False, 0, None, "wgmma"),
    "bf16 d 112, window": (112, 112, BF, False, 0, 9, "wgmma"),
    "f32 d 256, prefix": (256, 256, torch.float32, False, 24, None, "simt"),
    "f32 d_qk 192, d_v 128": (192, 128, torch.float32, False, 0, 5, "simt"),
    "f32 d 112, prefix": (112, 112, torch.float32, False, 64, None, "simt"),
    "f32 d 128, window": (128, 128, torch.float32, False, 0, 7, "simt"),
    "bf16 do 2 bytes off, d 256, prefix": (256, 256, BF, True, 24, 9,
                                           "simt"),
}


@pytest.mark.parametrize("case", list(WIDE_ROUTES))
def test_flash_bwd_takes_every_new_domain_on_both_routes(card, case):
    """bf16 with 16-byte rows takes ``flash_bwd_tc``, f32 and unaligned
    bf16 ``flash_bwd``; either receives (d, d_v) and (causal, window,
    prefix_len), and the outputs are dq (B, H, Sq, d) in q's dtype, dk
    (B, Hk, Skv, d) and dv (B, Hk, Skv, d_v) f32."""
    d, dv, dtype, shift, prefix, window, want = WIDE_ROUTES[case]
    b, h, hk, sq, skv = 2, 8, 1, 40, 56
    q, k = _views(b, sq, h, d, dtype), _views(b, skv, hk, d, dtype)
    v, do = _views(b, skv, hk, dv, dtype), _views(b, sq, h, dv, dtype, shift)
    lse = torch.zeros((b, h, sq))
    assert route(q, k, v, do) == want
    dq, dk, dvo = flash_bwd(q, k, v, do, lse, lse, window=window,
                            prefix_len=prefix)
    assert dq.shape == q.shape and dq.dtype == dtype
    assert dk.shape == (b, hk, skv, d) and dvo.shape == (b, hk, skv, dv)
    assert dk.dtype == dvo.dtype == torch.float32
    (name, args), = card.calls
    assert len(args) == len(attn_ops._BWD_SIG[name][0])
    assert args[9:16] == (b, h, hk, sq, skv, d, dv)
    if want == "wgmma":
        assert name == "flash_bwd_tc"
        assert args[16:19] == (1, window or 0, prefix)
    else:
        assert name == "flash_bwd"
        assert args[16:20] == (int(dtype == BF), 1, window or 0, prefix)
    assert args[-13:-1] == (*q.stride()[:3], *k.stride()[:3],
                            *v.stride()[:3], *do.stride()[:3])
    assert flash_bwd.routes == {"wgmma": int(want == "wgmma"),
                                "simt": int(want == "simt")}


def test_flash_bwd_wants_do_shaped_as_o(card):
    """At d_qk 192 / d_v 128 the cotangent is o's (B, H, Sq, 128): one
    shaped as q is refused before any launch, as are head dims no kernel
    takes."""
    q, k = _views(1, 16, 4, 192, BF), _views(1, 16, 2, 192, BF)
    v = _views(1, 16, 2, 128, BF)
    lse = torch.zeros((1, 4, 16))
    with pytest.raises(ValueError, match="must match o"):
        flash_bwd(q, k, v, q, lse, lse)
    w = _views(1, 16, 2, 96, BF)
    with pytest.raises(ValueError, match="head dims"):
        flash_bwd(q, k, w, _views(1, 16, 4, 96, BF), lse, lse)
    assert card.calls == [] and flash_bwd.launches == 0
