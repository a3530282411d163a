"""Tensor parallelism for the attention program kinds on two spawned gloo
ranks (a (1, 2) mesh, CPU) against the single-device JAX functions on the
same weights, at the reduced f32 configs (``_torch_tp_refs``):

- deepseek_v2_lite: MLA (heads over "model", the latent cache's lora
  columns split and gathered for the absorbed decode) and EP (4 experts,
  2 a rank) with a shared expert and the dense first layer;
- mixtral_8x22b: sliding windows and EP;
- mixtral_8x22b with ``n_experts=3``: the experts do not divide the axis,
  so the rules split their ffn dim (TP-MoE);
- paligemma_3b: MQA (1 kv head under 2 ranks: wk/wv split mid-head and
  gathered, the decode cache split by sequence), the vision prefix, the
  engine's replicated pools;
- musicgen_medium: the audio frontend's prefix and sinusoidal positions.

Each case holds the prefill logits, the static path's tokens (paligemma's
after the prefix, through the sequence-sharded cache), the engine's tokens
where the model is pageable, and two train steps (losses, gradient norms,
parameters), within 1e-4.
"""

import numpy as np
import pytest

import _torch_tp_refs as refs

B, P, GEN, S = 2, 8, 6, 8
CASES = {"deepseek": ("deepseek_v2_lite", {}),
         "mixtral": ("mixtral_8x22b", {}),
         "mixtral_tp": ("mixtral_8x22b", dict(n_experts=3)),
         "paligemma": ("paligemma_3b", {}),
         "musicgen": ("musicgen_medium", {})}
# the static path without a prefix through generate(mesh=); paligemma's
# static path runs after its prefix (the "serve" job)
STATIC = ("deepseek", "mixtral", "mixtral_tp", "musicgen")


def _case(name):
    arch, changes = CASES[name]
    return refs.case(arch, **changes)


def _inputs(name):
    jm, params, _ = _case(name)
    return (jm, params, refs.prompts(jm.cfg.vocab_size, B, P),
            refs.prefix(jm.cfg, B))


def _payloads():
    out = {}
    for name, (arch, changes) in CASES.items():
        jm, params, toks, pre = _inputs(name)
        base = dict(mesh=(1, 2), arch=arch, cfg_changes=changes,
                    params=params)
        out[f"prefill:{name}"] = dict(base, tokens=toks.astype(np.int64),
                                      prefix=pre, max_len=32)
        if name in STATIC:
            out[f"static:{name}"] = dict(base, prompts=toks, gen=GEN)
        out[f"train:{name}"] = dict(base, options={},
                                    batches=refs.batches(jm.cfg, B, S))
    jm, params, toks, pre = _inputs("paligemma")
    base = dict(mesh=(1, 2), arch="paligemma_3b", params=params)
    out["engine:paligemma"] = dict(base, engine=refs.ENGINE,
                                   traffic=refs.traffic(jm.cfg.vocab_size))
    out["serve:paligemma"] = dict(base, tokens=toks.astype(np.int64),
                                  prefix=pre, max_len=24, gen=GEN)
    return out


def _references():
    out = {}
    for name in CASES:
        jm, params, toks, pre = _inputs(name)
        if name in STATIC:
            def both(jm=jm, params=params, toks=toks):
                return refs.jax_static(jm, params, toks, GEN)
            out[f"static:{name}"] = both
        if name not in STATIC or pre is not None:
            out[f"prefill:{name}"] = (
                lambda jm=jm, params=params, toks=toks, pre=pre:
                refs.jax_prefill(jm, params, toks, pre, 32))
        out[f"train:{name}"] = (lambda jm=jm, params=params: refs.jax_train(
            jm, params, refs.batches(jm.cfg, B, S)))
    jm, params, toks, pre = _inputs("paligemma")
    out["engine:paligemma"] = lambda: refs.jax_engine(
        jm, params, refs.traffic(jm.cfg.vocab_size))
    out["serve:paligemma"] = lambda: refs.jax_static(jm, params, toks, GEN,
                                                     pre=pre, max_len=24)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return refs.run(tmp_path_factory.mktemp("tp_attn"), 2, _payloads(),
                    _references())


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_logits_match_jax(run, name):
    res, want = run
    # the static path's prefill logits where the prompt has no prefix
    ref = want.get(f"prefill:{name}")
    if ref is None:
        ref = want[f"static:{name}"][1]
    for r in res[f"prefill:{name}"]:
        np.testing.assert_allclose(r["logits"], ref, **refs.TOL)
    jm = _case(name)[0]
    cache = res[f"prefill:{name}"][0]["cache"]
    if name == "deepseek":      # the latent's 32 lora columns, 16 a rank
        assert cache["ckv"][-1] == jm.cfg.kv_lora_rank // 2
        assert cache["krope"][-1] == jm.cfg.qk_rope_dim
    if name == "paligemma":     # 1 kv head: JAX's prefill layout splits hd
        assert cache["k"][2] == 1 and cache["k"][-1] == 16


@pytest.mark.parametrize("name", STATIC)
def test_static_tokens_match_jax(run, name):
    res, want = run
    for r in res[f"static:{name}"]:
        assert not r["engine"]
        np.testing.assert_array_equal(r["tokens"], want[f"static:{name}"][0])


@pytest.mark.parametrize("name", list(CASES))
def test_train_steps_match_jax(run, name):
    res, want = run
    refs.check_train(res[f"train:{name}"], want[f"train:{name}"])
    shapes = res[f"train:{name}"][0]["local_shapes"]
    if name == "deepseek":      # EP: 2 of the 4 experts a rank
        assert (1, 2, 128, 64) in shapes
    if name == "mixtral_tp":    # TP-MoE: every expert on half the ffn dim
        assert (2, 3, 128, 32) in shapes


def test_paligemma_engine_tokens_match_jax(run):
    res, want = run
    for r in res["engine:paligemma"]:
        assert r["tokens"] == want["engine:paligemma"] and r["eager"]
        assert r["pool"][2] == 1        # the one kv head, replicated


def test_paligemma_prefix_serve_through_the_sequence_shards(run):
    """The prefill with the vision prefix, moved once into the decode
    layout (1 kv head under 2 ranks: each rank holds half the slots of
    the cache) and decoded, against JAX's prefill + greedy loop."""
    res, want = run
    for r in res["serve:paligemma"]:
        np.testing.assert_array_equal(r["tokens"],
                                      want["serve:paligemma"][0])
        assert r["cache"]["k"] == (2, B, 1, 12, 32)
