"""Kv heads below the model axis on four spawned gloo ranks (a (1, 4)
mesh, CPU) against the single-device JAX functions on the same weights,
at the reduced f32 configs (``_torch_tp_refs``):

- llama3_2_1b: 2 kv heads under 4 ranks: wk/wv split mid-head (16 of a
  head's 32 columns a rank) and gathered before RoPE; the static decode
  cache split by sequence (JAX's decode layout), each rank attending every
  query head over its slots and the partials merged by lse;
- mixtral_8x22b: the rolling window's slots and ``slot_pos`` split by
  sequence, decoded past the window;
- ``Engine(mesh=)`` with replicated pools (llama3_2_1b);
- musicgen_medium with ``n_heads=n_kv_heads=6``: the query heads split
  mid-head (192 columns, 48 a rank), q gathered and each rank's ``wo``
  rows taking their columns of the attention output.

Prefill logits within 1e-4, tokens exactly.
"""

import numpy as np
import pytest

import _torch_tp_refs as refs

B = 2
CASES = {"llama": (("llama3_2_1b", {}), 10, 6),
         "mixtral": (("mixtral_8x22b", {}), 30, 10),
         "musicgen6": (("musicgen_medium", dict(n_heads=6, n_kv_heads=6)),
                       10, 6)}


def _payloads():
    out = {}
    for name, ((arch, changes), plen, gen) in CASES.items():
        jm, params, _ = refs.case(arch, **changes)
        base = dict(mesh=(1, 4), arch=arch, cfg_changes=changes,
                    params=params)
        toks = refs.prompts(jm.cfg.vocab_size, B, plen)
        out[f"prefill:{name}"] = dict(base, tokens=toks.astype(np.int64),
                                      max_len=plen + gen)
        out[f"serve:{name}"] = dict(base, tokens=toks.astype(np.int64),
                                    max_len=plen + gen, gen=gen)
    jm, params, _ = refs.case("llama3_2_1b")
    out["engine:llama"] = dict(mesh=(1, 4), params=params,
                               engine=refs.ENGINE,
                               traffic=refs.traffic(jm.cfg.vocab_size))
    return out


def _references():
    out = {}
    for name, ((arch, changes), plen, gen) in CASES.items():
        jm, params, _ = refs.case(arch, **changes)
        toks = refs.prompts(jm.cfg.vocab_size, B, plen)
        out[name] = (lambda jm=jm, params=params, toks=toks, gen=gen:
                     refs.jax_static(jm, params, toks, gen))
    jm, params, _ = refs.case("llama3_2_1b")
    out["engine"] = lambda: refs.jax_engine(jm, params,
                                            refs.traffic(jm.cfg.vocab_size))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return refs.run(tmp_path_factory.mktemp("tp_seq"), 4, _payloads(),
                    _references())


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_logits_match_jax(run, name):
    res, want = run
    for r in res[f"prefill:{name}"]:
        np.testing.assert_allclose(r["logits"], want[name][1], **refs.TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_sequence_sharded_decode_matches_jax(run, name):
    (arch, changes), plen, gen = CASES[name]
    res, want = run
    for r in res[f"serve:{name}"]:
        np.testing.assert_array_equal(r["tokens"], want[name][0])
    cfg = refs.case(arch, **changes)[0].cfg
    m = min(plen + gen, cfg.window) if cfg.window else plen + gen
    # every kv head, a quarter of the slots a rank
    assert res[f"serve:{name}"][0]["cache"]["k"][2:] == (
        cfg.n_kv_heads, m // 4, cfg.resolved_head_dim)
    if cfg.window:
        assert res[f"serve:{name}"][0]["cache"]["slot_pos"][-1] == m // 4


def test_engine_with_replicated_pools_matches_jax(run):
    res, want = run
    jm = refs.case("llama3_2_1b")[0]
    for r in res["engine:llama"]:
        assert r["tokens"] == want["engine"]
        assert r["pool"][2] == jm.cfg.n_kv_heads     # all kv heads a rank
