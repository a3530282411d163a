"""Tensor parallelism for the SSM program kinds on two spawned gloo ranks
(a (1, 2) mesh, CPU) against the single-device JAX functions on the same
weights, at the reduced f32 configs (``_torch_tp_refs``):

- falcon_mamba_7b (mamba1): every d_inner leaf split, x_proj row-parallel
  with its outputs summed before the dt/B/C norm, the decode state in
  d_inner shards;
- zamba2_7b (mamba2 groups and the shared attention block): the di + 2N
  conv columns split (288, 144 a rank: rank 0 holds x of 4.5 heads, rank 1
  the rest of x and B and C), the conv output gathered, the gated norm's
  sum of squares over the global d_inner, the heads' state in shards.

Each holds the prefill logits, the static path's tokens and two train
steps within 1e-4. ``TrainLoop(mesh=)`` on zamba2 is held against the
one-device loop (its own seed's init and data).
"""

import numpy as np
import pytest

import _torch_tp_refs as refs

B, P, GEN, S = 2, 8, 6, 8
ARCHS = ("falcon_mamba_7b", "zamba2_7b")


def _payloads():
    out = {}
    for arch in ARCHS:
        jm, params, _ = refs.case(arch)
        cfg = jm.cfg
        base = dict(mesh=(1, 2), arch=arch, params=params)
        toks = refs.prompts(cfg.vocab_size, B, P)
        out[f"prefill:{arch}"] = dict(base, tokens=toks.astype(np.int64),
                                      max_len=P + GEN)
        out[f"static:{arch}"] = dict(base, prompts=toks, gen=GEN)
        out[f"train:{arch}"] = dict(base, options={},
                                    batches=refs.batches(cfg, B, S))
    out["loop:zamba2_7b"] = dict(mesh=(1, 2), arch="zamba2_7b",
                                 params=refs.case("zamba2_7b")[1], loop=LOOP)
    return out


LOOP = dict(global_batch=B, seq_len=S, steps=2)


def _references():
    out = {}
    for arch in ARCHS:
        jm, params, _ = refs.case(arch)
        toks = refs.prompts(jm.cfg.vocab_size, B, P)
        out[f"static:{arch}"] = (lambda jm=jm, params=params, toks=toks:
                                 refs.jax_static(jm, params, toks, GEN))
        out[f"train:{arch}"] = (lambda jm=jm, params=params: refs.jax_train(
            jm, params, refs.batches(jm.cfg, B, S)))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return refs.run(tmp_path_factory.mktemp("tp_ssm"), 2, _payloads(),
                    _references())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(run, arch):
    res, want = run
    for r in res[f"prefill:{arch}"]:
        np.testing.assert_allclose(r["logits"], want[f"static:{arch}"][1],
                                   **refs.TOL)
    jm, _, _ = refs.case(arch)
    di, n = jm.cfg.resolved_d_inner, jm.cfg.ssm_state
    conv = di if arch == "falcon_mamba_7b" else di + 2 * n
    assert res[f"prefill:{arch}"][0]["cache"]["conv"][-1] == conv // 2


@pytest.mark.parametrize("arch", ARCHS)
def test_static_tokens_match_jax(run, arch):
    res, want = run
    for r in res[f"static:{arch}"]:
        np.testing.assert_array_equal(r["tokens"], want[f"static:{arch}"][0])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(run, arch):
    res, want = run
    refs.check_train(res[f"train:{arch}"], want[f"train:{arch}"])


def test_trainloop_on_a_mesh_matches_one_device(run):
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import LM

    res, _ = run
    torch.manual_seed(0)
    model = LM(reduced(get_config("zamba2_7b")), device="cpu")
    want = TrainLoop(model=model, verbose=False, **LOOP).run()["history"]
    for r in res["loop:zamba2_7b"]:
        np.testing.assert_allclose(r["history"], want, **refs.TOL)


def test_zamba2_conv_columns_split_a_head():
    """Reduced zamba2's xBC columns (di 256 + 2 x 16) split 144 a rank:
    the boundary falls inside head 4 of 32 channels, as the full width's
    3648 columns fall inside a head of 64."""
    jm, _, _ = refs.case("zamba2_7b")
    cfg = jm.cfg
    cols = (cfg.resolved_d_inner + 2 * cfg.ssm_state) // 2
    assert cols == 144 and cols % cfg.ssm_head_dim
