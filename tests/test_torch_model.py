"""The PyTorch port's model against the JAX package, on the CPU: configs,
block fitting, rope, parameter conversion, prefill logits and the paged
greedy step on reduced ``llama3_2_1b`` in f32 (tolerance 1e-4: the same
f32 math with sums in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.device import fit_block as jax_fit_block
from repro.layers import blocks as jax_blocks
from repro.layers.rope import apply_rope as jax_apply_rope
from repro.models import LM as JaxLM

from repro_torch import fit_block
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.layers import blocks
from repro_torch.layers.rope import apply_rope
from repro_torch.models import LM, from_jax_params
from repro_torch.models.lm import _layer

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    """(torch LM, torch params, JAX LM, JAX params) on reduced llama3_2_1b,
    the port's weights converted from the JAX init."""
    jcfg = jax_reduced(jax_get_config("llama3_2_1b"))
    jm = JaxLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = LM(reduced(get_config("llama3_2_1b")), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return tm, tp, jm, jp


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# copies of the JAX package's host code
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_configs_equal_jax(arch):
    assert ARCHS == JAX_ARCHS
    tc, jc = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(reduced(tc)) == dataclasses.asdict(
        jax_reduced(jc))


def test_fit_block_equals_jax():
    for n in (1, 7, 12, 352, 1056, 2048):
        for b in (1, 4, 100, 512, 4096):
            assert fit_block(b, n) == jax_fit_block(b, n)
    assert fit_block(512, 1056) == 352


def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 6, 32), np.float32)
    pos = np.arange(6)
    np.testing.assert_allclose(
        _np(apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5)),
        np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5)),
        rtol=1e-5, atol=1e-5)
    lens = np.array([3, 17], np.int32)[:, None, None]
    x1 = x[:, :, :1]
    np.testing.assert_allclose(
        _np(apply_rope(torch.from_numpy(x1), torch.from_numpy(lens), 5e5)),
        np.asarray(jax_apply_rope(jnp.asarray(x1), jnp.asarray(lens), 5e5)),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_from_jax_params_keeps_paths_and_shapes(pair):
    tm, tp, jm, jp = pair
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        t = tp
        for k in path:
            t = t[k.key if hasattr(k, "key") else k.idx]
        assert tuple(t.shape) == leaf.shape, path
        np.testing.assert_array_equal(_np(t), np.asarray(leaf))
    assert tm.param_count(tp) == jm.param_count(jp)


def test_init_matches_jax_tree_and_is_seeded(pair):
    tm, tp, _, jp = pair
    p1 = tm.init(torch.Generator().manual_seed(1))
    p2 = tm.init(torch.Generator().manual_seed(1))
    jshape = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    tshape = jax.tree.map(lambda a: (tuple(a.shape),
                                     str(a.dtype).split(".")[-1]), p1)
    assert tshape == jshape
    assert all(torch.equal(a, b) for a, b in
               zip(jax.tree.leaves(p1), jax.tree.leaves(p2)))


def test_bf16_params_convert_bit_exact():
    a = jnp.asarray(np.random.default_rng(0).standard_normal((5, 3)),
                    jnp.bfloat16)
    t = from_jax_params({"w": np.asarray(a)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# forward paths
# ---------------------------------------------------------------------------

def test_tblock_forward_matches_jax(pair):
    tm, tp, jm, jp = pair
    x = np.random.default_rng(1).standard_normal((2, 7, tm.cfg.d_model),
                                                 np.float32)
    lp = jax.tree.map(lambda a: a[0], jp["stacks"][0])
    want, _ = jax_blocks.tblock_forward(lp, jnp.asarray(x), jm.cfg)
    got, _ = blocks.tblock_forward(_layer(tp["stacks"][0], 0),
                                   torch.from_numpy(x), tm.cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("lens,max_len", [((5,), None), ((9,), None),
                                          ((3, 3), None), ((7, 7), 12)])
def test_prefill_logits_match_jax(pair, lens, max_len):
    tm, tp, jm, jp = pair
    rng = np.random.default_rng(sum(lens))
    toks = rng.integers(1, tm.cfg.vocab_size, (len(lens), lens[0]))
    jl, jc = jm.prefill(jp, jnp.asarray(toks, jnp.int32), max_len=max_len)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=max_len)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc["stacks"][0][key]),
                                   np.asarray(jc["stacks"][0][key]), **TOL)
    assert tc["pos"] == int(jc["pos"])


def test_paged_greedy_step_matches_jax(pair):
    """Six teacher-forced steps over 3 slots (one idle on the null page),
    pages shuffled through the pool: logits and tokens match each step."""
    tm, tp, jm, jp = pair
    b, pg, nsp, npages = 3, 4, 3, 8
    table = np.array([[5, 2, 7], [1, 6, 3], [0, 0, 0]], np.int32)
    jcache = jm.init_paged_cache(b, npages, pg, nsp)
    jcache["table"] = jnp.asarray(table)
    tcache = tm.init_paged_cache(b, npages, pg, nsp)
    tcache["table"] = torch.from_numpy(table)
    rng = np.random.default_rng(3)
    jstep = jax.jit(jm.paged_greedy_step)
    for step in range(6):
        toks = rng.integers(1, tm.cfg.vocab_size, (b, 1)).astype(np.int32)
        jn, jl, jcache = jstep(jp, jnp.asarray(toks), jcache)
        # the idle slot's length stays 0 (the engine clears it each step)
        jcache["len"] = jcache["len"].at[2].set(0)
        tn, tl, tcache = tm.paged_greedy_step(tp, torch.from_numpy(toks),
                                              tcache)
        tcache["len"][2] = 0
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL,
                                   err_msg=f"step {step}")
        assert (_np(tn) == np.asarray(jn)).all(), step
        np.testing.assert_array_equal(_np(tcache["pos_pages"]),
                                      np.asarray(jcache["pos_pages"]))
    np.testing.assert_allclose(_np(tcache["stacks"][0]["kp"]),
                               np.asarray(jcache["stacks"][0]["kp"]),
                               **TOL)


def test_greedy_token_matches_jax(pair):
    tm, _, jm, _ = pair
    logits = np.random.default_rng(0).standard_normal((3, tm.vpad),
                                                      np.float32)
    logits[1, 7] = logits[1, 300] = 50.0          # tie: first wins
    np.testing.assert_array_equal(
        _np(tm.greedy_token(torch.from_numpy(logits))),
        np.asarray(jm.greedy_token(jnp.asarray(logits))))


# ---------------------------------------------------------------------------
# entry points: the card unless the CPU is asked for
# ---------------------------------------------------------------------------

def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("llama3_2_1b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_params({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(cfg, device="cuda")


@pytest.mark.parametrize("arch,changes,kinds,pageable", [
    ("llama3_2_1b", {}, ["dense"], True),
    ("internlm2_20b", {}, ["dense"], True),
    ("granite_3_8b", {}, ["dense"], True),
    ("musicgen_medium", {}, ["dense"], False),
    ("falcon_mamba_7b", {}, ["mamba1"], False),
    ("mixtral_8x22b", {}, ["moe"], False),                  # its window
    ("mixtral_8x22b", dict(window=None), ["moe"], True),
    ("deepseek_v2_lite", {}, ["dense", "moe"], False),      # MLA
    ("zamba2_7b", {}, ["zamba_group"], False),
    ("zamba2_7b", dict(n_layers=5), ["zamba_group", "mamba2"], False),
    ("zamba2_7b", dict(shared_attn_every=0), ["mamba2"], False),
    ("paligemma_3b", {}, ["dense"], True)])
def test_build_program_admits_the_ported_architectures(arch, changes, kinds,
                                                       pageable):
    """The program equals the JAX package's, and the paged engine takes
    exactly the models the JAX ``LM.pageable`` admits."""
    tm = LM(dataclasses.replace(reduced(get_config(arch)), **changes),
            device="cpu")
    jm = JaxLM(dataclasses.replace(jax_reduced(jax_get_config(arch)),
                                   **changes))
    assert [s.kind for s in tm.program] == kinds == [
        s.kind for s in jm.program]
    assert [s.n for s in tm.program] == [s.n for s in jm.program]
    assert [s.group for s in tm.program] == [s.group for s in jm.program]
    assert tm.pageable == jm.pageable == pageable
