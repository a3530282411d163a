"""Elastic rescaling, the ring op's mesh schedule and the ring at the wide
head dims, on the CPU:

- JAX's reshard-on-restore scenario (``tests/test_elastic_and_examples.py``)
  at 4 -> 2 spawned gloo ranks: train reduced ``llama3_2_1b`` on a (2, 2)
  mesh for 3 steps and save, take a 4th step; restore the checkpoint onto
  a (1, 2) mesh (a new process group, as a restarted job) and take that
  step there: the two losses agree within JAX's 1e-3;
- ``ring_flash_op(..., mesh=)`` over 2 ranks against JAX's local ring (an
  op without an ``OpShard`` refuses ``mesh=`` with JAX's message);
- the ring at head dims 112 and 256 (zamba2's shared block, paligemma):
  the port's local ring, forward and gradients, against JAX's.

Tolerance 1e-4 for the ring (f32, sums and merges in another order).
"""

import jax
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ring as jax_ring
from repro_torch.core import get_op
from repro_torch.kernels.flash_attention import ring_flash_attention
from repro_torch.runtime import choose_mesh_shape

from test_torch_mesh_steps import jax_model, spawn

TOL = dict(rtol=1e-4, atol=1e-4)
RING_KW = dict(causal=True, window=40)
RING_RESULTS = []       # the ring op's rank results, from the 2-rank job


def _qkv(seed, b=1, h=4, hk=2, s=64, d=32):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, s, d).astype("float32"),
            rng.randn(b, hk, s, d).astype("float32"),
            rng.randn(b, hk, s, d).astype("float32"))


def test_reshard_on_restore_4_to_2_ranks(tmp_path):
    _, jp = jax_model()
    tokens = np.zeros((8, 32), np.int32)
    ck = str(tmp_path / "ck")
    for d in ("four", "two"):
        (tmp_path / d).mkdir()
    big = spawn(tmp_path / "four", 4, ["elastic"], {"elastic": dict(
        mesh=(2, 2), params=jp, tokens=tokens, dir=ck, phase="save")})
    assert choose_mesh_shape(2, model=2) == (1, 2)
    # the restored job also runs the ring op's case (one spawn for both)
    small = spawn(tmp_path / "two", 2, ["elastic", "ring_op"], {
        "elastic": dict(mesh=(1, 2), params=jp, tokens=tokens, dir=ck,
                        phase="restore"),
        "ring_op": dict(mesh=(1, 2), qkv=_qkv(5), kw=RING_KW)})
    RING_RESULTS.extend(small["ring_op"])
    full = {r["next_loss"] for r in big["elastic"]}
    assert len(full) == 1                   # every rank: the global loss
    for r in small["elastic"]:
        assert r["restored_step"] == 3
        assert abs(r["next_loss"] - big["elastic"][0]["next_loss"]) < 1e-3
        assert r["next_loss"] < big["elastic"][0]["loss_before"]


def test_ring_op_on_a_mesh_matches_jax_local_ring(tmp_path):
    """The ring op's case ran in the restored 2-rank job above (run here
    on its own when that test is not selected)."""
    qkv = _qkv(5)
    res = list(RING_RESULTS)
    if not res:
        res = spawn(tmp_path, 2, ["ring_op"], {"ring_op": dict(
            mesh=(1, 2), qkv=qkv, kw=RING_KW)})["ring_op"]
    want = jax_ring.ring_flash_attention(*qkv, ring_steps=2, backend="jnp",
                                         block_q=32, block_kv=32, **RING_KW)
    got = np.concatenate([r["o"] for r in res], axis=2)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for r in res:
        assert "declares no mesh schedule (OpShard)" in r["refused"]
    op = get_op("ring_flash")
    assert op.shard.collective == "ppermute" and op.shard.rotate == (1, 2)
    assert op.shard.in_specs("model", qkv) == ((None, None, "model", None),
                                               ) * 3
    with pytest.raises(ValueError, match="no axis 'model'"):
        op(*map(torch.from_numpy, qkv),
           mesh=type("M", (), {"shape": {"data": 2}})())


@pytest.mark.parametrize("d", [112, 256])
def test_local_ring_at_wide_head_dims_matches_jax(d):
    """The shapes the ring prefill of zamba2's shared block (d 112) and of
    paligemma (d 256, a prefix) reach: o and the q/k/v gradients."""
    qkv = _qkv(9, h=2, hk=1, s=64, d=d)
    kw = dict(causal=True, prefix_len=16 if d == 256 else 0)

    def jfn(q, k, v):
        return jax_ring.ring_flash_attention(q, k, v, ring_steps=2,
                                             backend="jnp", block_q=32,
                                             block_kv=32, **kw)

    want = [np.asarray(jfn(*qkv))] + [np.asarray(g) for g in jax.grad(
        lambda *a: (jfn(*a) ** 2).sum(), argnums=(0, 1, 2))(*qkv)]
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in qkv]
    o = ring_flash_attention(*ts, ring_steps=2, **kw)
    got = [o] + list(torch.autograd.grad((o ** 2).sum(), ts))
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.detach().numpy(), b, err_msg=name,
                                   **TOL)
