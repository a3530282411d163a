"""GPipe pipeline parallelism (``repro_torch.parallel.pipeline``) on four
spawned gloo ranks (a ("pipe",) mesh, CPU) against JAX's, with JAX's test
setup (``tests/test_parallel_and_backend.py``: 8 residual tanh layers of
width 16 in 4 stages, 6 microbatches of 4 rows):

- ``split_stages`` and ``stage_param_specs`` equal JAX's;
- the forward against JAX's ``pipeline_apply`` (run in a subprocess with 4
  host devices, as JAX's test runs it) within 1e-5;
- each stage's gradients against ``split_stages(jax.grad(loss_seq))``
  within 1e-4. JAX's gradient through ``pipeline_apply`` raises in this
  JAX version (the reference failure
  ``test_pipeline_parallel_matches_sequential_subprocess``), so the
  sequential model's gradient is the reference.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_tp_refs as refs
from repro.parallel.pipeline import split_stages as jax_split_stages
from repro.parallel.pipeline import stage_param_specs as jax_stage_specs
from repro_torch.parallel.pipeline import split_stages, stage_param_specs

L, D, M, MB, STAGES = 8, 16, 6, 4, 4

_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.parallel.pipeline import pipeline_apply, split_stages

d = np.load(sys.argv[1])
stacked = {"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])}
x = jnp.asarray(d["x"])
mesh = jax.make_mesh((4,), ("pipe",))

def layer(p, x):
    return x + jnp.tanh(x @ p["w"] + p["b"])

def stage_fn(params_i, x):
    x, _ = jax.lax.scan(lambda x, lp: (layer(lp, x), None), x, params_i)
    return x

def seq_apply(stacked, x):
    y, _ = jax.lax.scan(lambda x, lp: (layer(lp, x), None), x, stacked)
    return y

stages = jax.device_put(split_stages(stacked, 4), jax.tree.map(
    lambda _: NamedSharding(mesh, P("pipe")), split_stages(stacked, 4)))
y = pipeline_apply(stage_fn, stages, x, mesh=mesh)
g = split_stages(jax.grad(lambda s: (jax.vmap(lambda xb: seq_apply(s, xb))(
    x) ** 2).sum())(stacked), 4)
np.savez(sys.argv[2], y=np.asarray(y), gw=np.asarray(g["w"]),
         gb=np.asarray(g["b"]))
"""


def _inputs():
    rng = np.random.RandomState(0)
    return ({"w": (rng.randn(L, D, D) * 0.2).astype(np.float32),
             "b": (rng.randn(L, D) * 0.1).astype(np.float32)},
            rng.randn(M, MB, D).astype(np.float32))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    stacked, x = _inputs()
    ranks = refs.Ranks(tmp, STAGES, ["pipeline"],
                       {"pipeline": dict(mesh=(1, STAGES), stacked=stacked,
                                         x=x)})
    np.savez(tmp / "in.npz", x=x, **stacked)
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    res = subprocess.run([sys.executable, "-c", _JAX, str(tmp / "in.npz"),
                          str(tmp / "out.npz")], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return ranks.join()["pipeline"], dict(np.load(tmp / "out.npz"))


def test_split_stages_and_specs_equal_jax():
    stacked, _ = _inputs()
    got = split_stages({k: torch.from_numpy(v) for k, v in stacked.items()},
                       STAGES)
    want = jax_split_stages({k: jnp.asarray(v) for k, v in stacked.items()},
                            STAGES)
    for k in stacked:
        assert tuple(got[k].shape) == (STAGES, L // STAGES) + \
            stacked[k].shape[1:]
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    specs = {"w": (None, None, "model"), "b": (None, None), "n": [(None,)]}
    jspecs = jax_stage_specs({"w": P(None, None, "model"), "b": P(None, None),
                              "n": [P(None)]})
    mine = stage_param_specs(specs)
    flat = jax.tree.leaves(jspecs, is_leaf=lambda s: isinstance(s, P))
    assert [mine["b"], mine["n"][0], mine["w"]] == [tuple(s) for s in flat]


def test_pipeline_forward_matches_jax(run):
    res, want = run
    for r in res:
        np.testing.assert_allclose(r["y"], want["y"], rtol=1e-5, atol=1e-5)


def test_pipeline_gradients_match_the_sequential_model(run):
    res, want = run
    assert sorted(r["stage"] for r in res) == list(range(STAGES))
    for r in res:
        s = r["stage"]
        np.testing.assert_allclose(r["grads"]["w"][0], want["gw"][s],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["grads"]["b"][0], want["gb"][s],
                                   rtol=1e-4, atol=1e-4)
