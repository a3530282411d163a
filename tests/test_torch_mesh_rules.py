"""The port's sharding rules against the JAX package's, on shapes alone (no
ranks): for all ten configs, whole (meta tensors in the port,
``jax.eval_shape`` in JAX), the parameter, ZeRO-1, batch, static-cache
(decode and prefill) and paged-cache specs and the bytes a device holds,
on five meshes, leaf for leaf; ``choose_mesh_shape``, ``mesh_probes`` and
``Rules.spec``; and ``make_shardings`` taking every config
tensor-parallel. Both packages get one stand-in
mesh with ``.shape`` and ``.axis_names`` (their functions read nothing
else)."""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.launch import tuning as jax_tuning
from repro.models import LM as JaxLM
from repro.parallel import rules as jax_rules
from repro.parallel import steps as jax_steps
from repro.parallel.context import Rules as JaxRules
from repro.runtime import choose_mesh_shape as jax_choose

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import tuning
from repro_torch.models import LM
from repro_torch.parallel import (Rules, batch_specs, make_shardings,
                                  param_specs, spec_bytes_per_device,
                                  zero1_specs)
from repro_torch.parallel import steps
from repro_torch.parallel.rules import spec_leaves
from repro_torch.runtime import choose_mesh_shape

MESHES = {"1x2": {"data": 1, "model": 2}, "2x2": {"data": 2, "model": 2},
          "2x4": {"data": 2, "model": 4}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class Mesh:
    """What the rule functions of both packages read of a mesh."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _jax_flat(tree):
    """{keystr: spec tuple} of a JAX spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _port_flat(tree, prefix=""):
    """{keystr: spec} of a port spec tree (spec tuples are the leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_port_flat(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_flat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tuple(tree)}


@functools.lru_cache(maxsize=None)
def _models(arch):
    jm = JaxLM(jax_get_config(arch))
    jshape = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    tm = LM(get_config(arch), device="cpu")
    return jm, jshape, tm, steps.params_shape(tm)


def _shapes_equal(jshape, tshape):
    from repro_torch.tree import leaves_with_path

    j = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in
         jax.tree_util.tree_flatten_with_path(jshape)[0]}
    assert {k: tuple(v.shape) for k, v in leaves_with_path(tshape)} == j


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_and_bytes_match_jax(arch):
    jm, jshape, tm, tshape = _models(arch)
    for name, shape in MESHES.items():
        jmesh = tmesh = Mesh(shape)
        jp = jax_rules.param_specs(jshape, jm.cfg, jmesh)
        tp = param_specs(tshape, tm.cfg, tmesh)
        assert _port_flat(tp) == _jax_flat(jp), (arch, name)
        jz = jax_rules.zero1_specs(jp, jshape, jmesh)
        tz = zero1_specs(tp, tshape, tmesh)
        assert _port_flat(tz) == _jax_flat(jz), (arch, name)
        for js, ts in ((jp, tp), (jz, tz)):
            assert spec_bytes_per_device(tshape, ts, tmesh) == \
                jax_rules.spec_bytes_per_device(jshape, js, jmesh), (arch,
                                                                     name)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_jax(arch):
    jm, _, tm, _ = _models(arch)
    cfg = tm.cfg
    tokens = (8, 64)
    jb = {"tokens": jax.ShapeDtypeStruct(tokens, jnp.int32)}
    tb = {"tokens": torch.empty(tokens, dtype=torch.int32, device="meta")}
    if cfg.frontend:
        pe = (8, cfg.num_prefix_embeddings, cfg.d_model)
        jb["prefix_embeddings"] = jax.ShapeDtypeStruct(pe, jnp.float32)
        tb["prefix_embeddings"] = torch.empty(pe, device="meta")
    for name, shape in MESHES.items():
        jmesh = tmesh = Mesh(shape)
        assert _port_flat(steps.batch_pspecs(tb, tmesh)) == _jax_flat(
            jax_steps.batch_pspecs(jb, jmesh)), (arch, name)
        for axes in (("pod", "data"), ("data",)):
            assert _port_flat(batch_specs(tb, batch_axes=axes)) == \
                _jax_flat(jax_rules.batch_specs(jb, batch_axes=axes))
        for batch in (8, 64):
            for kind in ("decode", "prefill"):
                got = steps.cache_pspecs(tm, tmesh, batch, 4096, kind=kind)
                want = jax_steps.cache_pspecs(jm, jmesh, batch, 4096,
                                              kind=kind)
                assert _port_flat(got) == _jax_flat(want), (arch, name,
                                                            batch, kind)
        got = steps.paged_cache_pspecs(tm, tmesh, 8)
        want = jax_steps.paged_cache_pspecs(jm, jmesh, 8)
        assert _port_flat(got) == _jax_flat(want), (arch, name)


def test_param_shapes_are_jaxs():
    """The meta parameter trees the specs read have JAX's paths and
    shapes (so leaf-for-leaf equality above compares like with like)."""
    for arch in ARCHS:
        _, jshape, _, tshape = _models(arch)
        _shapes_equal(jshape, tshape)


def test_choose_mesh_shape_matches_jax():
    for n in (1, 2, 4, 8, 16, 32, 64, 256, 512):
        for model in (1, 2, 4, 8, 16):
            if n < model:
                continue
            assert choose_mesh_shape(n, model=model) == jax_choose(
                n, model=model)
            for pod in (1, 2):
                if n // (pod * model) >= 1:
                    assert choose_mesh_shape(n, model=model, pod=pod) == \
                        jax_choose(n, model=model, pod=pod)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_probes_match_jax(arch):
    for shards in (1, 2, 4):
        got = tuning.mesh_probes(get_config(arch), 2, 1024, shards=shards)
        want = jax_tuning.mesh_probes(jax_get_config(arch), 2, 1024,
                                      shards=shards)
        assert sorted(got) == sorted(want)
        for op in got:
            (targs, tkw), (jargs, jkw) = got[op], want[op]
            assert [tuple(a.shape) for a in targs] == \
                [tuple(a.shape) for a in jargs]
            assert [str(a.dtype).removeprefix("torch.") for a in targs] == \
                [str(a.dtype) for a in jargs]
            assert tkw == jkw
    with pytest.raises(ValueError, match="does not divide"):
        tuning.mesh_probes(get_config(arch), 2, 1000, shards=3)


def test_rules_spec_matches_jax_for_every_kind():
    kinds = ("act_btd", "act_btf", "act_bhsd", "act_bd", "act_btv", "nope")
    for kw in ({}, dict(batch_axes=("data",), seq_axes="model"),
               dict(ring_axis="model"), dict(model_axis="tp")):
        for kind in kinds:
            want = JaxRules(**kw).spec(kind)
            got = Rules(**kw).spec(kind)
            assert (got is None) == (want is None), (kw, kind)
            if want is not None:
                assert got == tuple(want), (kw, kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_shardings_takes_every_kind_tensor_parallel(arch):
    """Every config runs tensor-parallel at (1, 2) and (1, 16): the rules
    declare it, the placements hold the specs leaf for leaf, and the layers'
    cache layout is JAX's prefill layout; data parallelism alone declares
    none, and the ring keeps the parameters replicated over "model"."""
    tm = LM(get_config(arch), device="cpu")
    dp = make_shardings(tm, Mesh({"data": 4, "model": 1}))
    assert not dp[2].tensor_parallel
    for model in (2, 16):
        mesh = Mesh({"data": 1, "model": model})
        placements, pspecs, rules, shape = make_shardings(tm, mesh)
        assert rules.tensor_parallel and rules.ring_axis is None
        assert spec_leaves(pspecs) == [p.spec for p in jax.tree.leaves(
            placements, is_leaf=lambda x: isinstance(x, steps.Placement))]
        assert rules.cache == steps.layer_cache_specs(tm, mesh, 1, 0,
                                                      kind="prefill")
    ring = make_shardings(tm, Mesh({"data": 1, "model": 2}), ring=True)
    assert ring[2].ring_axis == "model" and not ring[2].tensor_parallel
    assert all("model" not in s for s in spec_leaves(ring[1]))


def test_make_production_mesh_needs_its_world_size(tmp_path):
    """The (16, 16) and (2, 16, 16) meshes need 256 and 512 ranks: a
    group of another size is refused with the size it needs, and no group
    at all says to start one."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        make_production_mesh(device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="256 ranks"):
            make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match=r"\('pod', 'data', 'model'\)"
                           r" needs a process group of 512 ranks"):
            make_production_mesh(multi_pod=True, device="cpu")
    finally:
        dist.destroy_process_group()
