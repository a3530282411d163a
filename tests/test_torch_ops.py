"""The port's op front end (``repro_torch.core.op``): the registry holds
the JAX package's op names, and every op, called on its example inputs,
matches the JAX op on the same numpy values (the JAX op as its own tests
run it: Pallas in interpret mode on the CPU); backend dispatch; the decode
wrappers' split knob (the library stubbed, as on the card). Tolerance: the
JAX registry test's 3e-4 for f32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.kernels  # noqa: F401 -- registers the JAX ops
from repro.core import registered_ops as jax_ops

from repro_torch.core import define_op, get_op, registered_ops, to_tensors
from repro_torch.kernels import reset_launches
from repro_torch.kernels.flash_attention import ops as attn_ops

NAMES = sorted(jax_ops())


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))


def test_registry_holds_the_jax_op_names():
    assert len(NAMES) == 13
    assert sorted(registered_ops()) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_every_op_matches_the_jax_op_on_its_example(name):
    op, jop = get_op(name), jax_ops()[name]
    np_args, np_params = op.example(np.random.RandomState(0))
    args, params = to_tensors(np_args, np_params, "cpu")
    with torch.no_grad():
        got = op(*args, **params)
        plain = op.reference(*args, **params)
    jparams = {k: v for k, v in np_params.items()
               if k in jop.defaults or k in jop.array_params}
    want = np.asarray(jop(*(jnp.asarray(a) for a in np_args), **jparams),
                      np.float32)
    for out in (got, plain):
        assert tuple(out.shape) == want.shape, name
        np.testing.assert_allclose(out.float().numpy(), want, rtol=3e-4,
                                   atol=3e-4, err_msg=name)


@pytest.mark.parametrize("name", NAMES)
def test_raw_and_backends_agree_on_the_cpu(name):
    """auto on CPU tensors is the spec's torch expansion, bit for bit;
    loops (the same source, a cell at a time) agrees within 1e-5 of the
    largest output; raw returns every kernel output, the first of which
    is the public one (rmsnorm's pre flattens x to rows; lm_head_ce's is
    (lse, gold), not the NLL); cuda refuses CPU tensors."""
    op = get_op(name)
    args, params = to_tensors(*op.example(np.random.RandomState(1)), "cpu")
    with torch.no_grad():
        auto = op(*args, **params)
        plain = op(*args, backend="torch", **params)
        loops = op(*args, backend="loops", **params)
        raw = op.raw(*args, **params)
        raw_plain = op.raw(*args, backend="torch", **params)
    torch.testing.assert_close(auto, plain, rtol=0, atol=0)
    scale = float(plain.float().abs().max())
    torch.testing.assert_close(loops, plain, rtol=0, atol=1e-5 * scale)
    first = raw[0] if isinstance(raw, tuple) else raw
    first_plain = raw_plain[0] if isinstance(raw_plain, tuple) else raw_plain
    if name != "lm_head_ce":                 # raw: (lse, gold), not the NLL
        torch.testing.assert_close(first[:auto.shape[0]].reshape(auto.shape)
                                   if name != "rmsnorm" else
                                   first.reshape(auto.shape), auto,
                                   rtol=0, atol=0)
    torch.testing.assert_close(first, first_plain, rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        op(*args, backend="cuda", **params)


def test_unknown_params_and_backends_raise():
    op = get_op("rmsnorm")
    x, w = torch.ones(2, 8), torch.ones(8)
    with pytest.raises(TypeError, match="unexpected params"):
        op(x, w, epz=1e-5)
    with pytest.raises(ValueError, match="backend"):
        op(x, w, backend="pallas")


def test_duplicate_op_name_rejected():
    decl = dict(builder=lambda D: None, ref=None,
                derive_defines=lambda args, params: {})
    with pytest.raises(ValueError, match="already registered"):
        define_op("matmul", **decl)
    op = define_op("matmul", register=False, **decl)
    assert op is not registered_ops()["matmul"]


def test_ops_without_knobs_refuse_to_tune():
    op = get_op("matmul")
    a = torch.ones(4, 4)
    assert op.sweep == {} and op.cached_winner((a, a)) is None
    with pytest.raises(ValueError, match="declares no tuning sweep"):
        op.tune((a, a))


class _Lib:
    """A stand-in kernel library: records each entry point's call and
    returns 0 (no CUDA error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def stub(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(attn_ops, "on_cpu", lambda name, *ts: False)
    monkeypatch.setattr(attn_ops, "load", lambda name, sig: lib)
    monkeypatch.setattr(attn_ops, "stream", lambda: 0)
    monkeypatch.setattr(attn_ops, "_DECODE_ENTRY", None)
    reset_launches()
    return lib


def _paged_inputs(b=8, h=32, hk=8, d=128, page=512, nsp=4):
    npages = b * nsp + 1
    q = torch.empty((b, h, 1, d), dtype=torch.bfloat16)
    pool = torch.empty((npages, hk, page, d), dtype=torch.bfloat16)
    table = torch.zeros((b, nsp), dtype=torch.int32)
    kv_len = torch.zeros((b,), dtype=torch.int32)
    pos = torch.zeros((npages, page), dtype=torch.int32)
    return (q, pool, pool), dict(block_table=table, kv_len=kv_len,
                                 pos_pages=pos)


def test_paged_wrapper_takes_the_adopted_split(stub, monkeypatch):
    """The wrapper launches the split it is given (the adopted winner the
    step builder passes), without one paged_split's rule, whatever the
    cache holds; a split the kernel refuses raises before any launch;
    $REPRO_BACKEND changes nothing (it is not ported)."""
    monkeypatch.setenv("REPRO_BACKEND", "jnp")
    op = get_op("flash_decode_paged")
    args, kw = _paged_inputs()
    split_at = 13                     # the entry point's split argument

    def launched(**extra):
        stub.calls.clear()
        attn_ops.paged_decode_attention(*args, **kw, **extra)
        (name, a), = stub.calls
        assert name == "paged_decode"
        return a[split_at], a

    rule = attn_ops.paged_split(8, 8, 4, 512)[0]
    assert launched()[0] == rule == 64
    split, a = launched(split=128)
    assert split == 128
    assert a[7] is not None            # the workspace: b*h*nsplit*(d+2)
    assert launched(split=256)[0] == 256
    # a persisted winner reaches a launch only as an argument
    from repro_torch.core import target_key, tune_cache_key
    from repro_torch.core.tune import _cache_store
    metas = tuple(torch.empty(t.shape, dtype=t.dtype, device="meta")
                  for t in args)
    dev = torch.device("cpu")
    digest, payload = tune_cache_key(
        op.name, op.derive_defines(metas, dict(op.defaults, **kw)),
        op.sweep, target_key(dev, "torch", op.sources))
    _cache_store(digest, payload, {"split": 128}, 1e-5)
    assert op.cached_winner(metas, device=dev, **kw) == {"split": 128}
    assert launched()[0] == rule
    # other shapes keep their rule
    args2, kw2 = _paged_inputs(b=4)
    stub.calls.clear()
    attn_ops.paged_decode_attention(*args2, **kw2)
    assert stub.calls[0][1][split_at] == attn_ops.paged_split(4, 8, 4,
                                                              512)[0]
    with pytest.raises(ValueError, match="multiple of 32"):
        launched(split=48)
    assert op.refused(args, {"split": 1024}, **kw) is not None
    assert op.refused(args, {"split": 512}, **kw) is None


def test_flash_decode_wrapper_takes_the_adopted_split(stub):
    op = get_op("flash_decode")
    q = torch.empty((8, 24, 1, 64), dtype=torch.bfloat16)
    k = torch.empty((8, 24, 576, 64), dtype=torch.bfloat16)
    split_at = 15

    def launched(**extra):
        stub.calls.clear()
        attn_ops.flash_decode(q, k, k, kv_len=300, **extra)
        (name, a), = stub.calls
        assert name == "flash_decode"
        return a[split_at]

    assert launched() == attn_ops.decode_split(8, 24, 576)[0]
    assert launched(split=64) == 64
    # the window is part of the shapes a winner answers for
    assert (op.derive_defines((q, k, k), dict(op.defaults, window=100))
            != op.derive_defines((q, k, k), dict(op.defaults)))
    with pytest.raises(ValueError, match="multiple of 32"):
        launched(split=600)
