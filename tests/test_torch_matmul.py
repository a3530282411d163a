"""The port's blocked matmul op against the JAX package's on the CPU: the
same seeded numpy operands through JAX ``matmul`` (the jnp backend, and
Pallas in interpret mode at the op's example shape) and the port's
``matmul`` (its plain version on CPU tensors), tolerance 1e-4 (f32 sums in
another order); ``out_dtype``, K == 0, empty M/N and the op's errors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul import matmul as jax_matmul

from repro_torch.kernels.matmul import matmul, matmul_ref

TOL = dict(rtol=1e-4, atol=1e-4)


def _ab(seed, m, k, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype("float32"),
            rng.randn(k, n).astype("float32"))


@pytest.mark.parametrize("m,k,n", [(48, 64, 32), (24, 96, 40), (7, 13, 5),
                                   (1, 1, 1), (130, 257, 65)])
def test_matmul_matches_jax_jnp(m, k, n):
    a, b = _ab(m + k + n, m, k, n)
    want = np.asarray(jax_matmul(a, b, backend="jnp"))
    got = matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_matmul_matches_jax_interpret_at_example_shape():
    a, b = _ab(0, 48, 64, 32)
    want = np.asarray(jax_matmul(a, b, block_m=16, block_n=16, block_k=32,
                                 backend="pallas"))
    got = matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("in_dtype,out_dtype", [
    ("float32", "bfloat16"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_matmul_out_dtype_matches_jax(in_dtype, out_dtype):
    a, b = _ab(1, 24, 96, 40)
    ja, jb = (jnp.asarray(x, in_dtype) for x in (a, b))
    want = jax_matmul(ja, jb, out_dtype=out_dtype, backend="jnp")
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    ta, tb = (torch.from_numpy(np.array(x.astype(jnp.float32)))
              .to(tdt[in_dtype]) for x in (ja, jb))
    got = matmul(ta, tb, out_dtype=tdt[out_dtype])
    assert got.dtype == tdt[out_dtype]
    # the same f32 sum rounded once to out_dtype: equal up to one rounding
    rtol = 1e-4 if out_dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=1e-4)


def test_matmul_empty_and_k_zero_give_zeros():
    got = matmul(torch.zeros(4, 0), torch.zeros(0, 4))
    want = np.asarray(jax_matmul(jnp.zeros((4, 0)), jnp.zeros((0, 4))))
    np.testing.assert_array_equal(got.numpy(), want)
    assert matmul(torch.zeros(0, 8), torch.zeros(8, 4)).shape == (0, 4)
    z = matmul(torch.zeros(3, 0), torch.zeros(0, 2), out_dtype=torch.bfloat16)
    assert z.dtype == torch.bfloat16 and (z == 0).all()


def test_matmul_errors_match_jax():
    with pytest.raises(ValueError, match="inner dims disagree"):
        jax_matmul(jnp.ones((4, 3)), jnp.ones((4, 3)))
    with pytest.raises(ValueError, match="inner dims disagree"):
        matmul(torch.ones(4, 3), torch.ones(4, 3))
    with pytest.raises(ValueError, match="dtypes disagree"):
        jax_matmul(jnp.ones((4, 4)), jnp.ones((4, 4), jnp.bfloat16))
    with pytest.raises(ValueError, match="dtypes disagree"):
        matmul(torch.ones(4, 4), torch.ones(4, 4, dtype=torch.bfloat16))


def test_matmul_records_no_graph():
    a = torch.ones(4, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        matmul(a, torch.ones(4, 4))
    with torch.no_grad():
        assert matmul(a, torch.ones(4, 4)).shape == (4, 4)


def test_matmul_ref_accumulates_bf16_products_in_f32():
    a, b = _ab(2, 16, 512, 8)
    ta, tb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    exact = ta.double() @ tb.double()
    got = matmul_ref(ta, tb, out_dtype=torch.float32)
    torch.testing.assert_close(got.double(), exact, rtol=1e-5, atol=1e-5)
