"""The port's kernel language (``repro_torch.core.lang``) against the JAX
package's, on the CPU.

Each test spec is written twice, a jnp body for ``repro.core`` and a torch
body for ``repro_torch.core`` (most bodies read the same in both), and the
same numpy inputs, made from a seed, go through the JAX ``jnp`` expansion
and the port's ``torch`` and ``loops`` expansions. Tolerances: elementwise
and stencil outputs within 1e-6 of the largest |reference| (one f32
rounding in another order), products at ``MM_TOL`` (rtol = atol = 2e-4,
``tests/test_torch_apps.py``'s: f32 sums in another order). Every grid has
at most 64 cells (the loops expansion is a Python loop over them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro_torch import core as tcore

MM_TOL = dict(rtol=2e-4, atol=2e-4)
PORT = ("torch", "loops")


def _run_jax(builder, defines, arrays):
    k = jcore.Device("jnp").build_kernel(builder, defines)
    return [np.asarray(o) for o in k.run(*[jnp.asarray(a) for a in arrays])]


def _run_port(backend, builder, defines, arrays):
    k = tcore.Device(backend, device="cpu").build_kernel(builder, defines)
    return [o.numpy() for o in k.run(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])]


def _agree(jb, tb, defines, arrays, *, mm=False):
    """The port's torch and loops expansions against JAX's jnp one."""
    ref = _run_jax(jb, defines, arrays)
    for be in PORT:
        got = _run_port(be, tb, defines, arrays)
        assert len(got) == len(ref)
        for r, g in zip(ref, got):
            assert g.shape == r.shape and g.dtype == r.dtype, be
            if mm:
                np.testing.assert_allclose(g, r, err_msg=be, **MM_TOL)
            else:
                lim = 1e-6 * max(float(np.abs(r).max()), 1e-30)
                err = float(np.abs(g.astype(np.float64) - r).max())
                assert err <= lim, (be, err, lim)
    return ref


def _pair(make, jbody, tbody=None):
    """(JAX builder, port builder) from a spec factory make(pkg, body, D)."""
    return (lambda D: make(jcore, jbody(D), D),
            lambda D: make(tcore, (tbody or jbody)(D), D))


# ---------------------------------------------------------------------------
# elementwise, stencil, block products, index maps, lanes
# ---------------------------------------------------------------------------

def _saxpy(pkg, body, D):
    return pkg.Spec(
        "saxpy", grid=(D.n // D.bn,),
        inputs=[pkg.Tile("x", (D.n,), D.dtype, block=(D.bn,)),
                pkg.Tile("y", (D.n,), D.dtype, block=(D.bn,))],
        outputs=[pkg.Tile("out", (D.n,), D.dtype, block=(D.bn,))],
        body=body)


def _saxpy_body(D):
    def body(ctx, x, y, out):
        out[...] = D.alpha * x[...] + y[...]
    return body


@pytest.mark.parametrize("nblocks,bn", [(1, 8), (3, 4), (6, 16)])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_saxpy_matches_jax(nblocks, bn, dtype):
    n = nblocks * bn
    rng = np.random.RandomState(nblocks * bn)
    if dtype == "int32":
        x, y = (rng.randint(-100, 100, n).astype(np.int32) for _ in "xy")
        alpha = 3
    else:
        x, y = (rng.randn(n).astype(np.float32) for _ in "xy")
        alpha = -1.75
    ref = _agree(*_pair(_saxpy, _saxpy_body),
                 dict(n=n, bn=bn, alpha=alpha, dtype=dtype), [x, y])
    np.testing.assert_allclose(ref[0], alpha * x + y, rtol=1e-5, atol=1e-6)


def _stencil(pkg, body, D):
    return pkg.Spec(
        "stencil", grid=(D.n // D.bn,),
        inputs=[pkg.Tile("u", (D.n,), "float32")],
        outputs=[pkg.Tile("out", (D.n,), "float32", block=(D.bn,))],
        body=body)


def _stencil_jax(D):
    def body(ctx, u, out):
        bi = ctx.outer_id(0)
        full = ctx.cache(u)
        lap = -2.0 * full + jnp.roll(full, 1, 0) + jnp.roll(full, -1, 0)
        ctx.barrier()
        out[...] = jax.lax.dynamic_slice_in_dim(lap, bi * D.bn, D.bn, 0)
    return body


def _stencil_torch(D):
    def body(ctx, u, out):
        bi = ctx.outer_id(0)
        full = ctx.cache(u)
        lap = -2.0 * full + torch.roll(full, 1, 0) + torch.roll(full, -1, 0)
        ctx.barrier()
        out[...] = lap[bi * D.bn + ctx.lane_ids(D.bn)]
    return body


@pytest.mark.parametrize("nblocks,bn", [(1, 8), (5, 4), (4, 8)])
def test_stencil_whole_array_input_matches_jax(nblocks, bn):
    n = nblocks * bn
    u = np.random.RandomState(n).randn(n).astype(np.float32)
    ref = _agree(*_pair(_stencil, _stencil_jax, _stencil_torch),
                 dict(n=n, bn=bn), [u])
    np.testing.assert_allclose(ref[0], -2 * u + np.roll(u, 1) + np.roll(u, -1),
                               rtol=1e-5, atol=1e-5)


def _blockmm(pkg, body, D):
    return pkg.Spec(
        "blockmm", grid=(D.M // D.bm, D.N // D.bn),
        inputs=[pkg.Tile("a", (D.M, D.K), "float32", block=(D.bm, D.K),
                         index=lambda i, j: (i, 0)),
                pkg.Tile("b", (D.K, D.N), "float32", block=(D.K, D.bn),
                         index=lambda i, j: (0, j))],
        outputs=[pkg.Tile("c", (D.M, D.N), "float32", block=(D.bm, D.bn))],
        body=body)


def _blockmm_jax(D):
    def body(ctx, a, b, c):
        c[...] = jnp.dot(a[...], b[...], preferred_element_type=jnp.float32)
    return body


def _blockmm_torch(D):
    def body(ctx, a, b, c):
        c[...] = a[...] @ b[...]
    return body


@pytest.mark.parametrize("mi,ni,k,bm,bn", [(1, 1, 8, 8, 8), (3, 2, 24, 8, 16),
                                           (2, 3, 8, 16, 8)])
def test_block_matmul_matches_jax(mi, ni, k, bm, bn):
    M, N = mi * bm, ni * bn
    rng = np.random.RandomState(M + N + k)
    a = rng.randn(M, k).astype(np.float32)
    b = rng.randn(k, N).astype(np.float32)
    ref = _agree(*_pair(_blockmm, _blockmm_jax, _blockmm_torch),
                 dict(M=M, K=k, N=N, bm=bm, bn=bn), [a, b], mm=True)
    np.testing.assert_allclose(ref[0], a @ b, rtol=1e-3, atol=1e-3)


def _reduce(pkg, body, D):
    return pkg.Spec(
        "reduce", grid=(D.n // D.bn,),
        inputs=[pkg.Tile("x", (D.n,), "float32", block=(D.bn,))],
        outputs=[pkg.Tile("out", (D.n // D.bn,), "float32", block=(1,))],
        body=body)


def test_noncanonical_output_index_matches_jax():
    """A 1-D grid writing a (1,) block of a per-block-sum output."""
    x = np.random.RandomState(7).randn(64).astype(np.float32)
    jb = lambda D: lambda ctx, x, out: out.__setitem__(  # noqa: E731
        Ellipsis, jnp.sum(x[...], keepdims=True))
    tb = lambda D: lambda ctx, x, out: out.__setitem__(  # noqa: E731
        Ellipsis, x[...].sum(0, keepdim=True))
    ref = _agree(*_pair(_reduce, jb, tb), dict(n=64, bn=8), [x], mm=True)
    np.testing.assert_allclose(ref[0], x.reshape(-1, 8).sum(1), rtol=1e-5)


def _lanes(pkg, body, D):
    return pkg.Spec(
        "lanes", grid=(D.n // D.bn,),
        inputs=[pkg.Tile("x", (D.n,), "float32", block=(D.bn,))],
        outputs=[pkg.Tile("out", (D.n,), "float32", block=(D.bn,))],
        body=body)


def _lanes_jax(D):
    def body(ctx, x, out):
        gid = ctx.outer_id(0) * D.bn + ctx.lane_ids(D.bn)
        out[...] = x[...] + gid.astype(jnp.float32)
    return body


def _lanes_torch(D):
    def body(ctx, x, out):
        assert ctx.is_torch != ctx.is_loops       # the backend flags
        gid = ctx.outer_id(0) * D.bn + ctx.lane_ids(D.bn)
        out[...] = x[...] + gid.to(torch.float32)
    return body


def test_lane_ids_match_jax():
    x = np.random.RandomState(9).randn(32).astype(np.float32)
    ref = _agree(*_pair(_lanes, _lanes_jax, _lanes_torch), dict(n=32, bn=8),
                 [x])
    np.testing.assert_allclose(ref[0], x + np.arange(32), rtol=1e-6)


def _partial_body(D):
    def body(ctx, x, out):
        v = x[...]
        out[0:2] = v[0:2] * 2.0              # a slice of the block
        out[2] = v[3]                         # one element
        out[3:] = v[2:3] - 1.0               # broadcast into the rest
    return body


def test_partial_writes_into_a_block_match_jax():
    x = np.random.RandomState(4).randn(24).astype(np.float32)
    (got,) = _agree(*_pair(_lanes, _partial_body), dict(n=24, bn=6), [x])
    b = x.reshape(4, 6)
    want = np.concatenate([2 * b[:, :2], b[:, 3:4],
                           np.repeat(b[:, 2:3] - 1, 3, 1)], 1)
    np.testing.assert_allclose(got, want.reshape(-1), rtol=1e-6)


# ---------------------------------------------------------------------------
# reduce axes, scratch, accumulation into outputs
# ---------------------------------------------------------------------------

def _mm_t(pkg, body, D):
    """Reduce kernel whose blocks land in transposed order."""
    g = D.M // D.bm
    return pkg.Spec(
        "matmul_t", grid=(g, D.N // D.bn, D.K // D.bk), reduce_axes=(2,),
        scratch=[pkg.Scratch((D.bm, D.bn), "float32")],
        inputs=[pkg.Tile("a", (D.M, D.K), "float32", block=(D.bm, D.bk),
                         index=lambda i, j, kk: (j, kk)),
                pkg.Tile("b", (D.K, D.N), "float32", block=(D.bk, D.bn),
                         index=lambda i, j, kk: (kk, i))],
        outputs=[pkg.Tile("c", (D.M, D.N), "float32", block=(D.bm, D.bn),
                          index=lambda i, j, kk: (j, i))],
        body=body)


def _mm_scratch_body(xp):
    def make(D):
        def body(ctx, a, b, c):
            acc, = ctx.scratch

            @ctx.when(ctx.is_first)
            def _init():
                acc[...] = (jnp.zeros(acc.shape, acc.dtype) if xp is jnp else
                            torch.zeros(acc.shape, dtype=acc.dtype))

            acc[...] += (jnp.dot(a[...], b[...]) if xp is jnp else
                         a[...] @ b[...])

            @ctx.when(ctx.is_last)
            def _flush():
                c[...] = acc[...]
        return body
    return make


def test_transposed_reduce_kernel_with_scratch_matches_jax():
    rng = np.random.RandomState(3)
    a = rng.randn(32, 48).astype(np.float32)
    b = rng.randn(48, 32).astype(np.float32)
    ref = _agree(*_pair(_mm_t, _mm_scratch_body(jnp), _mm_scratch_body(torch)),
                 dict(M=32, K=48, N=32, bm=8, bk=16, bn=8), [a, b], mm=True)
    np.testing.assert_allclose(ref[0], a @ b, rtol=1e-4, atol=1e-4)


def _mm_noscr(pkg, body, D):
    return pkg.Spec(
        "matmul_noscr", grid=(D.M // D.bm, D.N // D.bn, D.K // D.bk),
        reduce_axes=(2,),
        inputs=[pkg.Tile("a", (D.M, D.K), "float32", block=(D.bm, D.bk),
                         index=lambda i, j, kk: (i, kk)),
                pkg.Tile("b", (D.K, D.N), "float32", block=(D.bk, D.bn),
                         index=lambda i, j, kk: (kk, j))],
        outputs=[pkg.Tile("c", (D.M, D.N), "float32", block=(D.bm, D.bn),
                          index=lambda i, j, kk: (i, j))],
        body=body)


def _noscr_body(xp):
    def make(D):
        def body(ctx, a, b, c):
            @ctx.when(ctx.is_first)
            def _init():
                c[...] = (jnp.zeros(c.shape, c.dtype) if xp is jnp else
                          torch.zeros(c.shape, dtype=c.dtype))

            c[...] += (jnp.dot(a[...], b[...]) if xp is jnp else
                       a[...] @ b[...])
        return body
    return make


def test_accumulation_into_the_output_block_matches_jax():
    rng = np.random.RandomState(5)
    a = rng.randn(16, 24).astype(np.float32)
    b = rng.randn(24, 16).astype(np.float32)
    ref = _agree(*_pair(_mm_noscr, _noscr_body(jnp), _noscr_body(torch)),
                 dict(M=16, K=24, N=16, bm=8, bk=8, bn=8), [a, b], mm=True)
    np.testing.assert_allclose(ref[0], a @ b, rtol=1e-4, atol=1e-4)


def _gsum(pkg, body, D):
    return pkg.Spec(
        "gsum", grid=(D.n // D.bn,), reduce_axes=(0,),
        scratch=[pkg.Scratch((1,), "float32")],
        inputs=[pkg.Tile("x", (D.n,), "float32", block=(D.bn,),
                         index=lambda r: (r,))],
        outputs=[pkg.Tile("out", (1,), "float32", block=(1,),
                          index=lambda r: (0,))],
        body=body)


def _weighted_sum_body(xp, weighted):
    def make(D):
        def body(ctx, x, out):
            acc, = ctx.scratch
            assert ctx.reduce_dim(0) == D.n // D.bn

            @ctx.when(ctx.is_first)
            def _init():
                acc[...] = (jnp.zeros(acc.shape, acc.dtype) if xp is jnp else
                            torch.zeros(acc.shape, dtype=acc.dtype))

            w = ctx.reduce_id(0) if weighted else 1
            if xp is jnp:
                acc[...] += jnp.asarray(w, jnp.float32) * jnp.sum(
                    x[...], keepdims=True)
            else:
                acc[...] += float(w) * x[...].sum(0, keepdim=True)

            @ctx.when(ctx.is_last)
            def _flush():
                out[...] = acc[...]
        return body
    return make


@pytest.mark.parametrize("weighted", [False, True], ids=["sum", "reduce_id"])
def test_grid_carried_reduction_into_one_block_matches_jax(weighted):
    x = np.random.RandomState(11).randn(96).astype(np.float32)
    ref = _agree(*_pair(_gsum, _weighted_sum_body(jnp, weighted),
                        _weighted_sum_body(torch, weighted)),
                 dict(n=96, bn=16), [x], mm=True)
    w = np.repeat(np.arange(6), 16) if weighted else 1
    np.testing.assert_allclose(ref[0], [(w * x).sum()], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# cell_when, stream=, Tile(reduce=) at two granularities, index_tile
# ---------------------------------------------------------------------------

def _guarded(pkg, body, D):
    return pkg.Spec(
        "guarded", grid=(4,),
        inputs=[pkg.Tile("x", (16,), "float32", block=(4,))],
        outputs=[pkg.Tile("y", (16,), "float32", block=(4,))],
        body=body)


def _guarded_body(D):
    def body(ctx, x, y):
        y[...] = x[...]                      # guaranteed init

        @ctx.cell_when(ctx.outer_id(0) % 2 == 0)
        def _even_cells():
            @ctx.when(x[0] > 0.0)
            def _positive_lead():
                y[...] = x[...] * 2.0
    return body


def test_cell_when_and_nested_when_match_jax():
    x = np.asarray([1, 2, 3, 4, -1, -2, -3, -4,
                    5, 6, 7, 8, -5, -6, -7, -8], np.float32)
    ref = _agree(*_pair(_guarded, _guarded_body), {}, [x])
    want = x.copy()
    want[0:4] *= 2
    want[8:12] *= 2
    np.testing.assert_array_equal(ref[0], want)


def _gran(pkg, body, D):
    no, n0, n1, bn = D.no, D.n0, D.n1, D.bn
    return pkg.Spec(
        "granularity", grid=(no, n0, n1), reduce_axes=(1, 2),
        scratch=[pkg.Scratch((1,), "float32")],
        inputs=[pkg.Tile("x", (no, n0, n1 * bn), "float32", block=(1, 1, bn),
                         index=lambda o, a, b: (o, a, b))],
        outputs=[
            pkg.Tile("tot", (no,), "float32", block=(1,),
                     index=lambda o, a, b: (o,)),
            pkg.Tile("per0", (no, n0), "float32", block=(1, 1),
                     index=lambda o, a, b: (o, a), reduce=(2,)),
            pkg.Tile("strm", (no, n0, n1), "float32", block=(1, 1, 1),
                     index=lambda o, a, b: (o, a, b), stream=True),
        ],
        body=body)


def _gran_body(xp):
    def make(D):
        def body(ctx, x, tot, per0, strm):
            acc, = ctx.scratch
            s = x[...].sum()

            @ctx.when(ctx.is_first)
            def _init_tot():
                acc[...] = 0.0

            @ctx.when(ctx.reduce_first(1))
            def _init_per0():
                per0[...] = 0.0

            acc[...] = acc[...] + s
            per0[...] = per0[...] + s
            strm[...] = (jnp.full((1, 1, 1), s) if xp is jnp else
                         s.reshape(1, 1, 1))

            @ctx.when(ctx.is_last)
            def _fin():
                tot[...] = acc[...]
        return body
    return make


def test_stream_and_per_output_reduce_granularity_match_jax():
    no, n0, n1, bn = 2, 3, 4, 5
    x = np.random.RandomState(0).randn(no, n0, n1 * bn).astype(np.float32)
    tot, per0, strm = _agree(*_pair(_gran, _gran_body(jnp), _gran_body(torch)),
                             dict(no=no, n0=n0, n1=n1, bn=bn), [x], mm=True)
    x4 = x.reshape(no, n0, n1, bn)
    np.testing.assert_allclose(tot, x.sum(axis=(1, 2)), rtol=1e-5)
    np.testing.assert_allclose(per0, x4.sum(axis=(2, 3)), rtol=1e-5)
    np.testing.assert_allclose(strm, x4.sum(axis=3), rtol=1e-5)


def _three(pkg, body, D):
    n, nv, nk, b = D.n, D.nv, D.nk, D.b
    return pkg.Spec(
        "three_gran", grid=(n, nv, nk), reduce_axes=(1, 2),
        scratch=[pkg.Scratch((b, 1), "float32")],
        inputs=[pkg.Tile("x", (n * b, nv * nk), "float32", block=(b, 1),
                         index=lambda i, v, k: (i, v * nk + k))],
        outputs=[
            pkg.Tile("blk_sum", (n * b, nv), "float32", block=(b, 1),
                     index=lambda i, v, k: (i, v), reduce=(2,)),
            pkg.Tile("total", (n * b, 1), "float32", block=(b, 1),
                     index=lambda i, v, k: (i, 0), reduce=(1, 2)),
        ],
        body=body)


def _three_body(xp):
    def make(D):
        def rowsum(v):
            return v.sum(-1, keepdims=True) if xp is jnp else \
                v.sum(-1, keepdim=True)

        def body(ctx, x, blk_sum, total):
            acc, = ctx.scratch

            @ctx.when(ctx.is_first)
            def _init_total():
                acc[...] = 0.0

            @ctx.when(ctx.reduce_first(1))
            def _init_blk():
                blk_sum[...] = 0.0

            blk_sum[...] = blk_sum[...] + rowsum(x[...])
            acc[...] += rowsum(x[...])

            @ctx.when(ctx.is_last)
            def _fin():
                total[...] = acc[...]
        return body
    return make


def test_two_reduce_granularities_in_one_grid_match_jax():
    n, nv, nk, b = 2, 3, 2, 4
    x = np.random.RandomState(7).randn(n * b, nv * nk).astype(np.float32)
    blk, total = _agree(*_pair(_three, _three_body(jnp), _three_body(torch)),
                        dict(n=n, nv=nv, nk=nk, b=b), [x], mm=True)
    np.testing.assert_allclose(blk, x.reshape(n * b, nv, nk).sum(-1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(total, x.sum(-1, keepdims=True), rtol=1e-5,
                               atol=1e-5)


def _paged(pkg, body, D):
    """out[s] = the sum over the pages of sequence s of pool[table[s, j]]:
    the pool's block index along axis 0 is read from the table at run time
    (the paged-attention walk), the page axis a reduce axis."""
    S, J, P, pg, d = D.S, D.J, D.P, D.pg, D.d
    return pkg.Spec(
        "paged_sum", grid=(S, J), reduce_axes=(1,),
        inputs=[pkg.Tile("table", (S, J), "int32", block=(1, 1),
                         index=lambda s, j: (s, j)),
                pkg.Tile("pool", (P * pg, d), "float32", block=(pg, d),
                         index=lambda s, j: (0, 0),
                         index_tile=("table", 0))],
        outputs=[pkg.Tile("out", (S * pg, d), "float32", block=(pg, d),
                          index=lambda s, j: (s, 0))],
        body=body)


def _paged_body(D):
    def body(ctx, table, pool, out):
        @ctx.when(ctx.is_first)
        def _init():
            out[...] = 0.0 * pool[...]

        out[...] = out[...] + pool[...]
    return body


def test_index_tile_gather_matches_jax():
    S, J, P, pg, d = 3, 4, 6, 2, 8
    rng = np.random.RandomState(2)
    table = rng.randint(0, P, (S, J)).astype(np.int32)
    table[1, 2] = P + 3                 # clamped to the last page
    table[2, 0] = -1                    # clamped to the first
    pool = rng.randn(P * pg, d).astype(np.float32)
    (got,) = _agree(*_pair(_paged, _paged_body),
                    dict(S=S, J=J, P=P, pg=pg, d=d), [table, pool])
    pages = pool.reshape(P, pg, d)[np.clip(table, 0, P - 1)]
    np.testing.assert_allclose(got, pages.sum(1).reshape(S * pg, d),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# halo tiles: periodic wrap and edge clamp at several radii
# ---------------------------------------------------------------------------

def _window(pkg, body, D):
    return pkg.Spec(
        "window_sum", grid=(D.h // D.bh, D.w // D.bw),
        inputs=[pkg.Tile("u", (D.h, D.w), "float32", block=(D.bh, D.bw),
                         halo=(D.r0, D.r1), wrap=D.wrap)],
        outputs=[pkg.Tile("out", (D.h, D.w), "float32", block=(D.bh, D.bw))],
        body=body)


def _window_body(D):
    r0, r1, bh, bw = D.r0, D.r1, D.bh, D.bw

    def body(ctx, u, out):
        win = u[...]                        # (bh + 2 r0, bw + 2 r1)
        acc = win[0:bh, 0:bw] * 0.0
        for di in range(2 * r0 + 1):
            for dj in range(2 * r1 + 1):
                acc = acc + win[di:di + bh, dj:dj + bw]
        out[...] = acc
    return body


HALO_CASES = [
    # (h, w, bh, bw, r0, r1)
    (12, 16, 4, 8, 1, 1),     # symmetric small halo
    (12, 16, 4, 8, 2, 3),     # asymmetric
    (12, 16, 12, 16, 2, 2),   # one block (the single-cell path) + halo
    (8, 8, 2, 4, 3, 1),       # r0 > bh: a window wider than the block
    (6, 10, 3, 5, 5, 9),      # r == extent - 1
    (9, 14, 3, 7, 1, 2),      # odd extents, non-power-of-two blocks
]


@pytest.mark.parametrize("wrap", [True, False], ids=["wrap", "clamp"])
@pytest.mark.parametrize("case", HALO_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_halo_windows_match_jax(case, wrap):
    h, w, bh, bw, r0, r1 = case
    u = np.random.default_rng(h * w + r0).standard_normal((h, w)).astype(
        np.float32)
    (got,) = _agree(*_pair(_window, _window_body),
                    dict(h=h, w=w, bh=bh, bw=bw, r0=r0, r1=r1, wrap=wrap),
                    [u])
    pad = np.pad(u, [(r0, r0), (r1, r1)], mode="wrap" if wrap else "edge")
    want = sum(pad[i:i + h, j:j + w] for i in range(2 * r0 + 1)
               for j in range(2 * r1 + 1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
