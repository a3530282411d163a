"""RMSNorm for Hopper in Triton.

Replaces: ``src/repro/kernels/rmsnorm/kernel.py:21`` ``rmsnorm_builder``
(reached through ``pl.pallas_call`` at ``src/repro/core/lang.py:1076``).

``o = x * rsqrt(mean(x^2) + eps) * w`` over the last axis, math in f32,
output in x's dtype (w stays f32 while x is bf16).

Bound on the H100: bytes. Each element is read once and written once with
~4 FLOPs between, far below the ~295 FLOP/byte where the tensor cores, not
HBM, would be the limit; at decode (8 rows of 2048) the launch itself is
the cost. Design: one program per row holds the whole row in registers
(BLOCK_D = next power of two >= d), so x is read from HBM once, reduced in
registers and scaled in the same pass; w (8 KB) stays in L2 across rows.

Triton is imported only when the kernel is first built (``build``): the
module imports without it, as the CPU tests need.
"""

from __future__ import annotations

tl = None  # triton.language, bound by build() before the kernel is compiled
_JIT = None


def _rmsnorm_kernel(x_ptr, w_ptr, o_ptr, d, stride_x, stride_o, eps,
                    BLOCK_D: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK_D)
    mask = cols < d
    x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / d
    w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    y = x * tl.rsqrt(var + eps) * w
    tl.store(o_ptr + row * stride_o + cols,
             y.to(o_ptr.dtype.element_ty), mask=mask)


def build():
    """The jitted kernel (imports triton on first use)."""
    global tl, _JIT
    if _JIT is None:
        import triton
        import triton.language as language

        tl = language
        _JIT = triton.jit(_rmsnorm_kernel)
    return _JIT


def launch(x2, w, out, eps: float):
    """x2 (rows, d) and out (rows, d) with a contiguous last axis, w (d,)
    contiguous; launches on the current stream."""
    import triton

    rows, d = x2.shape
    block_d = triton.next_power_of_2(d)
    num_warps = 4 if block_d <= 1024 else 8
    build()[(rows,)](x2, w, out, d, x2.stride(0), out.stride(0), float(eps),
                     BLOCK_D=block_d, num_warps=num_warps)
