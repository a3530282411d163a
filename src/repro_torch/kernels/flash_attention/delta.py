"""The flash backward's delta precompute for Hopper in Triton.

Replaces: ``src/repro/kernels/flash_attention/kernel.py:180``
``flash_delta_builder`` (reached through ``pl.pallas_call`` at
``src/repro/core/lang.py:1076``).

``delta[b, h, s] = sum_d do[b, h, s, d] * o[b, h, s, d]`` in f32.

Bound on the H100: bytes. One product and one 64-wide row sum per element
pair: do and o are read once (2 x 16 MB in bf16 at B=4, H=32, S=1024,
D=64) and delta written once. Design: one program per (batch x head,
block of 64 rows) loads a (64, D) tile of each with the caller's strides
(do arrives as a transposed view of the output projection's gradient),
multiplies in f32 and reduces along D in registers; nothing else is staged.

Triton is imported only when the kernel is first built (``build``): the
module imports without it, as the CPU tests need.
"""

from __future__ import annotations

tl = None  # triton.language, bound by build() before the kernel is compiled
_JIT = None
BLOCK_S = 64


def _delta_kernel(do_ptr, o_ptr, delta_ptr, h, sq, d,
                  s_dob, s_doh, s_dos, s_ob, s_oh, s_os,
                  BLOCK_S: tl.constexpr, BLOCK_D: tl.constexpr):
    bh = tl.program_id(0)
    b = bh // h
    hh = bh % h
    rows = tl.program_id(1) * BLOCK_S + tl.arange(0, BLOCK_S)
    cols = tl.arange(0, BLOCK_D)
    mask = (rows[:, None] < sq) & (cols[None, :] < d)
    do = tl.load(do_ptr + b * s_dob + hh * s_doh + rows[:, None] * s_dos
                 + cols[None, :], mask=mask, other=0.0).to(tl.float32)
    o = tl.load(o_ptr + b * s_ob + hh * s_oh + rows[:, None] * s_os
                + cols[None, :], mask=mask, other=0.0).to(tl.float32)
    tl.store(delta_ptr + bh * sq + rows, tl.sum(do * o, axis=1),
             mask=rows < sq)


def build():
    """The jitted kernel (imports triton on first use)."""
    global tl, _JIT
    if _JIT is None:
        import triton
        import triton.language as language

        tl = language
        _JIT = triton.jit(_delta_kernel)
    return _JIT


def launch(do, o, delta):
    """do, o (B, H, Sq, D) with a contiguous last axis; delta (B, H, Sq)
    f32 contiguous; launches on the current stream."""
    import triton

    b, h, sq, d = do.shape
    grid = (b * h, triton.cdiv(sq, BLOCK_S))
    build()[grid](do, o, delta, h, sq, d, *do.stride()[:3], *o.stride()[:3],
                  BLOCK_S=BLOCK_S, BLOCK_D=triton.next_power_of_2(d),
                  num_warps=4)
