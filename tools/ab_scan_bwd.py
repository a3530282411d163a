"""Time the selective scan's backward at zamba2_7b's mamba2 train shape on
the card: one layer's scan forward and backward, four ways on the same f32
inputs and cotangent:

* ``wrapper``: ``ssm_scan`` as the models call it, the kernel's forward
  and ``_SSMScan.backward`` (autograd through ``selective_scan_ref``);
* ``ref``: autograd through ``selective_scan_ref`` (its Python time loop);
* ``assoc``: autograd through ``selective_scan_assoc`` (the odd/even
  recursion), what the ``ssm_scan`` op's OpVJP differentiates;
* ``adjoint``: the associative form with the scan's adjoint recurrence as
  its backward (a scan backwards in time, saving the decays and states
  only), a design kept here for comparison and used nowhere else.

Each is timed eagerly (CUDA events around 3 calls after a warm one) and
as a CUDA graph's replay (device ms, events around 5 replays), with the
peak allocated memory of a call. Prints the card and one line each.

  python3 tools/ab_scan_bwd.py [--shape 2,512,7168,64]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.kernels.ssm_scan import ops, ref  # noqa: E402


class _AdjointScan(torch.autograd.Function):
    """Every state of h_t = a_t h_{t-1} + b_t (h_0 = 0) by the recursion;
    its vector-Jacobian product is lambda_t = g_t + a_{t+1} lambda_{t+1},
    db_t = lambda_t, da_t = lambda_t h_{t-1}."""

    @staticmethod
    def forward(ctx, a, b):
        h = ref._scan_states(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        a_next = torch.zeros_like(a)
        a_next[:, :-1] = a[:, 1:]
        lam = ref._scan_states(a_next.flip(1), g.flip(1)).flip(1)
        da = torch.zeros_like(a)
        da[:, 1:] = lam[:, 1:] * h[:, :-1]
        return da, lam


def _adjoint(x, delta, A, B, C, D):
    dt = delta[..., None]
    hs = _AdjointScan.apply(torch.exp(dt * A), dt * B[:, :, None, :]
                            * x[..., None])
    return torch.einsum("bldn,bln->bld", hs, C) + D * x


def _events_ms(fn, n):
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(n):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def _time(name, fwd, inputs, gy):
    leaves = [t.detach().requires_grad_() for t in inputs]

    def step():
        return torch.autograd.grad(fwd(*leaves), leaves, gy)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager = _events_ms(step, 3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    replay = _events_ms(graph.replay, 5)
    del graph
    torch.cuda.empty_cache()
    print(f"[scan bwd] {name}: eager {eager:.3f} ms, graph replay "
          f"{replay:.3f} ms, peak {peak:.2f} GB allocated", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="2,512,7168,64")
    args = ap.parse_args(argv)
    bt, L, dm, n = (int(v) for v in args.shape.split(","))
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    inputs = (rnd(bt, L, dm), torch.nn.functional.softplus(rnd(bt, L, dm)
                                                           - 2.0),
              -(rnd(dm, n).abs() + 0.1), rnd(bt, L, n), rnd(bt, L, n),
              rnd(dm))
    gy = rnd(bt, L, dm)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _time("wrapper", ops.ssm_scan, inputs, gy)
    _time("ref", lambda *a: ref.selective_scan_ref(*a)[0], inputs, gy)
    _time("assoc", lambda *a: ref.selective_scan_assoc(*a)[0], inputs, gy)
    _time("adjoint", _adjoint, inputs, gy)


if __name__ == "__main__":
    main()
