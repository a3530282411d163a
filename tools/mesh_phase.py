#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 22 (the mesh: two ranks on the card over
gloo) or phase 23 (every program kind on the mesh, and the pipeline)
alone, after building the kernels.

    python3 tools/mesh_phase.py        # phase 22
    python3 tools/mesh_phase.py 23     # phase 23

Builds every kernel (one ``nvcc`` each, all at once), then runs
``chip_smoke.mesh_phase`` (or ``chip_smoke.tp_phase``) and prints its
``[time]`` rows. Its
timings run cold where the whole smoke's do not: the first ``cuBLAS`` and
profiler use of the process land in the phase. As ``chip_smoke.main`` it
keeps the bytecode it compiles under a temporary ``PYTHONPYCACHEPREFIX``,
where the spawned ranks read it. Needs one card.
"""

import os
import shutil
import sys
import tempfile
import time


def main():
    pyc = tempfile.mkdtemp(prefix="mesh_phase_pyc_")
    sys.pycache_prefix = pyc
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = pyc
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, os.path.join(root, "src")]
    try:
        import torch

        import chip_smoke
        from repro_torch.kernels import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        _build.build_all()
        print(f"[build] {time.perf_counter() - t0:.1f}s", flush=True)
        phase = sys.argv[1] if len(sys.argv) > 1 else "22"
        run = {"22": chip_smoke.mesh_phase, "23": chip_smoke.tp_phase}[phase]
        t0 = time.perf_counter()
        times = run(torch.device("cuda"))
        print(f"[phase {phase}] {time.perf_counter() - t0:.1f}s", flush=True)
        for name, t in times.items():
            lib = ("null" if t["library_ms"] is None
                   else f"{t['library_ms']:.4f} ms")
            print(f"[time] {name} {t['shape']}: kernel {t['ms']:.4f} ms, "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
                  f"{t['plain_ms']:.4f} ms, library {lib}", flush=True)
    finally:
        shutil.rmtree(pyc, ignore_errors=True)


if __name__ == "__main__":
    main()
