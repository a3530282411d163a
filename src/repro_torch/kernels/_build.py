"""Build the CUDA C++ kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled on first
use into ``_build/lib<name>-<hash>.so`` beside the package (the directory is
git-ignored; a hash of the flags, the source and the shared headers
``common.cuh``, ``gemm_sm90.cuh``, ``attn_sm90.cuh``, ``attn_fwd_sm90.cuh``
and ``attn_bwd_sm90.cuh`` names the library,
so an edited source or header is rebuilt and a stale library never
loaded).
:func:`build_all` starts one ``nvcc`` per source, all at once, so a cold
start pays for the slowest file only. Nothing here runs at import time.
:func:`on_cpu` is the one rule every wrapper follows to choose between its
kernel and its plain version; :func:`tma_ok` is the layout rule of the
tensor-core routes (their operands are read by TMA).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["SOURCES", "build_all", "load", "check", "on_cpu", "tma_ok",
           "source_hash"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("rmsnorm", "flash_fwd", "paged_decode", "lm_head", "lm_head_ce",
           "flash_delta", "flash_bwd", "fd2d", "sem", "dg", "flash_decode",
           "ssm_scan", "ring_flash", "ring_flash_wide", "matmul")
HEADERS = ("common.cuh", "gemm_sm90.cuh",     # included by the sources
           "attn_sm90.cuh", "attn_fwd_sm90.cuh", "attn_bwd_sm90.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
BUILD_SECONDS: dict[str, float] = {}   # source -> nvcc wall s (build_all)
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels are built from source at first use")
    return path


def source_hash(*names: str) -> str:
    """The build hash of the sources ``names`` (``csrc/<name>.cu``): the
    nvcc flags, each source and the shared headers. It names each built
    library, and it keys the autotune cache (``core.tune``), so an edited
    source or header neither loads a stale library nor answers with a
    winner timed on the old one."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in (*(f"{n}.cu" for n in names), *HEADERS):
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{source_hash(name)}.so")


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (final path, temp path, Popen) or None when nothing needs building."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source that has no library yet, one nvcc each, all in
    parallel. Returns {name: nvcc output} for the sources it compiled
    (``-Xptxas -v``: registers, shared memory and spills per kernel), and
    records each source's wall seconds from the start in
    ``BUILD_SECONDS``. Raises with the compiler's output if any build
    fails."""
    t0 = time.perf_counter()
    jobs = {n: j for n in names if (j := _start(n)) is not None}
    logs, failed = {}, []

    def wait(name, proc):
        logs[name] = proc.communicate()[0]
        BUILD_SECONDS[name] = time.perf_counter() - t0

    waits = [threading.Thread(target=wait, args=(n, j[2]))
             for n, j in jobs.items()]
    for w in waits:
        w.start()
    for w in waits:
        w.join()
    for name, (out, tmp, proc) in jobs.items():
        text = logs[name]
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built if needed), with
    ``argtypes``/``restype`` set from ``signatures`` {fn: (argtypes, restype)}."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all((name,))
            lib = ctypes.CDLL(path)
            for fn, (argtypes, restype) in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def on_cpu(name: str, *tensors) -> bool:
    """True when every tensor lies on the CPU (the wrapper runs its plain
    version), False when all lie on one CUDA device (it launches its
    kernel). Any other placement raises: no wrapper falls back. ``None``
    (an optional input left out) is skipped."""
    devices = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}; "
                         "every tensor must be on one CUDA device (or all "
                         "on the CPU)")
    return False


def tma_ok(t) -> bool:
    """True when TMA can read the 2-D bf16 tensor ``t`` row by row: rows
    contiguous, the base address 16-byte aligned and the row stride a
    multiple of 8 elements (16 bytes) no shorter than a row."""
    import torch

    return (t.dtype == torch.bfloat16 and t.stride(1) == 1
            and t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0
            and t.stride(0) >= max(t.shape[1], 1))


def check(lib: ctypes.CDLL, code: int, what: str):
    """Raise if a C entry point returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> int:
    """The current CUDA stream's handle as an int (an entry point's
    ``ctypes.c_void_p`` argument takes it as it is), read without making a
    ``torch.cuda.Stream`` object: the wrappers of the decode step's small
    kernels pay for each microsecond on the host."""
    import torch

    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
