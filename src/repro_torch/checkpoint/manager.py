"""Checkpoints of tensor trees: atomic save, async keep-k manager, resume
and reshard-on-restore (the counterpart of ``repro.checkpoint.manager``).

The on-disk layout is the JAX package's: ``<dir>/step_<N>/arrays.npz`` keyed
by ``jax.tree_util.keystr`` leaf paths (``[0]['stacks'][0]['attn']['wq']``)
plus ``meta.json``, written to a temporary directory and renamed, so a crash
mid-save never corrupts the latest checkpoint and an f32 checkpoint crosses
between the two packages in both directions. numpy has no bfloat16, so a
bf16 leaf is stored as its 16-bit pattern and ``meta.json`` records each
leaf's dtype under ``"dtypes"`` (the JAX package ignores the extra key).

On a mesh the arrays on disk are always the full ones: ``save(shardings=)``
gathers every leaf from the ranks' shards before the writer thread gets
it (every rank takes part; the first rank writes), and
``restore(shardings=)`` reads the full arrays and slices each leaf to the
placement of the mesh it restores onto, which may differ from the one that
saved (reshard-on-restore).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten

__all__ = ["save_tree", "restore_tree", "load_meta", "CheckpointManager"]


def _to_numpy(leaf):
    """(array, dtype name) of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.asarray(leaf)
    return a, a.dtype.name


def _from_numpy(arr, dtype):
    arr = arr if arr.flags.c_contiguous else arr.copy()   # keeps 0-d shapes
    if dtype == "bfloat16" or arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_tree(tree, directory: str, *, meta: dict | None = None):
    """Atomic synchronous save."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    arrays, dtypes = {}, {}
    for key, leaf in leaves_with_path(tree):
        arrays[key], dtypes[key] = _to_numpy(leaf)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"meta": meta or {}, "keys": sorted(arrays),
                   "dtypes": dtypes, "time": time.time()}, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def restore_tree(template, directory: str, *, device=None, shardings=None):
    """Restore into the structure, shapes and dtypes of ``template`` (a tree
    of tensors, meta tensors included, at their full shapes), placing each
    leaf on ``device`` (default: the template leaf's own device).
    ``shardings``: a matching tree of ``parallel.Placement`` (or None
    leaves): each leaf sliced to this rank's shard of it."""
    with np.load(os.path.join(directory, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    with open(os.path.join(directory, "meta.json")) as f:
        dtypes = json.load(f).get("dtypes", {})
    out = []
    for key, leaf in leaves_with_path(template):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs template {tuple(leaf.shape)}")
        t = _from_numpy(arr, dtypes.get(key))
        out.append(t.to(device=leaf.device if device is None else device,
                        dtype=leaf.dtype))
    if shardings is not None:
        out = [t if p is None else p.local(t)
               for t, p in zip(out, leaves(shardings), strict=True)]
    return unflatten(template, out)


def load_meta(directory: str) -> dict:
    with open(os.path.join(directory, "meta.json")) as f:
        return json.load(f)["meta"]


class CheckpointManager:
    """Async keep-k checkpointing with atomic rename."""

    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, *, meta: dict | None = None,
             async_: bool = True, shardings=None, write: bool = True):
        """Save ``tree`` as step ``step``. ``shardings``: a matching tree of
        ``parallel.Placement``: the leaves are shards, gathered into the
        full arrays first (every rank calls ``save``); ``write=False``
        (the ranks but one) takes part in the gather and writes nothing."""
        self.wait()
        if shardings is not None:
            tree = tree_map(lambda t, p: p.gather(t.detach()), tree,
                            shardings)
        if not write:
            return
        # snapshot to host BEFORE going async: the caller updates the
        # device tensors in place on the next step
        host_tree = tree_map(lambda t: t.detach().to("cpu", copy=True)
                             if isinstance(t, torch.Tensor) else t, tree)

        def _do():
            try:
                save_tree(host_tree, self._step_dir(step),
                          meta=dict(meta or {}, step=step))
                self._gc()
            except Exception as e:      # raised to the caller by wait()
                self._error = e

        if async_:
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()
        else:
            _do()
            self.wait()

    def restore(self, template, *, step: int | None = None, device=None,
                shardings=None):
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        tree = restore_tree(template, self._step_dir(step), device=device,
                            shardings=shardings)
        return step, tree, load_meta(self._step_dir(step))

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
