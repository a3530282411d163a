"""Per-parameter partition specs with divisibility checks (counterpart of
``repro.parallel.rules``).

Tensor-parallel layout over the "model" axis (Megatron conventions), DP
over ("pod", "data"). Stacked layer params (leading stack axes) get
None-prefixed specs. Any dim that does not divide its mesh axis falls back
to replication. MoE experts shard over "model" when divisible, else the
expert FFN dims shard.

A spec is a tuple with one entry per dim: None (replicated), an axis name,
or a tuple of axis names; it compares equal to the entries of the JAX
package's ``PartitionSpec``. The functions work on shapes alone: the trees
they read may hold meta tensors (a whole config's parameters without their
memory), and a mesh is anything :func:`mesh_shape` reads: a
``torch.distributed`` ``DeviceMesh`` with ``mesh_dim_names``, or an object
whose ``shape`` maps axis names to sizes and whose ``axis_names`` lists
them (what JAX's rule functions read of a mesh).
"""

from __future__ import annotations

import math

__all__ = ["param_specs", "leaf_spec", "batch_specs", "zero1_specs",
           "spec_bytes_per_device", "ring_axis_for", "mesh_shape", "spec",
           "spec_map", "spec_leaves"]


def spec(*entries) -> tuple:
    """A spec of ``entries``, normalised as ``PartitionSpec`` normalises
    them: a one-name tuple is the name, an empty tuple None."""
    def norm(e):
        if isinstance(e, tuple):
            return None if not e else (e[0] if len(e) == 1 else e)
        return e
    return tuple(norm(e) for e in entries)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of ``mesh`` (a ``DeviceMesh`` or an object with a
    ``shape`` dict)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def ring_axis_for(mesh, seq_len, *, model_axis="model"):
    """The mesh axis a sequence of ``seq_len`` can ring over, or None.

    Ring attention needs the model axis present, more than one shard, and an
    evenly divisible sequence (every shard runs the same kernel grid)."""
    if mesh is None:
        return None
    n = int(mesh_shape(mesh).get(model_axis, 1))
    if n > 1 and seq_len % n == 0:
        return model_axis
    return None


# rule table: leaf name -> spec template for its BASE (unstacked) dims.
# "m" = model axis, None = replicated. Checked for divisibility at apply time.
_RULES_2D = {
    "embed": ("m", None),
    "head": (None, "m"),
    "wq": (None, "m"), "wk": (None, "m"), "wv": (None, "m"), "wo": ("m", None),
    "wkv_a": (None, None), "wkv_b": (None, "m"),
    "w_gate": (None, "m"), "w_up": (None, "m"), "w_down": ("m", None),
    "in_proj": (None, "m"), "out_proj": ("m", None),
    "in_x": (None, "m"), "in_z": (None, "m"),
    "in_xbc": (None, "m"), "in_dt": (None, "m"),
    "x_proj": ("m", None), "dt_w": (None, "m"),
    "conv_w": (None, "m"),
    "A_log": ("m", None),          # mamba1 (di, N)
    "router": (None, None),
}
_RULES_1D = {
    "conv_b": ("m",), "dt_bias": ("m",), "D": ("m",), "norm_w": ("m",),
    "A_log": ("m",),               # mamba2 (H,)
    "kv_norm": (None,),
    "norm": (None,), "norm1": (None,), "norm2": (None,), "final_norm": (None,),
    "embed": (None,),
}
# MoE expert stacks (E, d, f) / (E, f, d): EP over experts when divisible,
# else TP over the ffn dim.
_EXPERT_3D = {
    "w_gate": (("m", None, None), (None, None, "m")),
    "w_up": (("m", None, None), (None, None, "m")),
    "w_down": (("m", None, None), (None, "m", None)),
}


def _walk(tree, names=()):
    """(names, leaf) in JAX's flattening order: dict keys sorted, sequence
    entries as "[i]"."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], names + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, names + (f"[{i}]",))
    else:
        yield names, tree


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def spec_map(fn, tree):
    """``tree``'s structure holding ``fn(names, leaf)`` at each leaf."""
    return _rebuild(tree, iter([fn(n, leaf) for n, leaf in _walk(tree)]))


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def spec_leaves(specs) -> list:
    """The specs of a spec tree, in leaf order (a spec is a tuple leaf)."""
    out = []

    def walk(t):
        if _is_spec(t):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            for v in t:
                walk(v)
    walk(specs)
    return out


def _apply_divisibility(template, shape, msize, model_axis):
    return tuple(model_axis if t == "m" and dim % msize == 0 else None
                 for dim, t in zip(shape, template))


def leaf_spec(name, base, msize, model_axis="model"):
    """The spec of one layer's (unstacked) leaf ``name`` of shape ``base``
    on a "model" axis of ``msize`` ranks: the rule tables with the
    divisibility fallback (what :func:`param_specs` gives each leaf after
    its stack dims)."""
    base = tuple(base)
    if name in _EXPERT_3D and len(base) == 3:
        ep, tp = _EXPERT_3D[name]
        template = ep if base[0] % msize == 0 else tp
        return _apply_divisibility(template, base, msize, model_axis)
    if len(base) == 1 and name in _RULES_1D:
        return _apply_divisibility(_RULES_1D[name], base, msize, model_axis)
    if len(base) == 2 and name in _RULES_2D:
        return _apply_divisibility(_RULES_2D[name], base, msize, model_axis)
    return (None,) * len(base)


def param_specs(params, cfg, mesh, *, model_axis="model"):
    """A tree of specs matching ``params`` (tensors or meta tensors)."""
    del cfg                        # the rules read leaf names and shapes
    msize = mesh_shape(mesh)[model_axis]

    def assign(names, leaf):
        name = names[-1]
        shape = tuple(leaf.shape)
        # base (unstacked) rank: stacked layer params carry 1 (stack) or 2
        # (zamba group) extra leading dims
        extra = 0
        if "stacks" in names:
            for extra_try in (1, 2):
                base = shape[extra_try:]
                if ((name in _RULES_1D and len(base) == 1)
                        or (name in _RULES_2D and len(base) == 2)
                        or (name in _EXPERT_3D and len(base) == 3)):
                    extra = extra_try
                    break
            else:
                extra = 1
        return (None,) * extra + leaf_spec(name, shape[extra:], msize,
                                           model_axis)

    return spec_map(assign, params)


def batch_specs(batch_shapes, *, batch_axes=("pod", "data")):
    """Shard every input's leading dim over the DP axes."""
    return spec_map(lambda _, leaf: spec(batch_axes, *(None,) * (
        len(leaf.shape) - 1)), batch_shapes)


def zero1_specs(pspecs, params, mesh, *, data_axis="data"):
    """Optimizer-moment specs: the param spec with the largest replicated
    dim sharded over the data axis when it divides and holds >= 1024
    (ZeRO-1)."""
    dsize = mesh_shape(mesh)[data_axis]
    specs = iter(spec_leaves(pspecs))

    def assign(_, leaf):
        sp = next(specs)
        entries = list(sp) + [None] * (len(leaf.shape) - len(sp))
        best, best_dim = -1, -1
        for i, (e, s) in enumerate(zip(entries, leaf.shape)):
            if e is None and s % dsize == 0 and s > best:
                best, best_dim = s, i
        if best_dim >= 0 and best >= 1024:
            entries[best_dim] = data_axis
        return spec(*entries)

    return spec_map(assign, params)


def spec_bytes_per_device(shapes, specs, mesh) -> int:
    """Bytes a device holds under the specs (the analytic memory check)."""
    sizes = mesh_shape(mesh)
    total = 0
    for (_, leaf), spec in zip(_walk(shapes), spec_leaves(specs)):
        n = 1
        for i, d in enumerate(leaf.shape):
            ax = spec[i] if i < len(spec) else None
            if ax is None:
                n *= d
            else:
                axes = ax if isinstance(ax, tuple) else (ax,)
                n *= -(-d // math.prod(sizes[a] for a in axes))
        total += n * leaf.dtype.itemsize
    return total
