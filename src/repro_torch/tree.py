"""Parameter trees: nested dicts, lists and tuples of tensors.

Leaves are walked in the JAX package's order (dict keys sorted, sequences
in order) and addressed by ``jax.tree_util.keystr``-style paths such as
``[0]['stacks'][0]['attn']['wq']``, so sums over leaves run in the same
order as JAX's and checkpoints name their arrays as JAX's do.
"""

from __future__ import annotations

__all__ = ["leaves", "leaves_with_path", "tree_map", "unflatten"]


def leaves_with_path(tree, prefix=""):
    """Yields (path, leaf) in JAX's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of ``tree`` and ``rest`` (same
    structure), visited in :func:`leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(tree, new_leaves):
    """``tree``'s structure holding ``new_leaves`` (in :func:`leaves`
    order)."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out
