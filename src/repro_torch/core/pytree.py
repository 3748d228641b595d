"""Parameter pytrees: nested dicts whose leaves are tensors.

The reference keeps BL-DNN's parameters, gradients, shifts and data as JAX
pytrees of dicts.  Here they are plain nested dicts, flattened in the
reference's leaf order: `jax.tree_util` visits a dict's keys sorted, so
``{"in", "mlp": {"wi", "wo"}, "out"}`` flattens to ``in, mlp.wi, mlp.wo,
out``.  Per-leaf compressors and basis factors follow that order.
"""
from __future__ import annotations

from typing import Callable, List


def tree_leaves(tree) -> List:
    """The leaves of `tree` in the reference's order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_unflatten(like, leaves) -> object:
    """A tree shaped like `like` holding `leaves` (in `tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        for other in rest:
            if not isinstance(other, dict) or sorted(other) != sorted(tree):
                raise ValueError(f"tree structures differ: keys {sorted(tree)}")
        return {key: tree_map(fn, tree[key], *(o[key] for o in rest))
                for key in sorted(tree)}
    return fn(tree, *rest)
