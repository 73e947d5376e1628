"""Pytrees of tensors in JAX's leaf order.

`jax.tree_util` flattens dict keys in sorted order, while
`torch.utils._pytree` keeps insertion order.  Per-leaf mask draws, per-leaf
rates and Eq.-(8) sizes are all indexed by the JAX order, so the port
flattens its nested dicts / lists / tuples here and nowhere else: dict keys
sorted, lists and tuples (named tuples included) by index, anything else a
leaf.  The recursion is module-level, not a self-referencing closure: a
closure cycle would keep every flattened leaf alive until Python's cyclic
collector ran, which at full width is gigabytes of device memory.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_map"]


def _children(node) -> Tuple[Optional[tuple], Optional[list]]:
    """(kind, children) of an inner node, or (None, None) for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", keys), [node[k] for k in keys]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return ("namedtuple", type(node)), list(node)
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, None), list(node)
    return None, None


def _walk(node, leaves: List[Any]):
    kind, kids = _children(node)
    if kind is None:
        leaves.append(node)
        return None
    return (kind, [_walk(c, leaves) for c in kids])


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """Leaves in JAX order, plus a treedef for `tree_unflatten`."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def _build(d, it):
    if d is None:
        return next(it)
    (kind, meta), kids = d
    vals = [_build(k, it) for k in kids]
    if kind == "dict":
        return dict(zip(meta, vals))
    if kind == "namedtuple":
        return meta(*vals)
    return list(vals) if kind == "list" else tuple(vals)


def tree_unflatten(treedef, leaves) -> Any:
    return _build(treedef, iter(leaves))


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(
        treedef, [fn(x, *(o[i] for o in others)) for i, x in enumerate(leaves)]
    )
