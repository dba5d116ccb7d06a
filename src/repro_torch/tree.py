"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Only dicts are containers; anything else (a tensor, a ``CompactState``, a
``LeafPlan``) is a leaf. Leaves are visited in sorted-key order, the
order ``jax.tree.leaves`` gives a dict.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {
            key: tree_map(fn, tree[key], *(r[key] for r in rest))
            for key in sorted(tree)
        }
    return fn(tree, *rest)


def tree_items(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(dotted path, leaf), ...]`` in sorted-key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key in sorted(tree):
        out += tree_items(tree[key], f"{prefix}.{key}" if prefix else key)
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_items(tree)]


def tree_unzip(tree: Any, n: int) -> Tuple[Dict, ...]:
    """Split a tree whose leaves are n-tuples into n trees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(n))


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """The tree shaped like ``like`` with ``leaves`` in its leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
