"""Leaves of nested dicts and tuples in the order ``jax.tree_util`` flattens
them: dict keys sorted, tuples (named ones too) in order, ``None`` empty.
The port's params and optimizer state are such trees, so a checkpoint
written by the reference lists its leaves in the same order."""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_leaves", "tree_unflatten", "tree_map"]


def tree_leaves(tree: Any) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """``like``'s structure with its leaves replaced, in order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(n) for n in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(n) for n in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(tree_leaves(tree), *others)])
