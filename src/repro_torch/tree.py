"""Nested dicts and lists of tensors, flattened as ``jax.tree`` flattens
them: dict values in sorted key order, list items in order.  Anything
else (a tensor, a tuple, a number) is a leaf."""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["leaves", "paths", "unflatten", "map_leaves"]


def leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for item in tree for x in leaves(item)]
    return [tree]


def paths(tree: Any, prefix: str = "") -> list[str]:
    """Each leaf's path in `leaves` order: dict keys and list indices
    joined by ``/`` (``layers/3/attn/wq``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, item in enumerate(tree) for x in paths(item, f"{prefix}{i}/")]
    return [prefix[:-1]]


def unflatten(like: Any, values: list) -> Any:
    """``like``'s structure with its leaves replaced by ``values``, in order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(item) for item in node]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more values than leaves")
    return out


def map_leaves(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` leaf by leaf over trees of one structure."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *others)])
