"""Nested dicts of tensors, the port's parameter trees.

JAX flattens a dict in sorted key order; :func:`leaves` and
:func:`unflatten` keep that order, so a sum over the leaves (the optimizer's
global norm) adds them as the JAX package does.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaves(tree: Any) -> list:
    """The leaves in sorted key order (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def unflatten(like: Any, values) -> Any:
    """A tree shaped as ``like`` whose leaves are ``values``, taken in
    :func:`leaves` order."""
    it = iter(values)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        return next(it)
    return fill(like)
