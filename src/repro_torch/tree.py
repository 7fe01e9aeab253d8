"""Pytree helpers for params as the reference lays them out: lists (and
tuples) of dicts of tensors.

Leaves are visited in ``jax.tree`` order — list items in order, dict keys
sorted — so flat payload lists (``core.compression``) line up leaf for leaf
with the reference's. Anything that is not a list, tuple or dict is a leaf
(tensors, and the plain ``int`` layer ids of whole-tensor leaves).
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_map", "tree_leaves", "tree_unflatten"]

PyTree = Any


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` leaf-wise over ``tree`` and congruent trees ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like: PyTree, leaves: list) -> PyTree:
    """Rebuild ``like``'s structure from ``leaves`` (in leaf order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
