"""Leaf order of nested parameter and optimizer trees, as ``jax.tree``
flattens them: a dict's values in sorted key order, a tuple's (and a
NamedTuple's) in field order, None holding no leaf, anything else one
leaf. The optimizer walks params, grads and moments in this order, and
checkpoints store their leaves in it, so the two packages read each
other's checkpoints."""
from __future__ import annotations

from typing import Any, List


def leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [] if tree is None else [tree]


def map(fn, tree):
    """A tree of ``tree``'s structure holding ``fn`` of each leaf."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])


def unflatten(like, flat: List[Any]):
    """A tree of ``like``'s structure whose leaves are ``flat``, in
    :func:`leaves` order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return None if t is None else next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
