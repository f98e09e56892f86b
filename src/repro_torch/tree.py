"""Nested dicts and lists of tensors (the port's parameter trees): their
leaves in a fixed order (insertion order, or the reference's sorted keys),
and a map over one or more trees of one shape."""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in insertion order of its dicts, list order
    of its lists (the order :func:`map` and ``unflatten`` follow)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def sorted_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` with each dict's keys in sorted order, the
    order of ``jax.tree.leaves``: a sum over leaves taken in it adds its
    terms in the reference's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in sorted_leaves(v)]
    return [tree]


def map(fn: Callable, tree, *rest):       # noqa: A001 (jax.tree.map's name)
    """``fn`` applied leaf by leaf to ``tree`` and the trees ``rest`` of
    the same structure; the result has that structure."""
    if isinstance(tree, dict):
        return {k: map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(tree, flat):
    """A tree of ``tree``'s structure holding the values ``flat`` in the
    order of :func:`leaves`."""
    it = iter(flat)
    out = map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out
