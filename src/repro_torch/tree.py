"""Nested dicts, lists and tuples of tensors (the port's parameter trees):
their leaves in a fixed order (insertion order, or jax's: sorted keys,
``None`` an empty subtree), a map over one or more trees of one shape, and
the structure string ``str(jax.tree.structure(tree))`` that a checkpoint's
manifest records."""
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


def _sorted_children(tree):
    """The children of a node in jax's order (dict keys sorted, lists and
    tuples, NamedTuples among them, in order), or None for a leaf."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def sorted_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves``'s order: each dict's
    keys sorted, lists and tuples (NamedTuples too) in order, ``None`` an
    empty subtree. A sum over leaves taken in it adds its terms in the
    reference's order, and a checkpoint's ``a0..`` follow it."""
    if tree is None:
        return []
    children = _sorted_children(tree)
    if children is None:
        return [tree]
    return [x for c in children for x in sorted_leaves(c)]


def sorted_unflatten(tree, flat):
    """A tree of ``tree``'s structure (its dicts' insertion order, its
    list, tuple and NamedTuple types, its ``None``) holding the values
    ``flat`` in the order of :func:`sorted_leaves`."""
    flat = list(flat)
    it = iter(flat)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            got = {k: build(node[k]) for k in sorted(node)}
            return {k: got[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    n = len(sorted_leaves(tree))
    if len(flat) != n:
        raise ValueError(f"{len(flat)} values for a tree of {n} leaves")
    return build(tree)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def structure(tree) -> str:
    """``str(jax.tree.structure(tree))`` without jax: ``*`` a leaf,
    ``None``, ``{'k': ...}`` with sorted keys, ``[...]``, ``(...)`` (one
    element: ``(*,)``) and ``CustomNode(namedtuple[Name], [...])``."""
    def node(x) -> str:
        if x is None:
            return "None"
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {node(x[k])}"
                                   for k in sorted(x)) + "}"
        if _is_namedtuple(x):
            return (f"CustomNode(namedtuple[{type(x).__name__}], ["
                    + ", ".join(node(v) for v in x) + "])")
        if isinstance(x, list):
            return "[" + ", ".join(node(v) for v in x) + "]"
        if isinstance(x, tuple):
            inner = ", ".join(node(v) for v in x)
            return f"({inner},)" if len(x) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({node(tree)})"


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
