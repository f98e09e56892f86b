"""Logical axis names for every parameter, batch and cache leaf.

The port's copy of ``repro.distrib.axes``: the same table, the same
dispatch, the same names, so a leaf of the port's tree and the same leaf
of the reference's tree get the same names (the reference's stacked
layer axis aside: the port keeps a list of per-layer dicts, whose leaves
match the table's body without the leading axis). Names resolve to mesh
axes through the rule sets of ``distrib.sharding`` (TP over "model", DP
over ("pod", "data"), EP over "model", AoT's fused tables over both).

Dispatch is by the leaf's key path: Megatron-style column / row
parallelism for attention and the MLP, the expert axis for MoE, the LRU
width for RG-LRU. xLSTM's block parameters stay replicated, as in the
reference.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

N = None

# (context, leaf) -> logical names (without the leading stacked-layer axis)
_TABLE = {
    ("attn", "wq"): (N, "heads"),
    ("attn", "wk"): (N, "kv_heads"),
    ("attn", "wv"): (N, "kv_heads"),
    ("attn", "wo"): ("heads", N),
    ("attn", "bq"): ("heads",),
    ("attn", "bk"): ("kv_heads",),
    ("attn", "bv"): ("kv_heads",),
    ("mlp", "wg"): (N, "mlp"),
    ("mlp", "wu"): (N, "mlp"),
    ("mlp", "wd"): ("mlp", N),
    ("mlp", "w1"): (N, "mlp"),
    ("mlp", "w2"): ("mlp", N),
    ("mlp", "b1"): ("mlp",),
    ("moe", "router"): (N, "experts"),
    ("moe", "wg"): ("experts", N, "mlp"),
    ("moe", "wu"): ("experts", N, "mlp"),
    ("moe", "wd"): ("experts", "mlp", N),
    ("shared", "wg"): (N, "mlp"),
    ("shared", "wu"): (N, "mlp"),
    ("shared", "wd"): ("mlp", N),
    ("rglru", "in_x"): (N, "lru"),
    ("rglru", "in_gate"): (N, "lru"),
    ("rglru", "conv_w"): (N, "lru"),
    ("rglru", "conv_b"): ("lru",),
    ("rglru", "gate_r"): ("heads", N, N),
    ("rglru", "gate_i"): ("heads", N, N),
    ("rglru", "gate_rb"): ("lru",),
    ("rglru", "gate_ib"): ("lru",),
    ("rglru", "lam"): ("lru",),
    ("rglru", "out"): ("lru", N),
    ("lora", "qb"): (N, "heads"),
    ("lora", "vb"): (N, "kv_heads"),
    ("ptv2", "pk"): (N, "kv_heads", N),
    ("ptv2", "pv"): (N, "kv_heads", N),
}

_CONTEXTS = ("attn", "mlp", "moe", "shared", "rglru", "core", "aot",
             "lora", "ptv2", "adapters", "bitfit", "embed", "lm_head",
             "frontend", "ptv1", "head")
_STACKED = ("attn", "mlp", "moe", "shared", "rglru", "core", "lora", "ptv2",
            "aot", "adapters", "bitfit")


def logical_axes_for(path: Sequence[str], shape: Tuple[int, ...]
                     ) -> Tuple[Optional[str], ...]:
    """path: the leaf's key path as strings; shape: its shape. Returns one
    logical name (or None) per dim."""
    parts = list(path)
    leaf = parts[-1]
    ctx = None
    for p in reversed(parts[:-1]):
        if p in _CONTEXTS:
            ctx = p
            break

    # top-level tables
    if ctx == "embed" and leaf == "tok":
        return ("vocab", N)
    if ctx == "embed" and leaf == "pos":
        return (N, N)
    if ctx == "lm_head":
        return (N, "vocab")
    if ctx == "aot" and leaf == "table":
        if len(shape) == 4:          # (L, tasks, V, d)
            return (N, N, "table_vocab", "table_embed")
        return (N, "table_vocab", "table_embed")

    # per-layer parameters: a stacked leaf's leading axis is the layer's
    stacked = ctx in _STACKED or any(
        p.startswith("b") and p[1:].isdigit() for p in parts)
    body = _TABLE.get((ctx, leaf))
    if body is not None:
        if stacked and len(shape) == len(body) + 1:
            return (N,) + body
        if len(shape) == len(body):
            return body
    return tuple(N for _ in shape)


def batch_axes_for(name: str, shape: Tuple[int, ...]
                   ) -> Tuple[Optional[str], ...]:
    """A batch entry's names: the batch axis first for the model's inputs
    and labels, nothing sharded otherwise."""
    if name in ("tokens", "labels", "loss_mask", "aot_ids"):
        return ("batch",) + (N,) * (len(shape) - 1)
    if name in ("frames", "patches"):
        return ("batch",) + (N,) * (len(shape) - 1)
    if name == "task_ids":
        return ("batch",)
    return tuple(N for _ in shape)


def cache_axes_for(path: Sequence[str], shape: Tuple[int, ...]
                   ) -> Tuple[Optional[str], ...]:
    """Cache leaves (R, b, ...): the KV caches shard their sequence over
    "cache_seq"."""
    leaf = path[-1]
    if leaf in ("k", "v") and len(shape) == 5:
        return (N, "cache_batch", "cache_seq", "kv_heads", N)
    if leaf == "conv":
        return (N, "cache_batch") + (N,) * (len(shape) - 2)
    if leaf == "h" and len(shape) == 3:
        return (N, "cache_batch", "lru")
    # mLSTM / sLSTM states
    return (N, "cache_batch") + (N,) * (len(shape) - 2)


def per_layer(names_fn):
    """``names_fn`` for a per-layer leaf of the port's trees: the names of
    the reference's stacked leaf ``(R, ...)`` without the layer axis."""
    return lambda path, shape: names_fn(path, (1,) + tuple(shape))[1:]


def path_strings(keypath) -> Tuple[str, ...]:
    """A key path of the port's trees (the dict keys and list indices that
    ``repro_torch.tree`` walks, as :func:`leaves_with_paths` gives them)
    -> plain strings."""
    return tuple(str(k) for k in keypath)


def _children(tree):
    """(key, child) pairs of a node: dict keys, a NamedTuple's field names
    (jax's keys for them), list and tuple indices; None for a leaf."""
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return list(zip(type(tree)._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def leaves_with_paths(tree, prefix=()):
    """(key path, leaf) of every leaf of a tree of dicts, lists and tuples
    (NamedTuples among them), in the order of ``tree.leaves``."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [x for k, v in kids for x in leaves_with_paths(v, prefix + (k,))]


def map_with_path(fn, tree, prefix=()):
    """``fn(path_strings(path), leaf)`` for every leaf, in a tree of the
    same structure."""
    kids = _children(tree)
    if kids is None:
        return fn(path_strings(prefix), tree)
    out = [map_with_path(fn, v, prefix + (k,)) for k, v in kids]
    if isinstance(tree, dict):
        return dict(zip(tree, out))
    if hasattr(type(tree), "_fields"):
        return type(tree)(*out)
    return type(tree)(out)
