"""Logical-axis sharding on a ``DeviceMesh``: the port's counterpart of
``repro.distrib.sharding``.

Model code names the axes of its intermediates with *logical* names
(``constrain(x, "batch", "seq", "embed")``). A rule set maps each logical
name to a mesh axis (or a tuple of mesh axes, outermost first). Outside a
:func:`use_rules` context, or on a plain tensor, the annotation is a
no-op, so the same model code runs on one device and on a mesh.

Where the reference resolves names to a ``PartitionSpec`` (one entry per
tensor dim), DTensor wants one ``Placement`` per *mesh* dim:
:func:`placements_for` turns the reference's resolution around. Its two
rules are the reference's: a mesh axis is used once per tensor (the first
dim to claim it wins), and a dim that the axis does not divide stays
replicated (8 KV heads on a 16-way axis). A name mapped to a tuple
``("pod", "data")`` shards one tensor dim over both mesh dims, outer
first. :func:`constrain` is a ``redistribute`` of a DTensor to the
placements its names resolve to.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

AxisVal = Union[None, str, Tuple[str, ...]]

_state = threading.local()


def _current():
    return getattr(_state, "mesh", None), getattr(_state, "rules", {})


@contextlib.contextmanager
def use_rules(mesh, rules: Dict[str, AxisVal]):
    """Install (mesh, logical -> mesh axis rules) for the enclosed code, in
    this thread. On a ``DeviceMesh`` a plain tensor that meets a DTensor
    inside is taken as replicated (DTensor's ``implicit_replication``),
    as GSPMD takes an unannotated constant: the masks, positions and
    RoPE tables the model builds from shapes, the same on every rank."""
    old = _current()
    _state.mesh, _state.rules = mesh, dict(rules)
    try:
        if isinstance(mesh, DeviceMesh):
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _state.mesh, _state.rules = old


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (its dims in order) or of a
    plain mapping, which stands in for a mesh where only sizes matter."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _flat(ax: AxisVal) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def _axis_size(sizes: Dict[str, int], ax: AxisVal) -> int:
    n = 1
    for a in _flat(ax):
        n *= sizes[a]
    return n


def resolve(names: Sequence[Optional[str]],
            shape: Optional[Sequence[int]] = None, mesh=None,
            rules: Optional[Dict[str, AxisVal]] = None
            ) -> Tuple[AxisVal, ...]:
    """The mesh axes of each tensor dim, as the reference's ``spec_for``
    lays them out (``()`` without a mesh)."""
    if mesh is None or rules is None:
        mesh, rules = _current()
    if mesh is None:
        return ()
    sizes = mesh_axes(mesh)
    used = set()
    out = []
    for i, name in enumerate(names):
        ax = rules.get(name) if name is not None else None
        if ax is not None:
            flat = _flat(ax)
            if any(a in used for a in flat):
                ax = None           # a mesh axis appears once per tensor
            elif shape is not None and shape[i] % _axis_size(sizes, ax):
                ax = None           # non-divisible: left replicated
            else:
                used.update(flat)
        out.append(ax)
    return tuple(out)


def placements_for(names: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None, mesh=None,
                   rules: Optional[Dict[str, AxisVal]] = None
                   ) -> Tuple[Placement, ...]:
    """One placement per mesh dim for a tensor whose dims carry the logical
    ``names``: ``Shard(d)`` on each mesh dim that tensor dim d maps to,
    ``Replicate()`` on the others and on a mesh dim of size 1, which holds
    the whole dim either way (``()`` without a mesh). ``mesh``: a
    ``DeviceMesh`` or a ``{axis: size}`` mapping; with neither ``mesh``
    nor ``rules`` the :func:`use_rules` context's."""
    if mesh is None or rules is None:
        mesh, rules = _current()
    if mesh is None:
        return ()
    sizes = mesh_axes(mesh)
    axes = list(sizes)
    out = [Replicate()] * len(axes)
    for dim, ax in enumerate(resolve(names, shape, mesh, rules)):
        at = [axes.index(a) for a in _flat(ax)]
        if at != sorted(at):
            raise ValueError(f"axes {ax} of dim {dim} must follow the "
                             f"mesh's order {axes}")
        for m in at:
            if sizes[axes[m]] > 1:
                out[m] = Shard(dim)
    return tuple(out)


def spec_of(placements: Sequence[Placement], mesh, ndim: int
            ) -> Tuple[AxisVal, ...]:
    """The per-tensor-dim layout of ``placements`` in :func:`resolve`'s
    form (a name, a tuple of names outer first, or None per dim)."""
    axes = list(mesh_axes(mesh))
    per = [[] for _ in range(ndim)]
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            per[p.dim].append(axes[m])
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in per)


def shard_range(placements: Sequence[Placement], mesh, dim: int,
                size: int) -> Tuple[int, int]:
    """(offset, length) of this rank's shard of tensor dim ``dim`` (of
    ``size``) under ``placements`` on the ``DeviceMesh`` ``mesh``: each
    mesh dim that shards it splits the range before it evenly, outer mesh
    dims first, as DTensor lays shards out. Raises where a split is not
    even."""
    coord = mesh.get_coordinate()
    off, n = 0, size
    for m, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            if n % mesh.size(m):
                raise ValueError(f"dim {dim} ({size}) does not split evenly "
                                 f"over mesh dim {m}")
            n //= mesh.size(m)
            off += coord[m] * n
    return off, n


def whole_on_rank(x) -> bool:
    """True when this rank holds all of DTensor ``x``: every mesh dim that
    shards it has size 1, and none holds a partial sum."""
    return all(p.is_replicate() or (p.is_shard() and
                                    x.device_mesh.size(m) == 1)
               for m, p in enumerate(x.placements))


def as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor (the same on every
    rank) becomes a replicated one."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def from_local(local, mesh, placements, shape):
    """A DTensor of global ``shape`` (contiguous strides) from this rank's
    ``local`` shard under ``placements``."""
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def data_group_count() -> int:
    """The size of the mesh axes the "batch" name maps to (1 without
    one): grouped-dispatch MoE routes tokens within each data group."""
    mesh, rules = _current()
    if mesh is None:
        return 1
    ax = rules.get("batch")
    if ax is None:
        return 1
    return _axis_size(mesh_axes(mesh), ax)


def constrain(x, *names: Optional[str]):
    """``x`` redistributed to the placements its logical ``names`` resolve
    to under the active rules; ``x`` itself outside :func:`use_rules`, on
    a plain tensor, or when it already lies so."""
    mesh, rules = _current()
    if mesh is None or not isinstance(x, DTensor):
        return x
    assert x.ndim == len(names), (tuple(x.shape), names)
    want = placements_for(names, x.shape, x.device_mesh, rules)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


# ---------------------------------------------------------------------------
# the standard rule sets (the reference's, value for value)
# ---------------------------------------------------------------------------

def tp_dp_rules(*, pod_axis: bool = False, sequence_parallel: bool = False,
                shard_vocab_tables: bool = True) -> Dict[str, AxisVal]:
    """The production rule set: DP over (pod,) data, TP and EP over model.
    ``sequence_parallel`` also shards the sequence axis of activations
    over the model axis."""
    data: AxisVal = ("pod", "data") if pod_axis else "data"
    return {
        "batch": data,
        "seq": "model" if sequence_parallel else None,
        "kv_seq": None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_capacity": None,
        "lru": "model",
        "layers": None,
        "prompt": None,
        "classes": None,
        # AoT's fused tables: vocab rows over data, embed over model
        "table_vocab": data,
        "table_embed": "model",
        # the decode cache: batch over data, KV heads over model
        "cache_batch": data,
        "cache_seq": None,
        "rank": None,
    }


def long_context_rules(**kw) -> Dict[str, AxisVal]:
    """Batch-1 decode: the KV cache's sequence over the data axis."""
    rules = tp_dp_rules(**kw)
    rules["cache_batch"] = None
    rules["cache_seq"] = "data" if not kw.get("pod_axis") else ("pod",
                                                                "data")
    return rules


def decode_rules(*, kv_heads: int, pod_axis: bool = False
                 ) -> Dict[str, AxisVal]:
    """Batched decode. When ``kv_heads`` does not divide the production
    model axis (16), the cache's sequence takes the model axis and the KV
    heads stay replicated."""
    rules = tp_dp_rules(pod_axis=pod_axis)
    model = 16
    if kv_heads % model:
        rules["kv_heads"] = None
        rules["cache_seq"] = "model"
    return rules
