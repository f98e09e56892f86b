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
first, or over the one dim "pod_data" of a mesh that lays them out as
one (:func:`mesh_dims`). :func:`constrain` is a ``redistribute`` of a
DTensor to the placements its names resolve to.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)
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


def _dims(sizes: Dict[str, int], ax: AxisVal) -> Tuple[str, ...]:
    """The mesh dims a rule's axis value names: its own names, or, for a
    tuple whose dims the mesh holds flattened into one
    (``launch.mesh.pod_mesh``: ("pod", "data") as "pod_data"), that one
    dim."""
    flat = _flat(ax)
    joined = "_".join(flat)
    if len(flat) > 1 and flat[0] not in sizes and joined in sizes:
        return (joined,)
    return flat


def mesh_dims(mesh, ax: AxisVal) -> Tuple[str, ...]:
    """:func:`_dims` of ``mesh``'s axes."""
    return _dims(mesh_axes(mesh), ax)


def _axis_size(sizes: Dict[str, int], ax: AxisVal) -> int:
    n = 1
    for a in _dims(sizes, ax):
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
            flat = _dims(sizes, ax)
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
        at = [axes.index(a) for a in _dims(sizes, ax)]
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


def local_shape(shape, placements, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a tensor of global ``shape`` under
    ``placements`` on ``mesh`` (every split even, as :func:`placements_for`
    keeps them)."""
    out = list(shape)
    for m, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(m)
            if out[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split evenly over mesh dim {m}")
            out[p.dim] //= n
    return tuple(out)


def full_on_mesh(shape, fill, dtype, device, names, mesh, rules):
    """A DTensor of global ``shape`` holding ``fill``, laid out by its
    logical ``names``: each rank allocates its own shard only."""
    pl = placements_for(names, shape, mesh, rules)
    local = torch.full(local_shape(shape, pl, mesh), fill, dtype=dtype,
                       device=device)
    return from_local(local, mesh, pl, tuple(shape))


def reshape_tail(x, lead: int, *tail: int):
    """``x`` reshaped to ``x.shape[:lead] + tail`` (heads split into kv
    groups, or merged back). On a DTensor, dim ``lead`` may stay sharded
    when the new first dim of the tail splits as evenly over the same
    mesh dims, and the other tail dims are whole; otherwise the tail is
    first made whole (15 heads on a 16-way axis, as GSPMD reshards them)
    and the reshape runs on the local tensors, so that its backward never
    has to split a sharded dim unevenly."""
    new = tuple(x.shape[:lead]) + tuple(tail)
    if not isinstance(x, DTensor):
        return x.reshape(new)
    mesh = x.device_mesh
    k = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(lead):
            k *= mesh.size(i)
    rest = any(p.is_shard() and p.dim > lead for p in x.placements)
    if k > 1 and not rest and tail[0] % k == 0:
        return x.reshape(new)
    pl = [Replicate() if p.is_shard() and p.dim >= lead else p
          for p in x.placements]
    if pl != list(x.placements):
        x = x.redistribute(mesh, pl)
    loc = x.to_local()
    return from_local(loc.reshape(tuple(loc.shape[:lead]) + tuple(tail)),
                      mesh, pl, new)


def split_last(x, n: int, m: int):
    """``x`` (..., n m) reshaped to (..., n, m) (:func:`reshape_tail`)."""
    return reshape_tail(x, x.ndim - 1, n, m)


def write_rows(dst, dim: int, lo: int, src) -> None:
    """``dst[.., lo:lo + n, ..] = src`` along ``dim`` (n = src's size
    there), in place. On a DTensor ``dst`` each rank writes the part of
    those rows its shard holds, from ``src`` laid out as ``dst`` but
    whole along ``dim``: no rank gathers ``dst``."""
    n = src.shape[dim]
    if not isinstance(dst, DTensor):
        dst.narrow(dim, lo, n).copy_(src)
        return
    mesh = dst.device_mesh
    pl = [Replicate() if p.is_shard(dim) else p for p in dst.placements]
    src_l = as_dtensor(src, mesh).redistribute(mesh, pl).to_local()
    off, size = shard_range(dst.placements, mesh, dim, dst.shape[dim])
    a, b = max(lo, off), min(lo + n, off + size)
    if a < b:
        dst.to_local().narrow(dim, a - off, b - a).copy_(
            src_l.narrow(dim, a - lo, b - a))


def pointwise(fn, x):
    """``fn(x)`` for an elementwise ``fn`` that DTensor has no rule for
    (``logsigmoid``'s backward): on a DTensor, ``fn`` of the local shard
    (a partial sum made whole first), differentiably; ``fn(x)``
    otherwise."""
    if not isinstance(x, DTensor):
        return fn(x)
    mesh = x.device_mesh
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    x = x.redistribute(mesh, pl)
    return from_local(fn(x.to_local()), mesh, pl, tuple(x.shape))


def whole_local(t, mesh, split: Sequence[int]):
    """All of ``t`` on this rank, as a plain tensor, for work on this
    rank's own rows: its gradient is a partial sum over the mesh dims
    ``split`` (which split the rows: each rank's rows add their part) and
    whole over the others; ``t`` itself when it is not a DTensor. Nested
    dicts, lists and tuples are walked."""
    if isinstance(t, dict):
        return {k: whole_local(v, mesh, split) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(whole_local(v, mesh, split) for v in t)
    if not isinstance(t, DTensor):
        return t
    grad = [Partial() if m in split else Replicate()
            for m in range(mesh.ndim)]
    return t.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grad)


def rowwise(fn, x, *whole):
    """``fn(x, *whole)`` for a ``fn`` that maps each row of x (..., d) to a
    row (..., d') on its own, with ``whole`` (tensors, or dicts of them)
    read whole: on a DTensor x, ``fn`` of this rank's rows (x's last dim
    made whole first) with ``whole`` on this rank (:func:`whole_local`),
    the result in x's layout. DTensor cannot flatten a product's rows
    sharded past their first dim (b over data and s over model) in some
    releases; this runs them locally."""
    if not isinstance(x, DTensor):
        return fn(x, *whole)
    mesh, last = x.device_mesh, x.ndim - 1
    pl = [Replicate() if p.is_partial() or p.is_shard(last) else p
          for p in x.placements]
    x = x.redistribute(mesh, pl)
    split = [m for m, p in enumerate(pl) if p.is_shard()]
    out = fn(x.to_local(), *whole_local(whole, mesh, split))
    return from_local(out, mesh, pl, tuple(x.shape[:-1]) + (out.shape[-1],))


def matmul(x, w):
    """``x @ w`` for activations x (..., d) and a weight w (d, f). A DTensor
    x with a leading dim past the first sharded (the sequence under the
    sequence-parallel rules) is multiplied on each rank's rows by the
    whole w (:func:`rowwise`): DTensor's matmul flattens the leading dims,
    which some PyTorch releases (2.11) refuse when a dim past the first is
    sharded."""
    if isinstance(x, DTensor) and any(p.is_shard() and 0 < p.dim < x.ndim - 1
                                      for p in x.placements):
        return rowwise(lambda a, b: a @ b, x, w)
    return x @ w


def by_rows(fn, *xs, whole=()):
    """``fn(*xs, *whole)`` on each rank's rows when the first of ``xs`` is
    a DTensor: every tensor in ``xs`` (nested in dicts, lists and tuples)
    is laid out with dim 0 as the first one's and the rest whole, the
    tensors of ``whole`` (parameters) are read whole
    (:func:`whole_local`), ``fn`` runs on the local tensors, and its
    tensor outputs come back as DTensors in the rows' layout. For
    row-wise work (a recurrence step by step), which then runs with no
    collective and no DTensor dispatch per step; ``fn(*xs, *whole)``
    otherwise."""
    if not isinstance(xs[0], DTensor):
        return fn(*xs, *whole)
    mesh = xs[0].device_mesh
    rows = [Shard(0) if p.is_shard(0) else Replicate()
            for p in xs[0].placements]
    split = [m for m, p in enumerate(rows) if p.is_shard()]
    n = 1
    for m in split:
        n *= mesh.size(m)

    def to_local(x):
        if isinstance(x, dict):
            return {k: to_local(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(to_local(v) for v in x)
        return as_dtensor(x, mesh).redistribute(mesh, rows).to_local()

    def back(y):
        if isinstance(y, dict):
            return {k: back(v) for k, v in y.items()}
        if isinstance(y, (list, tuple)):
            return type(y)(back(v) for v in y)
        return from_local(y, mesh, rows, (y.shape[0] * n,)
                          + tuple(y.shape[1:]))
    return back(fn(*(to_local(x) for x in xs),
                   *whole_local(whole, mesh, split)))


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


def kv_span(q_off: int, q_len: int, g: int):
    """The KV heads ``[lo, hi)`` that query heads ``[q_off, q_off +
    q_len)`` read (query head j reads KV head ``j // g``), or None when
    that shard's heads do not map onto a contiguous KV span with one group
    size (a shard of whole groups, or a part of one group)."""
    lo, hi = q_off // g, (q_off + q_len - 1) // g + 1
    if (q_off % g == 0 and q_len % g == 0) or hi - lo == 1:
        return lo, hi
    return None


def shard_layout(q, k, mesh, seq: bool = False):
    """(q's placements, k's and v's, the KV heads ``[lo, hi)`` this rank's
    query heads read, the first of them this rank's k holds) for running
    an attention over (b, s, h, hd) on each rank's shards: batch rows
    sharded alike in q, k and v; with ``seq``, a sequence-sharded q keeps
    its rows against k and v whole along the sequence; query heads
    sharded with the KV heads they read (KV heads that a mesh dim does not
    divide stay whole, and each rank slices the span its query heads
    read), or whole where their groups split unevenly; the rest whole."""
    b, sq, h = q.shape[:3]
    kvh = k.shape[2]
    qp, kp = [], []
    for m in range(mesh.ndim):
        n, a, c = mesh.size(m), q.placements[m], k.placements[m]
        if (a.is_shard(0) or c.is_shard(0)) and b % n == 0:
            qp.append(Shard(0))
            kp.append(Shard(0))
        elif seq and a.is_shard(1) and sq % n == 0:
            qp.append(Shard(1))
            kp.append(Replicate())
        elif (a.is_shard(2) or c.is_shard(2)) and h % n == 0:
            qp.append(Shard(2))
            kp.append(Shard(2) if c.is_shard(2) and kvh % n == 0
                      else Replicate())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
    q_off, q_len = shard_range(qp, mesh, 2, h)
    k_off, k_len = shard_range(kp, mesh, 2, kvh)
    span = kv_span(q_off, q_len, h // kvh)
    if span is None or span[0] < k_off or span[1] > k_off + k_len:
        # query heads that split a group unevenly: heads whole
        qp = [Replicate() if p.is_shard(2) else p for p in qp]
        kp = [Replicate() if p.is_shard(2) else p for p in kp]
        k_off, span = 0, (0, kvh)
    return qp, kp, span, k_off


def attention_on_shards(fn, q, k, v, *, q_offset=0, **kw):
    """``fn(q, k, v, q_offset=, **kw)``, a plain attention over (b, s, h,
    hd), on each rank's local shards when q, k or v is a DTensor
    (:func:`shard_layout` with sequence-sharded queries: a rank's query
    rows sit at ``q_offset`` plus its first row), the output a DTensor in
    q's local layout; ``fn`` itself otherwise. Each rank's work is plain
    PyTorch on plain tensors, which no DTensor release has to
    propagate."""
    mesh = next((x.device_mesh for x in (q, k, v)
                 if isinstance(x, DTensor)), None)
    if mesh is None:
        return fn(q, k, v, q_offset=q_offset, **kw)
    q, k, v = (as_dtensor(x, mesh) for x in (q, k, v))
    qp, kp, span, k_off = shard_layout(q, k, mesh, seq=True)
    # k and v whole where q's rows or heads split: their gradients are
    # each rank's part of a sum there
    grad = [Partial() if b.is_replicate() and a.is_shard() else b
            for a, b in zip(qp, kp)]
    ql = q.redistribute(mesh, qp).to_local()
    kl, vl = (x.redistribute(mesh, kp).to_local(grad_placements=grad)[
        :, :, span[0] - k_off:span[1] - k_off] for x in (k, v))
    row0 = shard_range(qp, mesh, 1, q.shape[1])[0]
    out = fn(ql, kl, vl, q_offset=q_offset + row0, **kw)
    return from_local(out, mesh, qp, tuple(q.shape))
