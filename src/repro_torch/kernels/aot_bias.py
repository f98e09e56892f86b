"""The paper's hot path, fused gather + add (Eq. 1), for one task's table
and across tasks, and the RMSNorm that each layer applies to that sum next.

``out[t] = h[t] + table[ids[t]].to(h.dtype)`` and
``out[t] = h[t] + tables[task_ids[t], ids[t]].to(h.dtype)``; with
``norm=(scale, eps)`` also ``x = rms_norm(out, scale, eps)``.

Counterparts of ``repro.kernels.aot_bias.aot_gather_add_kernel`` and
``aot_gather_add_multitask_kernel``. Every CUDA kernel is
``csrc/aot_gather_add.cu`` (five C entry points over one device body: the
two gather-adds, each with and without the norm, and the norm alone); the
plain versions below are what the tests run on the CPU and what the kernels
are held against on the card. Each gather follows the index rule of the XLA
gather it stands in for: the multi-task one (``tables[task_ids, ids]``)
wraps a negative index once and clamps into range; the single-table one
(``jnp.take(table, ids, axis=0)``, the model's ``rows_fused``) wraps a
negative id once and gives a NaN row for an id still outside ``[0, V)``.
The sums are exact: the table row is converted to h's type and added in
h's type. The norm is :func:`rms_norm_plain`'s float32 arithmetic, which
``layers.apply_norm`` shares; the kernel sums the squares in another order,
so its x agrees within rounding, not bitwise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import on_device as _on_device

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def gather_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """numpy/XLA gather index rule: a negative index wraps once, then the
    index clamps into ``[0, n)``."""
    i = i.long()
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def take_rows(table, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: rows ``table[ids]``, a negative id
    wrapping once; an id still outside ``[0, V)`` gives a row of NaN."""
    vocab = table.shape[0]
    i = ids.long()
    i = torch.where(i < 0, i + vocab, i)
    ok = (i >= 0) & (i < vocab)
    rows = table[i.clamp(0, vocab - 1)]
    return torch.where(ok[..., None], rows, rows.new_full((), float("nan")))


def rms_norm_plain(x, scale, eps):
    """RMSNorm in float32, result in x's dtype: ``x * rsqrt(mean(x^2) +
    eps) * scale`` over the last axis (the one definition of the norm's
    arithmetic; ``layers.apply_norm`` is this)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _with_norm(out, norm):
    """``out``, or with ``norm`` = (scale, eps) the pair (out, its norm)."""
    return out if norm is None else (out, rms_norm_plain(out, *norm))


def aot_gather_add_plain(h, table, ids, *, norm=None):
    """h: (..., d); table: (V, d); ids: h's leading shape -> h's shape; with
    ``norm`` = (scale (d,), eps) the pair (that sum, its RMSNorm)."""
    return _with_norm(h + take_rows(table, ids).to(h.dtype), norm)


def aot_gather_add_multitask_plain(h, tables, task_ids, ids, *, norm=None):
    """h: (T, d); tables: (n_tasks, V, d); task_ids, ids: (T,) -> (T, d);
    with ``norm`` as for :func:`aot_gather_add_plain`."""
    n_tasks, vocab = tables.shape[0], tables.shape[1]
    rows = tables[gather_index(task_ids, n_tasks), gather_index(ids, vocab)]
    return _with_norm(h + rows.to(h.dtype), norm)


def sharded_rows(table, task_ids, ids):
    """The rows ``table[ids]`` (or ``tables[task_ids, ids]``, a 3-d
    table) of a DTensor table whose task, vocab or embed dims are sharded,
    for plain index tensors ``task_ids`` (None for one table) / ``ids``
    (T,) that every rank holds alike: a DTensor (T, d) in the table's
    dtype. Each rank takes the rows its vocab (and task) shard holds, in
    its embed slice, and zeros for the rest: a partial sum over the mesh
    dims that shard the rows (exact, one non-zero term per element), an
    embed shard over the one that shards d. Only these T rows move, never
    the table. Indices follow the multi-task gather's rule (wrap once,
    clamp); the single-table rule's NaN rows are the caller's."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.distrib.sharding import from_local, shard_range
    mesh, lead = table.device_mesh, table.dim() - 2
    vocab, d = table.shape[-2], table.shape[-1]
    v = gather_index(ids, vocab)
    v_off, v_len = shard_range(table.placements, mesh, lead, vocab)
    mine = (v >= v_off) & (v < v_off + v_len)
    at = [(v - v_off).clamp(0, v_len - 1)]
    if lead:
        n_tasks = table.shape[0]
        t = gather_index(task_ids, n_tasks)
        t_off, t_len = shard_range(table.placements, mesh, 0, n_tasks)
        mine &= (t >= t_off) & (t < t_off + t_len)
        at.insert(0, (t - t_off).clamp(0, t_len - 1))
    local = table.to_local()[tuple(at)]                   # (T, d_local)
    local = torch.where(mine[:, None], local, local.new_zeros(()))
    placements = [Shard(1) if p.is_shard(lead + 1) else
                  Partial() if p.is_shard() else Replicate()
                  for p in table.placements]
    return from_local(local, mesh, placements, (ids.shape[0], d))


_FNS = {}
_ARGTYPES = {
    "aot_gather_add": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "aot_gather_add_multitask": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _P],
    "aot_gather_add_norm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I,
                            _I, _P],
    "aot_gather_add_multitask_norm": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _F, _I, _I, _I, _P],
    "rms_norm": [_P, _P, _P, _I, _I, _F, _I, _I, _P],
}


def _lib(entry: str):
    """C entry point ``entry`` of the kernel, built and loaded on first
    use."""
    fn = _FNS.get(entry)
    if fn is None:
        fn = getattr(_build.load("aot_gather_add"), entry)
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = _I
        _FNS[entry] = fn
    return fn


_TYPES = (torch.float32, torch.bfloat16)


def _check(h, others, d_in, norm):
    """The checks every entry shares: h (T, d) float32 or bfloat16; the
    tensors ``others`` (the table, int32 indices) and the norm's scale (d,)
    float32 on h's device; every tensor contiguous; d_in, the width of the
    table's rows, equal to d."""
    dev = h.device
    scale = () if norm is None else (("scale", norm[0]),)
    named = (("h", h), *others.items(), *scale)
    for name, x in named[1:]:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, h on {dev}")
    table = others.get("table")
    if h.dtype not in _TYPES or (table is not None
                                 and table.dtype not in _TYPES):
        raise TypeError(f"h {h.dtype} / table "
                        f"{None if table is None else table.dtype}: the "
                        "kernel takes float32 or bfloat16")
    index = {n: x for n, x in others.items() if n != "table"}
    if any(x.dtype != torch.int32 for x in index.values()):
        raise TypeError(f"{' and '.join(index)} must be int32")
    if h.dim() != 2 or d_in != h.shape[1] or any(
            x.shape != (h.shape[0],) for x in index.values()):
        raise ValueError(f"shapes disagree: h {tuple(h.shape)}, " + ", ".join(
            f"{n} {tuple(x.shape)}" for n, x in others.items()))
    if norm is not None:
        if norm[0].dtype != torch.float32:
            raise TypeError(f"scale {norm[0].dtype}: the kernel takes a "
                            "float32 scale")
        if norm[0].shape != (h.shape[1],):
            raise ValueError(f"scale {tuple(norm[0].shape)} must be "
                             f"({h.shape[1]},)")
    for name, x in named:
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")


def _launch(entry, h, table, pointers, sizes, norm):
    """Allocate the outputs, launch C entry ``entry`` with ``pointers``
    (the inputs'), the scale's, the outputs', ``sizes``, eps and the type
    flags; raise on a failed launch. Returns out (the gather-add), (out, x)
    (the gather-add with ``norm``) or x (no ``table``: the norm alone)."""
    n_out = (table is not None) + (norm is not None)    # out and/or x
    outs = [torch.empty_like(h) for _ in range(n_out)]
    res = outs[0] if len(outs) == 1 else tuple(outs)
    if h.numel() == 0:
        return res
    scale = [] if norm is None else [norm[0]]
    with_table = [] if table is None else [table]
    vec = h.shape[1] % 8 == 0 and all(
        x.data_ptr() % 16 == 0 for x in (h, *with_table, *scale, *outs))
    flags = [int(x.dtype == torch.bfloat16) for x in (h, *with_table)]
    eps = [] if norm is None else [float(norm[1])]
    with _on_device(h.device):
        err = _lib(entry)(*pointers, *(x.data_ptr() for x in scale),
                          *(x.data_ptr() for x in outs), *sizes, *eps,
                          *flags, int(vec),
                          torch.cuda.current_stream(h.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return res


def aot_gather_add_kernel(h, table, ids, *, norm=None):
    """Launch the single-table CUDA kernel on CUDA tensors: h (T, d) and
    table (V, d), each float32 or bfloat16, ids (T,) int32, all on one
    device and contiguous; with ``norm`` = (scale (d,) float32, eps) the
    fused entry, returning (out, x). Raises on anything the kernel does not
    take; never falls back."""
    if table.dim() != 2:
        raise ValueError(f"table {tuple(table.shape)} must be (V, d)")
    _check(h, {"table": table, "ids": ids}, table.shape[1], norm)
    vocab = table.shape[0]
    if vocab < 1:
        raise ValueError("empty table")
    T, d = h.shape
    return _launch("aot_gather_add" + ("" if norm is None else "_norm"), h,
                   table, (h.data_ptr(), table.data_ptr(), ids.data_ptr()),
                   (T, vocab, d), norm)


def aot_gather_add_multitask_kernel(h, tables, task_ids, ids, *, norm=None):
    """Launch the multi-task CUDA kernel on CUDA tensors: h (T, d), tables
    (n_tasks, V, d), task_ids and ids (T,) int32, otherwise as
    :func:`aot_gather_add_kernel`."""
    if tables.dim() != 3:
        raise ValueError(f"tables {tuple(tables.shape)} must be "
                         "(n_tasks, V, d)")
    _check(h, {"table": tables, "task_ids": task_ids, "ids": ids},
           tables.shape[2], norm)
    n_tasks, vocab = tables.shape[0], tables.shape[1]
    if n_tasks < 1 or vocab < 1:
        raise ValueError("empty tables")
    T, d = h.shape
    return _launch("aot_gather_add_multitask"
                   + ("" if norm is None else "_norm"), h, tables,
                   (h.data_ptr(), tables.data_ptr(), task_ids.data_ptr(),
                    ids.data_ptr()), (T, n_tasks, vocab, d), norm)


def rms_norm_kernel(h, scale, eps):
    """Launch the norm-only CUDA kernel (the same body with no table) on
    CUDA tensors: h (T, d) float32 or bfloat16 and scale (d,) float32, on
    one device and contiguous -> x (T, d) of h's dtype. Raises on anything
    the kernel does not take; never falls back."""
    _check(h, {}, h.shape[-1], (scale, eps))
    T, d = h.shape
    return _launch("rms_norm", h, None, (h.data_ptr(),), (T, d),
                   (scale, eps))
