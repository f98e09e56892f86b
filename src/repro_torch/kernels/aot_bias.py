"""The paper's hot path, fused gather + add (Eq. 1), for one task's table
and across tasks.

``out[t] = h[t] + table[ids[t]].to(h.dtype)`` and
``out[t] = h[t] + tables[task_ids[t], ids[t]].to(h.dtype)``

Counterparts of ``repro.kernels.aot_bias.aot_gather_add_kernel`` and
``aot_gather_add_multitask_kernel``. Both CUDA kernels are
``csrc/aot_gather_add.cu`` (two C entry points over one device body); the
plain versions below are what the tests run on the CPU and what the kernels
are held against on the card. Each follows the index rule of the XLA
gather it stands in for: the multi-task one (``tables[task_ids, ids]``)
wraps a negative index once and clamps into range; the single-table one
(``jnp.take(table, ids, axis=0)``, the model's ``rows_fused``) wraps a
negative id once and gives a NaN row for an id still outside ``[0, V)``.
All are exact: the table row is converted to h's type and added in h's
type.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import on_device as _on_device

_P = ctypes.c_void_p
_I = ctypes.c_int


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


def aot_gather_add_plain(h, table, ids):
    """h: (..., d); table: (V, d); ids: h's leading shape -> h's shape."""
    return h + take_rows(table, ids).to(h.dtype)


def aot_gather_add_multitask_plain(h, tables, task_ids, ids):
    """h: (T, d); tables: (n_tasks, V, d); task_ids, ids: (T,) -> (T, d)."""
    n_tasks, vocab = tables.shape[0], tables.shape[1]
    rows = tables[gather_index(task_ids, n_tasks), gather_index(ids, vocab)]
    return h + rows.to(h.dtype)


_FNS = {}
_ARGTYPES = {
    "aot_gather_add": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "aot_gather_add_multitask": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _P],
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


def _check(h, table, index, d_table):
    """The checks both kernels share: h (T, d) float32 or bfloat16 on the
    table's and indices' device, int32 indices, every tensor contiguous."""
    dev = h.device
    for name, x in (("table", table), *index.items()):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, h on {dev}")
    if h.dtype not in _TYPES or table.dtype not in _TYPES:
        raise TypeError(f"h {h.dtype} / table {table.dtype}: the kernel "
                        "takes float32 or bfloat16")
    if any(x.dtype != torch.int32 for x in index.values()):
        raise TypeError(f"{' and '.join(index)} must be int32")
    if h.dim() != 2 or d_table != h.shape[1] or any(
            x.shape != (h.shape[0],) for x in index.values()):
        raise ValueError(f"shapes disagree: h {tuple(h.shape)}, table "
                         f"{tuple(table.shape)}, " + ", ".join(
                             f"{n} {tuple(x.shape)}"
                             for n, x in index.items()))
    for name, x in (("h", h), ("table", table), *index.items()):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")


def _launch(entry, h, table, args):
    """Allocate the output, launch C entry ``entry`` with ``args`` between
    the pointers and the type flags, raise on a failed launch."""
    out = torch.empty_like(h)
    if out.numel() == 0:
        return out
    vec = h.shape[1] % 8 == 0 and all(x.data_ptr() % 16 == 0
                                      for x in (h, table, out))
    with _on_device(h.device):
        err = _lib(entry)(*args(out), int(h.dtype == torch.bfloat16),
                          int(table.dtype == torch.bfloat16), int(vec),
                          torch.cuda.current_stream(h.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return out


def aot_gather_add_kernel(h, table, ids):
    """Launch the single-table CUDA kernel on CUDA tensors: h (T, d) and
    table (V, d), each float32 or bfloat16, ids (T,) int32, all on one
    device and contiguous. Raises on anything the kernel does not take;
    never falls back."""
    if table.dim() != 2:
        raise ValueError(f"table {tuple(table.shape)} must be (V, d)")
    _check(h, table, {"ids": ids}, table.shape[1])
    vocab = table.shape[0]
    if vocab < 1:
        raise ValueError("empty table")
    T, d = h.shape
    return _launch("aot_gather_add", h, table, lambda out: (
        h.data_ptr(), table.data_ptr(), ids.data_ptr(), out.data_ptr(), T,
        vocab, d))


def aot_gather_add_multitask_kernel(h, tables, task_ids, ids):
    """Launch the multi-task CUDA kernel on CUDA tensors: h (T, d), tables
    (n_tasks, V, d), task_ids and ids (T,) int32, otherwise as
    :func:`aot_gather_add_kernel`."""
    if tables.dim() != 3:
        raise ValueError(f"tables {tuple(tables.shape)} must be "
                         "(n_tasks, V, d)")
    _check(h, tables, {"task_ids": task_ids, "ids": ids}, tables.shape[2])
    n_tasks, vocab = tables.shape[0], tables.shape[1]
    if n_tasks < 1 or vocab < 1:
        raise ValueError("empty tables")
    T, d = h.shape
    return _launch("aot_gather_add_multitask", h, tables, lambda out: (
        h.data_ptr(), tables.data_ptr(), task_ids.data_ptr(), ids.data_ptr(),
        out.data_ptr(), T, n_tasks, vocab, d))
