"""The paper's hot path, fused gather + add (Eq. 1), across tasks.

``out[t] = h[t] + tables[task_ids[t], ids[t]].to(h.dtype)``

Counterpart of ``repro.kernels.aot_bias.aot_gather_add_multitask_kernel``.
The CUDA kernel is ``csrc/aot_gather_add.cu``; the plain version below is
what the tests run on the CPU and what the kernel is held against on the
card. Both wrap a negative index once and clamp into range, as the XLA
gather of the reference does, and both are exact: the table row is
converted to h's type and added in h's type.
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


def aot_gather_add_multitask_plain(h, tables, task_ids, ids):
    """h: (T, d); tables: (n_tasks, V, d); task_ids, ids: (T,) -> (T, d)."""
    n_tasks, vocab = tables.shape[0], tables.shape[1]
    rows = tables[gather_index(task_ids, n_tasks), gather_index(ids, vocab)]
    return h + rows.to(h.dtype)


_FN = None


def _lib():
    """The kernel's C entry point, built and loaded on first use."""
    global _FN
    if _FN is None:
        fn = _build.load("aot_gather_add").aot_gather_add_multitask
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
        _FN = fn
    return _FN


_TYPES = (torch.float32, torch.bfloat16)


def aot_gather_add_multitask_kernel(h, tables, task_ids, ids):
    """Launch the CUDA kernel on CUDA tensors (same device, contiguous;
    h and tables float32 or bfloat16, ids int32). Raises on anything the
    kernel does not take; never falls back."""
    dev = h.device
    for name, x in (("tables", tables), ("task_ids", task_ids), ("ids", ids)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, h on {dev}")
    if h.dtype not in _TYPES or tables.dtype not in _TYPES:
        raise TypeError(f"h {h.dtype} / tables {tables.dtype}: the kernel "
                        "takes float32 or bfloat16")
    if task_ids.dtype != torch.int32 or ids.dtype != torch.int32:
        raise TypeError("task_ids and ids must be int32")
    if h.dim() != 2 or tables.dim() != 3:
        raise ValueError(f"h {tuple(h.shape)} must be (T, d), tables "
                         f"{tuple(tables.shape)} (n_tasks, V, d)")
    T, d = h.shape
    n_tasks, vocab, dt = tables.shape
    if dt != d or task_ids.shape != (T,) or ids.shape != (T,):
        raise ValueError(f"shapes disagree: h {tuple(h.shape)}, tables "
                         f"{tuple(tables.shape)}, task_ids "
                         f"{tuple(task_ids.shape)}, ids {tuple(ids.shape)}")
    if n_tasks < 1 or vocab < 1:
        raise ValueError("empty tables")
    for name, x in (("h", h), ("tables", tables), ("task_ids", task_ids),
                    ("ids", ids)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    out = torch.empty_like(h)
    if out.numel() == 0:
        return out
    vec = d % 8 == 0 and all(x.data_ptr() % 16 == 0
                             for x in (h, tables, out))
    with _on_device(dev):
        err = _lib()(h.data_ptr(), tables.data_ptr(), task_ids.data_ptr(),
                     ids.data_ptr(), out.data_ptr(), T, n_tasks, vocab, d,
                     int(h.dtype == torch.bfloat16),
                     int(tables.dtype == torch.bfloat16), int(vec),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"aot_gather_add_multitask launch failed: CUDA "
                           f"error {err}")
    return out
