"""Flash attention for prefill: a whole prompt attending over itself.

Counterpart of ``repro.kernels.flash_attention.flash_attention_kernel``.
q (b, sq, h, hd) attends over k / v (b, skv, kvh, hd) with GQA (query head
``kh * g + i`` reads KV head ``kh``); query row i sits at position ``qpos
= q_offset + i`` and sees kv position ``kpos`` when ``kpos <= qpos``
(``causal``; kv positions count from 0 and queries from ``q_offset``, the
reference's top-left alignment, whatever sq and skv are) and ``kpos > qpos -
window`` (``window > 0``). P-Tuning v2 attends with ``q_offset`` = its
prefix length over ``[prefix | k]``. The CUDA kernel is
``csrc/flash_attention.cu``;
the plain version below is the reference kernel's masked fp32 softmax in
one piece.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import on_device as _on_device

NEG = -1e30          # the reference kernel's mask value
MAX_G = 96           # query heads per KV head the kernel's tile can hold

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64


def flash_attention_plain(q, k, v, *, causal=True, window=0, sm_scale=None,
                          q_offset=0):
    """q: (b, sq, h, hd); k / v: (b, skv, kvh, hd) -> (b, sq, h, hd) in q's
    dtype, computed in float32."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    q5 = q.reshape(b, sq, kvh, g, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", q5, k.float()) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    p = torch.softmax(s.masked_fill(~ok, NEG), dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


_FN = None


def _lib():
    """The kernel's C entry point, built and loaded on first use."""
    global _FN
    if _FN is None:
        fn = _build.load("flash_attention").flash_attention
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _L, _L, _L, _L, _L, _L, _L, _L, _L,
                       _I, _I, _I, ctypes.c_float, _I, _P]
        fn.restype = _I
        _FN = fn
    return _FN


def flash_attention_kernel(q, k, v, *, causal=True, window=0, sm_scale=None,
                           q_offset=0):
    """Launch the CUDA kernel on CUDA tensors (same device; q, k and v all
    float32 or all bfloat16, each with a unit channel stride, any other
    strides; h a multiple of kvh with at most 96 query heads per KV head;
    hd <= 128). Raises on anything the kernel does not take; never falls
    back."""
    dev = q.device
    for name, x in (("k", k), ("v", v)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q {q.dtype}: the kernel takes float32 or bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k {k.dtype} / v {v.dtype} must match q {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (b, sq, h, hd), k and "
                         f"v (b, skv, kvh, hd): got k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    b, sq, h, hd = q.shape
    _, skv, kvh, hd_k = k.shape
    if k.shape[0] != b or hd_k != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree")
    if h % kvh or h // kvh > MAX_G or not 0 < hd <= 128:
        raise ValueError(f"unsupported h {h} / kvh {kvh} / hd {hd}")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window {window} and q_offset {q_offset} must be "
                         ">= 0")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} needs a unit channel stride")
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    out = torch.empty(b, sq, h, hd, dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    with _on_device(dev):
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b, sq, skv, h, kvh, hd, *q.stride()[:3],
                     *k.stride()[:3], *v.stride()[:3], int(causal),
                     int(window), int(q_offset), scale,
                     int(q.dtype == torch.bfloat16),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return out
