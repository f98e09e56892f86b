"""Ragged paged attention: one packed token list over a paged KV pool.

Counterpart of ``repro.kernels.decode_attention.ragged_paged_attention_kernel``.
Token t belongs to slot ``token_rows[t]`` at absolute position
``token_pos[t]``; its query heads attend causally (kv position <= its own)
over that slot's pages, read through ``block_tables``; ``token_pos < 0``
marks a dead padding token, whose output is exact zeros. The CUDA kernel is
``csrc/ragged_paged_attention.cu``; the plain version below gathers each
token's pages and applies a masked fp32 softmax, as the reference's XLA
path (``layers.ragged_paged_attention_decode``) does.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import on_device as _on_device

# the reference's additive mask value (-0.7 * float32 max)
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

_P = ctypes.c_void_p
_I = ctypes.c_int


def round_kv_len(n: int, block_k: int = 256) -> int:
    """Round a KV allocation length up to a multiple of ``block_k`` (lengths
    up to ``block_k`` stay as they are), as the reference's cache owners do
    so that its contiguous decode kernel never pads."""
    if n <= block_k:
        return n
    return -(-n // block_k) * block_k


def ragged_paged_attention_plain(q, k_pages, v_pages, block_tables,
                                 token_rows, token_pos):
    """q: (T, h, hd); k_pages / v_pages: (num_blocks, block_size, kvh, hd);
    block_tables: (num_slots, npages); token_rows / token_pos: (T,).
    Returns (T, h, hd) in q's dtype, computed in float32."""
    T, h, hd = q.shape
    kvh = k_pages.shape[2]
    g = h // kvh
    bt = block_tables.long()[token_rows.long()]               # (T, npages)
    k = k_pages[bt].reshape(T, -1, kvh, hd).float()           # (T, S, kvh, hd)
    v = v_pages[bt].reshape(T, -1, kvh, hd).float()
    q4 = q.reshape(T, kvh, g, hd).float()
    s = torch.einsum("tkgh,tskh->tkgs", q4, k) / math.sqrt(hd)
    pos = token_pos.long()
    ok = torch.arange(k.shape[1], device=q.device)[None, :] < (pos + 1)[:, None]
    s = s.masked_fill(~ok[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("tkgs,tskh->tkgh", p, v).reshape(T, h, hd)
    o = o.masked_fill((pos < 0)[:, None, None], 0.0)
    return o.to(q.dtype)


_FN = None


def _lib():
    """The kernel's C entry point, built and loaded on first use."""
    global _FN
    if _FN is None:
        fn = _build.load("ragged_paged_attention").ragged_paged_attention
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _I, _I, _P]
        fn.restype = _I
        _FN = fn
    return _FN


def ragged_paged_attention_kernel(q, k_pages, v_pages, block_tables,
                                  token_rows, token_pos):
    """Launch the CUDA kernel on CUDA tensors (same device, contiguous; q
    and the pages both float32 or both bfloat16; indices int32; hd <= 128;
    h a multiple of kvh). Raises on anything the kernel does not take;
    never falls back."""
    dev = q.device
    args = (("k_pages", k_pages), ("v_pages", v_pages),
            ("block_tables", block_tables), ("token_rows", token_rows),
            ("token_pos", token_pos))
    for name, x in args:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q {q.dtype}: the kernel takes float32 or bfloat16")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"pages {k_pages.dtype}/{v_pages.dtype} must match "
                        f"q {q.dtype}")
    for name, x in args[2:]:
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or block_tables.dim() != 2:
        raise ValueError("q must be (T, h, hd), pages (num_blocks, "
                         "block_size, kvh, hd), block_tables (slots, npages)")
    T, h, hd = q.shape
    _, block_size, kvh, hd_k = k_pages.shape
    npages = block_tables.shape[1]
    if v_pages.shape != k_pages.shape or hd_k != hd:
        raise ValueError(f"q {tuple(q.shape)}, k_pages "
                         f"{tuple(k_pages.shape)}, v_pages "
                         f"{tuple(v_pages.shape)} disagree")
    if h % kvh or not 0 < hd <= 128 or npages < 1:
        raise ValueError(f"unsupported h {h} / kvh {kvh} / hd {hd} / "
                         f"npages {npages}")
    if token_rows.shape != (T,) or token_pos.shape != (T,):
        raise ValueError("token_rows and token_pos must be (T,)")
    for name, x in (("q", q),) + args:
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    out = torch.empty_like(q)
    if T == 0:
        return out
    vec = hd % 8 == 0 and all(x.data_ptr() % 16 == 0
                              for x in (k_pages, v_pages))
    with _on_device(dev):
        err = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     block_tables.data_ptr(), token_rows.data_ptr(),
                     token_pos.data_ptr(), out.data_ptr(), T, kvh, h // kvh,
                     hd, block_size, npages, 1.0 / math.sqrt(hd),
                     int(q.dtype == torch.bfloat16), int(vec),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA "
                           f"error {err}")
    return out
