"""Oracles of the port's kernels, ported from ``repro.kernels.ref``.

Each follows its JAX counterpart op for op, dtypes included, so that the
tests can hold the port's plain versions and kernels against the same
contract the reference's Pallas kernels are held to.
"""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal=True, window=0, sm_scale=None):
    """q: (b, sq, h, hd); k / v: (b, skv, kvh, hd). GQA by head grouping."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    q5 = q.reshape(b, sq, kvh, g, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", q5, k).float() * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    s = torch.where(ok, s, torch.tensor(-1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return o.reshape(b, sq, h, hd)


def decode_attention_ref(q, k_cache, v_cache, cur_len):
    """q: (b, h, hd); caches (b, S, kvh, hd); cur_len: scalar or (b,)."""
    b, h, hd = q.shape
    S, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    q4 = q.reshape(b, kvh, g, hd)
    s = torch.einsum("bkgh,bskh->bkgs", q4, k_cache).float() * scale
    lens = torch.as_tensor(cur_len, device=q.device).expand(b)
    ok = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    s = torch.where(ok[:, None, None, :], s, torch.tensor(-1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, h, hd)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, cur_len):
    """q: (b, h, hd); pages: (num_blocks, block_size, kvh, hd);
    block_tables: (b, npages); cur_len: (b,). Each row's pages gathered
    into a contiguous view, then the contiguous decode oracle."""
    b = q.shape[0]
    kvh, hd = k_pages.shape[2], k_pages.shape[3]
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, -1, kvh, hd)
    v = v_pages[bt].reshape(b, -1, kvh, hd)
    return decode_attention_ref(q, k, v, cur_len)


def ragged_paged_attention_ref(q, k_pages, v_pages, block_tables, token_rows,
                               token_pos):
    """q: (T, h, hd) packed tokens; pages: (num_blocks, block_size, kvh, hd);
    block_tables: (num_slots, npages); token_rows / token_pos: (T,). The
    contiguous decode oracle per token after the per-token block-table
    gather; dead tokens (``token_pos < 0``) give exact zeros."""
    T, h, hd = q.shape
    kvh = k_pages.shape[2]
    bt = block_tables.long()[token_rows.long()]               # (T, npages)
    k = k_pages[bt].reshape(T, -1, kvh, hd)
    v = v_pages[bt].reshape(T, -1, kvh, hd)
    o = decode_attention_ref(q, k, v, token_pos.long() + 1)
    return torch.where((token_pos >= 0)[:, None, None], o,
                       torch.zeros((), dtype=o.dtype)).to(q.dtype)


def aot_gather_add_ref(h, table, ids):
    """The paper's Eq. 1: h (T, d) + table (V, d)[ids (T,)], ids in range."""
    return h + table[ids.long()].to(h.dtype)


def aot_gather_add_multitask_ref(h, tables, task_ids, ids):
    """h: (T, d); tables: (n_tasks, V, d); task_ids / ids: (T,) -> (T, d)."""
    return h + tables[task_ids.long(), ids.long()].to(h.dtype)
