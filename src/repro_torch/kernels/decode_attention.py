"""Decode attention over a KV cache: contiguous, paged, and ragged paged.

Counterparts of ``decode_attention_kernel``, ``paged_decode_attention_kernel``
and ``ragged_paged_attention_kernel`` of ``repro.kernels.decode_attention``.

- Contiguous decode: row b's query heads attend over kv positions
  ``0 .. cur_len[b] - 1`` of its ``(S, kvh, hd)`` cache row.
- Paged decode: the same over a paged pool, row b's positions read through
  ``block_tables[b]``.
- Ragged paged: one packed token list; token t belongs to slot
  ``token_rows[t]`` at absolute position ``token_pos[t]`` and attends
  causally (kv position <= its own) over that slot's pages;
  ``token_pos < 0`` marks a dead padding token.

In all three a row with nothing to see (``cur_len <= 0``, a dead token)
gives exact zeros, as the reference kernels do, and K/V past a row's
length (stale rows, scratch page 0) never reaches the output, even NaN. The CUDA kernels are the
three C entry points of ``csrc/decode_attention.cu``. Each single query
token walks its history split over a thread-block cluster of
``decode_split(capacity)`` blocks (capacity: S, or ``npages x
block_size``), the K/V tiles staged row by row through the block table, so
a paged row is bitwise the contiguous row over the same K/V. The ragged
kernel follows a per-tick plan (:func:`ragged_plan`, built on the host from
its own copies of the indices and uploaded with the tick's other arrays):
a run of a slot's tokens at consecutive positions (a prefill chunk) goes in
pieces of ``TILE_TOKENS`` to one cluster that stages the slot's pages once
for them; every other token walks alone. Either way each live token's row
is the split walk's arithmetic over its own positions, so it is bitwise
the paged decode row with ``cur_len = pos + 1`` however the tick packed
it (ROADMAP C4). The plain versions below
gather each row's pages and apply a masked fp32 softmax, as the
reference's XLA path (``layers.attention_decode``) does; they take no
plan.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import on_device as _on_device

# the reference's additive mask value (-0.7 * float32 max)
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_G = 8            # query heads per KV head the paged and ragged walks hold
MAX_HD = 128         # the paged and ragged walks' largest head_dim
# contiguous decode also takes recurrentgemma-9b's MQA: g up to 16 (in
# clusters of 8 heads) and hd up to 256 (the wide walk)
MAX_G_CONTIGUOUS = 16
MAX_HD_CONTIGUOUS = 256
SPLIT_POSITIONS = 256   # cache positions per block of a decode cluster
MAX_SPLIT = 8           # blocks a cluster holds
TILE_TOKENS = 16        # tokens of a ragged run per cluster


def round_kv_len(n: int, block_k: int = 256) -> int:
    """Round a KV allocation length up to a multiple of ``block_k`` (lengths
    up to ``block_k`` stay as they are), as the reference's cache owners do
    so that its contiguous decode kernel never pads."""
    if n <= block_k:
        return n
    return -(-n // block_k) * block_k


def decode_split(S: int) -> int:
    """Blocks of the cluster that shares one (row or token, KV head) walk
    of the decode kernels: one per ``SPLIT_POSITIONS`` positions of the
    capacity S (a contiguous cache's length, a paged table's ``npages x
    block_size``), at least 1 and at most ``MAX_SPLIT``. Sized from S,
    which the host knows (the lengths live on the device); block r walks
    positions ``[r c, (r + 1) c)``, ``c = ceil(S / split)``, cut at its
    row's length. (At the static batch, S 1024 and depths 512-575 on an
    H100, 4 blocks of 256 positions beat 8 of 128: 640 blocks do not fit
    on the card at once.)"""
    return max(1, min(MAX_SPLIT, -(-S // SPLIT_POSITIONS)))


def _lengths(cur_len, b: int, device) -> torch.Tensor:
    """A scalar or (b,) ``cur_len`` as a (b,) int32 tensor on ``device``. A
    host number is filled in on the device: no upload, so no wait on the
    stream."""
    if not isinstance(cur_len, torch.Tensor):
        cur_len = torch.as_tensor(cur_len)
        if cur_len.dim() == 0:
            return torch.full((b,), int(cur_len), dtype=torch.int32,
                              device=device)
    return cur_len.to(device=device, dtype=torch.int32).expand(b).contiguous()


def decode_attention_plain(q, k_cache, v_cache, cur_len):
    """q: (b, h, hd); caches: (b, S, kvh, hd); cur_len: scalar or (b,).
    Returns (b, h, hd) in q's dtype, computed in float32."""
    b, h, hd = q.shape
    S, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    lens = _lengths(cur_len, b, q.device).long()
    q4 = q.reshape(b, kvh, g, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", q4, k_cache.float()) / math.sqrt(hd)
    ok = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    s = s.masked_fill(~ok[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    # unread positions contribute exact zeros, whatever V holds there (a
    # stale NaN times a masked-out 0 would be NaN), as the kernels stage
    v = torch.where(ok[:, :, None, None], v_cache.float(), 0.0)
    o = torch.einsum("bkgs,bskh->bkgh", p, v).reshape(b, h, hd)
    o = o.masked_fill((lens <= 0)[:, None, None], 0.0)
    return o.to(q.dtype)


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables, cur_len):
    """q: (b, h, hd); pages: (num_blocks, block_size, kvh, hd);
    block_tables: (b, npages); cur_len: (b,). Each row's pages gathered
    into a contiguous cache, then :func:`decode_attention_plain`."""
    b = q.shape[0]
    kvh, hd = k_pages.shape[2], k_pages.shape[3]
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, -1, kvh, hd)
    v = v_pages[bt].reshape(b, -1, kvh, hd)
    return decode_attention_plain(q, k, v, cur_len)


def ragged_paged_attention_plain(q, k_pages, v_pages, block_tables,
                                 token_rows, token_pos):
    """q: (T, h, hd); k_pages / v_pages: (num_blocks, block_size, kvh, hd);
    block_tables: (num_slots, npages); token_rows / token_pos: (T,).
    Paged decode of each token over its slot's table with ``token_pos + 1``
    visible positions. Returns (T, h, hd) in q's dtype."""
    return paged_decode_attention_plain(
        q, k_pages, v_pages, block_tables.long()[token_rows.long()],
        token_pos.long() + 1)


def ragged_plan(token_rows, token_pos) -> np.ndarray:
    """The ragged kernel's plan for one packed list, from host arrays
    (T,): int32 rows of (first token, count) that cover tokens 0 .. T - 1
    once each, in order; the kernel reads an item's slot and positions
    from the indices. A run is tokens consecutive in the list, of one slot,
    at consecutive positions >= 0 (a prefill chunk builds one); it is cut
    into items of at most ``TILE_TOKENS``, and an item of count > 1 shares
    its staged K/V. A live token in no longer run is an item of its own
    (count 1). Dead tokens (position < 0) next to each other form one item
    of any length, whose rows are zeros."""
    rows = np.asarray(token_rows, np.int64).reshape(-1)
    pos = np.asarray(token_pos, np.int64).reshape(-1)
    T = pos.shape[0]
    live = pos >= 0
    joins = np.zeros(T, bool)                 # continues the token before it
    joins[1:] = np.where(live[1:], live[:-1] & (rows[1:] == rows[:-1])
                         & (pos[1:] == pos[:-1] + 1), ~live[:-1])
    t = np.arange(T)
    run_start = np.maximum.accumulate(np.where(joins, 0, t))
    first = np.flatnonzero(~joins | live & ((t - run_start) % TILE_TOKENS
                                            == 0))
    count = np.diff(np.append(first, T))
    return np.stack([first, count], axis=1).astype(np.int32)


def plan_tensor(token_rows, token_pos) -> torch.Tensor:
    """:func:`ragged_plan` of device indices, built from host copies (a
    wait on the stream) and uploaded next to them: for calls outside the
    serving tick, which uploads its plan with its other arrays."""
    plan = ragged_plan(token_rows.cpu().numpy(), token_pos.cpu().numpy())
    return torch.from_numpy(plan).to(token_pos.device)


_FNS = {}
_ARGTYPES = {
    "decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         ctypes.c_float, _I, _I, _P],
    "paged_decode_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, ctypes.c_float, _I, _I, _P],
    "ragged_paged_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _I, ctypes.c_float, _I, _I,
                               _P],
}


def _lib(name: str):
    """C entry point ``name`` of ``csrc/decode_attention.cu``, built and
    loaded on first use."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("decode_attention"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
        _FNS[name] = fn
    return fn


def _check(q, k, v, ints, max_g=MAX_G, max_hd=MAX_HD):
    """The checks the three kernels share: same devices, types, q (n, h,
    hd) against K/V (..., kvh, hd) with at most ``max_g`` query heads per
    KV head and hd at most ``max_hd``, int32 index tensors, contiguity (the
    caller checks last that the device is a CUDA one). Returns (n, h, hd,
    kvh)."""
    dev = q.device
    for name, x in (("k", k), ("v", v)) + ints:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q {q.dtype}: the kernel takes float32 or bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k {k.dtype} / v {v.dtype} must match q {q.dtype}")
    for name, x in ints:
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape or \
            k.shape[3] != q.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} must be (n, h, hd) and k, v "
                         f"(..., kvh, hd): k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} disagree")
    n, h, hd = q.shape
    kvh = k.shape[2]
    if h % kvh or h // kvh > max_g or not 0 < hd <= max_hd:
        raise ValueError(f"unsupported h {h} / kvh {kvh} / hd {hd}")
    for name, x in (("q", q), ("k", k), ("v", v)) + ints:
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n, h, hd, kvh


def _require_cuda(dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")


def _stream(dev) -> int:
    """The handle of ``dev``'s current CUDA stream, for a launch."""
    return torch.cuda.current_stream(dev).cuda_stream


def _vec(hd, *xs) -> int:
    """1 when the kernel may take 16-byte loads of ``xs``' rows."""
    return int(hd % 8 == 0 and all(x.data_ptr() % 16 == 0 for x in xs))


def ragged_paged_attention_kernel(q, k_pages, v_pages, block_tables,
                                  token_rows, token_pos, plan=None):
    """Launch the ragged kernel on CUDA tensors (same device, contiguous; q
    and the pages both float32 or both bfloat16; indices int32; hd <=
    ``MAX_HD``; h a multiple of kvh, at most ``MAX_G`` query heads per KV
    head). ``plan``: the
    (n_items, 2) int32 :func:`ragged_plan` of these indices on the device;
    None builds it from host copies of them (:func:`plan_tensor`). Raises
    on anything the kernel does not take; never falls back."""
    ints = (("block_tables", block_tables), ("token_rows", token_rows),
            ("token_pos", token_pos))
    T, h, hd, kvh = _check(q, k_pages, v_pages, ints)
    if block_tables.dim() != 2 or block_tables.shape[1] < 1:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} must be "
                         "(slots, npages >= 1)")
    if token_rows.shape != (T,) or token_pos.shape != (T,):
        raise ValueError("token_rows and token_pos must be (T,)")
    _require_cuda(q.device)
    dev = q.device
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if plan is None:
        plan = plan_tensor(token_rows, token_pos)
    if plan.device != dev or plan.dtype != torch.int32 or plan.dim() != 2 \
            or plan.shape[1] != 2 or not 1 <= plan.shape[0] <= T or \
            not plan.is_contiguous():
        raise ValueError(f"plan {plan.dtype} {tuple(plan.shape)} on "
                         f"{plan.device} must be a contiguous (n_items, 2) "
                         f"int32 tensor on {dev}, 1 <= n_items <= T = {T}")
    bs, npages = k_pages.shape[1], block_tables.shape[1]
    with _on_device(dev):
        err = _lib("ragged_paged_attention")(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), token_rows.data_ptr(),
            token_pos.data_ptr(), plan.data_ptr(), out.data_ptr(), T,
            plan.shape[0], kvh, h // kvh, hd, bs, npages,
            decode_split(npages * bs), 1.0 / math.sqrt(hd),
            int(q.dtype == torch.bfloat16), _vec(hd, k_pages, v_pages),
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA "
                           f"error {err}")
    return out


def decode_attention_kernel(q, k_cache, v_cache, cur_len):
    """Launch the contiguous decode kernel on CUDA tensors: q (b, h, hd),
    caches (b, S, kvh, hd), all contiguous, float32 or bfloat16, hd <=
    ``MAX_HD_CONTIGUOUS``, at most ``MAX_G_CONTIGUOUS`` query heads per KV
    head; cur_len a scalar or (b,), made a (b,) int32 tensor on the device
    here. Raises on anything the kernel does not take; never falls
    back."""
    lens = _lengths(cur_len, q.shape[0], q.device)
    b, h, hd, kvh = _check(q, k_cache, v_cache, (("cur_len", lens),),
                           MAX_G_CONTIGUOUS, MAX_HD_CONTIGUOUS)
    if k_cache.shape[0] != b:
        raise ValueError(f"caches {tuple(k_cache.shape)} hold another batch "
                         f"than q {tuple(q.shape)}")
    _require_cuda(q.device)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with _on_device(q.device):
        err = _lib("decode_attention")(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), out.data_ptr(), b, k_cache.shape[1], kvh,
            h // kvh, hd, decode_split(k_cache.shape[1]), 1.0 / math.sqrt(hd),
            int(q.dtype == torch.bfloat16),
            _vec(hd, k_cache, v_cache), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err}")
    return out


def paged_decode_attention_kernel(q, k_pages, v_pages, block_tables,
                                  cur_len):
    """Launch the paged decode kernel on CUDA tensors: q (b, h, hd), pages
    (num_blocks, block_size, kvh, hd), block_tables (b, npages) and
    cur_len (b,) int32, all contiguous; hd <= ``MAX_HD``, at most
    ``MAX_G`` query heads per KV head. The cluster split is
    ``decode_split(npages * block_size)``. Raises on anything the kernel
    does not take; never falls back."""
    ints = (("block_tables", block_tables), ("cur_len", cur_len))
    b, h, hd, kvh = _check(q, k_pages, v_pages, ints)
    if block_tables.dim() != 2 or block_tables.shape[0] != b or \
            block_tables.shape[1] < 1 or cur_len.shape != (b,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} must be "
                         f"(b, npages >= 1) and cur_len {tuple(cur_len.shape)}"
                         f" (b,) for b = {b}")
    _require_cuda(q.device)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    bs, npages = k_pages.shape[1], block_tables.shape[1]
    with _on_device(q.device):
        err = _lib("paged_decode_attention")(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), cur_len.data_ptr(), out.data_ptr(), b,
            kvh, h // kvh, hd, bs, npages, decode_split(npages * bs),
            1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
            _vec(hd, k_pages, v_pages), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {err}")
    return out
