"""Flash attention for prefill: a whole prompt attending over itself.

Counterpart of ``repro.kernels.flash_attention.flash_attention_kernel``.
q (b, sq, h, hd) attends over k / v (b, skv, kvh, hd) with GQA (query head
``kh * g + i`` reads KV head ``kh``); query row i sits at position ``qpos
= q_offset + i`` and sees kv position ``kpos`` when ``kpos <= qpos``
(``causal``; kv positions count from 0 and queries from ``q_offset``, the
reference's top-left alignment, whatever sq and skv are) and ``kpos > qpos -
window`` (``window > 0``). P-Tuning v2 attends with ``q_offset`` = its
prefix length over ``[prefix | k]``. The CUDA kernel is
``csrc/flash_attention.cu``, in three builds (:data:`BUILDS` counts each
one's launches): bf16 rows in whole 16-byte units run on wgmma with K/V
staged by TMA (``wgmma_m128`` / ``wgmma_m64``: 128 or 64 query positions a
block, :func:`tile_rows`), other bf16 rows on mma.sync with element loads
(``mma``), float32 on the CUDA cores (``simt``). The plain version below is
the reference kernel's masked fp32 softmax in one piece.

Beside it, :func:`attention_chunked`: the reference's blockwise XLA
attention (``repro.models.layers.attention_chunked``), plain PyTorch and
differentiable, where :func:`ops.flash_attention` sends a bidirectional
``prefix_len`` as the reference's wrapper does; no kernel.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import _build
from repro_torch.kernels._build import on_device as _on_device
from repro_torch.kernels.decode_attention import NEG_INF

NEG = -1e30          # the reference kernel's mask value
MAX_G = 96           # query heads per KV head the kernel's tile can hold
MAX_HD = 256         # recurrentgemma's; the bf16 builds take hd 64, 80 (danube,
                     # hubert), 128 and 256 as they are, others padded up

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


def _mask_bias(q_pos, kv_pos, *, causal, window, prefix_len,
               kv_valid_len=None):
    """(q, kv) additive float32 mask: 0 where query position i sees kv
    position j, else ``NEG_INF``. Causal: ``j <= i`` or ``j < prefix_len``
    (a bidirectional prefix: paligemma's patches, P-Tuning v1's prompt);
    a window: ``j > i - window``, and for a non-causal stack also ``j < i +
    window`` (the encoders' symmetric window); ``j < kv_valid_len`` when
    given (a padded tail). The reference's ``_mask_bias``."""
    qp, kp = q_pos[:, None], kv_pos[None, :]
    ok = torch.ones(qp.shape[0], kp.shape[1], dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        c = kp <= qp
        if prefix_len:
            c = c | (kp < prefix_len)
        ok &= c
    if window:
        ok &= kp > qp - window
        if not causal:
            ok &= kp < qp + window
    if kv_valid_len is not None:
        ok &= kp < kv_valid_len
    return torch.where(ok, 0.0, NEG_INF)


def _softcap(s, softcap: float):
    """Scores capped smoothly at +-``softcap``: ``tanh(s / softcap) *
    softcap`` (Gemma 2's); ``s`` itself for 0."""
    return torch.tanh(s / softcap) * softcap if softcap else s


def _sdpa_block(q5, k, v, bias, softcap: float = 0.0):
    """q5: (b, qc, KV, G, hd); k / v: (b, kc, KV, hd); bias: (qc, kc) ->
    (b, qc, KV, G, hd): softmax over the whole block, scores taken in the
    input dtype, capped by ``softcap`` (:func:`_softcap`), softmax in
    float32 (the reference's ``_sdpa_block``)."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q5, k).float() / math.sqrt(
        q5.shape[-1])
    p = torch.softmax(_softcap(s, softcap) + bias, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)


def _scan_step(carry_m, carry_l, acc, q5, kc, vc, bias, softcap=0.0):
    """One kv chunk of the online softmax: the running max ``carry_m``,
    sum ``carry_l`` (b, KV, G, qc) and float32 accumulator ``acc`` (b, KV,
    G, qc, hd) after the chunk ``kc`` / ``vc`` (b, ckv, KV, hd) under
    ``bias`` (qc, ckv), the scores capped by ``softcap``."""
    s = _softcap(torch.einsum("bqkgh,bskh->bkgqs", q5, kc).float()
                 / math.sqrt(q5.shape[-1]), softcap) + bias
    m_new = torch.maximum(carry_m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(carry_m - m_new)
    l_new = carry_l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bkgqs,bskh->bkgqh", p.to(vc.dtype), vc).float()
    return m_new, l_new, acc_new


def _online_chunk_scan(q5, k_r, v_r, q_pos, kv_start, chunk_kv, *, causal,
                       window, prefix_len, kv_valid_len, softcap=0.0):
    """The online-softmax scan over the kv chunks of ``k_r`` / ``v_r`` (b,
    L, KV, hd), L a multiple of ``chunk_kv``, for one q chunk q5 (b, qc,
    KV, G, hd) at positions ``q_pos``; the chunks start at kv position
    ``kv_start``. Under autograd each step runs under
    ``torch.utils.checkpoint``, as the reference's scan body runs under
    ``jax.checkpoint``: only the carries are kept for the backward pass.
    Returns (b, qc, KV, G, hd) in q5's dtype."""
    b, qc, kvh, g, hd = q5.shape
    dev = q5.device
    m = torch.full((b, kvh, g, qc), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, g, qc), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, qc, hd), dtype=torch.float32, device=dev)
    remat = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q5, k_r, v_r))
    for j in range(k_r.shape[1] // chunk_kv):
        lo = j * chunk_kv
        kv_pos = kv_start + lo + torch.arange(chunk_kv, device=dev)
        bias = _mask_bias(q_pos, kv_pos, causal=causal, window=window,
                          prefix_len=prefix_len, kv_valid_len=kv_valid_len)
        args = (m, l, acc, q5, k_r[:, lo:lo + chunk_kv],
                v_r[:, lo:lo + chunk_kv], bias, softcap)
        m, l, acc = (checkpoint(_scan_step, *args, use_reentrant=False)
                     if remat else _scan_step(*args))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q5.dtype)


def attention_chunked(q, k, v, *, causal, window=0, prefix_len=0,
                      chunk_q=1024, chunk_kv=1024, q_offset=0,
                      kv_valid_len=None, softcap=0.0):
    """Blockwise attention with static causal / window block skipping, the
    reference's ``attention_chunked`` (its default ``attn_impl``, and where
    its kernel wrapper sends ``prefix_len``). q: (b, sq, H, hd); k / v:
    (b, skv, KV, hd); the mask is
    :func:`_mask_bias`'s, as in ``layers.attention_ref``.

    A Python loop over q chunks of ``chunk_q`` rows; each touches only the
    kv range its mask admits (causal: up to its last position, or the
    prefix's end if later; a window: from its first position less the
    window, or from 0 under a prefix), aligned down to the kv chunk and
    padded to a whole number of chunks with a tail masked by
    ``kv_valid_len``. A range of at most two kv chunks is one masked block
    (:func:`_sdpa_block`); a longer one runs :func:`_online_chunk_scan`.
    Scores are capped by ``softcap`` (0: none), as the reference's.
    Differentiable."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    dev = q.device
    cq = min(chunk_q, sq)
    outs = []
    for lo_q in range(0, sq, cq):
        hi_q = min(lo_q + cq, sq)
        qc = q[:, lo_q:hi_q].reshape(b, hi_q - lo_q, kvh, g, hd)
        q_pos = q_offset + torch.arange(lo_q, hi_q, device=dev)
        if causal:
            hi_kv = min(skv, q_offset + hi_q)
            if prefix_len:
                hi_kv = max(hi_kv, min(skv, prefix_len))
            lo_kv = 0
            if window and not prefix_len:
                lo_kv = max(0, q_offset + lo_q - window + 1)
        else:
            lo_kv, hi_kv = 0, skv
            if window:
                lo_kv = max(0, q_offset + lo_q - window + 1)
                hi_kv = min(skv, q_offset + hi_q - 1 + window)
        ckv = min(chunk_kv, hi_kv - lo_kv) or 1
        lo_kv = (lo_kv // ckv) * ckv
        n_kv = -(-(hi_kv - lo_kv) // ckv)
        k_r = k[:, lo_kv:min(skv, lo_kv + n_kv * ckv)]
        v_r = v[:, lo_kv:min(skv, lo_kv + n_kv * ckv)]
        pad = n_kv * ckv - k_r.shape[1]
        valid = kv_valid_len
        if pad:         # a whole number of kv chunks; the mask hides the tail
            k_r = F.pad(k_r, (0, 0, 0, 0, 0, pad))
            v_r = F.pad(v_r, (0, 0, 0, 0, 0, pad))
            valid = hi_kv if kv_valid_len is None else kv_valid_len
        if n_kv <= 2:
            kv_pos = lo_kv + torch.arange(k_r.shape[1], device=dev)
            bias = _mask_bias(q_pos, kv_pos, causal=causal, window=window,
                              prefix_len=prefix_len, kv_valid_len=valid)
            o = _sdpa_block(qc, k_r, v_r, bias, softcap)
        else:
            o = _online_chunk_scan(qc, k_r, v_r, q_pos, lo_kv, ckv,
                                   causal=causal, window=window,
                                   prefix_len=prefix_len, kv_valid_len=valid,
                                   softcap=softcap)
        outs.append(o.reshape(b, hi_q - lo_q, h, hd))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


_FNS = {}
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _L, _L, _L, _L, _L, _L, _L, _L, _L,
             _I, _I, _I, ctypes.c_float, _I, _I, _I, _P]

#: launches of the CUDA kernel by build since the module was loaded (never
#: reset: a run reads the difference): ``wgmma_m128`` / ``wgmma_m64`` (bf16
#: through TMA and wgmma, 128 or 64 query positions a block), ``mma`` (bf16
#: with element loads, mma.sync), ``simt`` (float32)
BUILDS: collections.Counter = collections.Counter()
_SMS = {}


def _lib():
    """The kernel's C entry point, built and loaded on first use."""
    fn = _FNS.get("flash_attention")
    if fn is None:
        fn = _build.load("flash_attention").flash_attention
        fn.argtypes = _ARGTYPES
        fn.restype = _I
        _FNS["flash_attention"] = fn
    return fn


def _vec(hd, *xs) -> int:
    """1 when the bf16 kernel may read ``xs``' rows by TMA (the wgmma
    build): hd, every pointer and every batch, sequence and head stride in
    whole 16-byte units (8 bf16 elements) and not 0 (a broadcast dimension
    is no tensor map's; a dimension of size 1 is never stepped, so its
    stride does not count)."""
    return int(hd % 8 == 0 and all(
        x.data_ptr() % 16 == 0 and all(
            (st % 8 == 0 and st > 0) or n == 1
            for st, n in zip(x.stride()[:3], x.shape[:3]))
        for x in xs))


def tile_rows(b, sq, h, hd, sms) -> int:
    """Query positions a work item of the bf16 TMA build takes: 128 (two
    consumer warpgroups sharing each K/V tile) when 128-row tiles still
    give each of the card's ``sms`` SMs an item, else 64, twice the items
    (one prompt of 512 at 15 heads: 120, not 60); always 64 at hd > 128,
    where a warpgroup's output accumulator leaves no registers for a
    second."""
    if hd > 128:
        return 64
    return 128 if -(-sq // 128) * h * b >= sms else 64


def build_name(bf16: bool, vec: int, rows: int) -> str:
    """The :data:`BUILDS` key of a launch."""
    if not bf16:
        return "simt"
    return f"wgmma_m{rows}" if vec else "mma"


def _sms(dev) -> int:
    n = _SMS.get(dev.index)
    if n is None:
        n = _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def flash_attention_kernel(q, k, v, *, causal=True, window=0, sm_scale=None,
                           q_offset=0):
    """Launch the CUDA kernel on CUDA tensors (same device; q, k and v all
    float32 or all bfloat16, each with a unit channel stride, any other
    strides; h a multiple of kvh with at most 96 query heads per KV head;
    hd <= ``MAX_HD``). Raises on anything the kernel does not take; never
    falls back."""
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
    if h % kvh or h // kvh > MAX_G or not 0 < hd <= MAX_HD:
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
    bf16 = q.dtype == torch.bfloat16
    vec = _vec(hd, q, k, v) if bf16 else 0
    with _on_device(dev):
        rows = tile_rows(b, sq, h, hd, _sms(dev)) if vec else 64
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b, sq, skv, h, kvh, hd, *q.stride()[:3],
                     *k.stride()[:3], *v.stride()[:3], int(causal),
                     int(window), int(q_offset), scale, int(bf16), vec, rows,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    BUILDS[build_name(bf16, vec, rows)] += 1
    return out
