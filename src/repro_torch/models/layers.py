"""Transformer building blocks of the serving path: norm, RoPE, SwiGLU,
attention projections, and the reference's XLA attention paths (whole
sequence, contiguous decode, paged decode, ragged paged).

Counterparts of the functions of the same names in
``repro.models.layers``, with the same tensor layouts: activations
``(b, s, d)``, queries ``(b, s, H, hd)``, weights ``(in, out)`` applied as
``x @ w``. Matmuls run in the compute dtype; norm statistics and softmax in
float32. The port covers what smollm-360m uses: RMSNorm, SwiGLU, RoPE, no
QKV bias, no q/k norm, no softcap, no bidirectional prefix.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import (
    NEG_INF, ragged_paged_attention_plain)


def _trunc_normal(shape, std, generator, device, dtype):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


def dense_init(shape, generator, device, dtype=torch.float32):
    """Truncated normal in [-2, 2] standard deviations, std 1/sqrt(fan_in),
    as the reference draws dense weights."""
    return _trunc_normal(shape, 1.0 / math.sqrt(shape[0]), generator, device,
                         dtype)


def embed_init(shape, generator, device, dtype=torch.float32):
    """Truncated normal, std 0.02, as the reference draws embeddings."""
    return _trunc_normal(shape, 0.02, generator, device, dtype)


# ---------------------------------------------------------------------------
# norm, rope, mlp
# ---------------------------------------------------------------------------

def apply_norm(cfg, p, x):
    """RMSNorm in float32, result in x's dtype."""
    if cfg.norm_type != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm_type!r} is not ported")
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + cfg.norm_eps) * p["scale"]).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def rope_sincos(positions, head_dim: int, theta: float):
    """sin and cos of the RoPE angles of ``positions`` ((b, s) or (s,)),
    each (b or 1, s, 1, head_dim / 2) float32, ready for
    :func:`apply_rope`; a serving tick computes them once for all layers."""
    inv = rope_freqs(head_dim, theta, positions.device)    # (hd/2,)
    ang = positions.float()[..., None] * inv               # (..., s, hd/2)
    if ang.dim() == 2:                                     # (s, hd/2)
        ang = ang[None]
    return torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]


def apply_rope(x, positions, theta: float, sincos=None):
    """x: (b, s, h, hd); positions: (b, s) or (s,) int, or their
    precomputed ``sincos``."""
    if sincos is None:
        sincos = rope_sincos(positions, x.shape[-1], theta)
    sin, cos = sincos
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mlp(cfg, p, x, dtype):
    """SwiGLU: (silu(x wg) * (x wu)) wd."""
    if cfg.mlp_type != "swiglu":
        raise NotImplementedError(f"mlp {cfg.mlp_type!r} is not ported")
    x = x.to(dtype)
    g = x @ p["wg"].to(dtype)
    u = x @ p["wu"].to(dtype)
    return (F.silu(g) * u) @ p["wd"].to(dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_project_qkv(cfg, p, x, positions, dtype, sincos=None,
                     peft_qkv=None):
    """x: (b, s, d) -> q (b, s, H, hd), k, v (b, s, KV, hd), RoPE applied at
    ``positions`` (or with their precomputed ``sincos``). ``peft_qkv``:
    (dq, dk, dv) deltas, each None or (b, s, width), added to the
    projections before the reshape and RoPE (LoRA's)."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = x.to(dtype)
    q, k, v = (x @ p[w].to(dtype) for w in ("wq", "wk", "wv"))
    if peft_qkv is not None:
        q, k, v = (y if dy is None else y + dy.to(dtype)
                   for y, dy in zip((q, k, v), peft_qkv))
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    if cfg.pos_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, sincos)
        k = apply_rope(k, positions, cfg.rope_theta, sincos)
    return q, k, v


def attn_output(cfg, p, o, dtype, peft_bias=None):
    """o: (b, s, H, hd) -> (b, s, d); ``peft_bias`` (d,) is added after the
    output projection (BitFit's)."""
    b, s, h, hd = o.shape
    out = o.reshape(b, s, h * hd).to(dtype) @ p["wo"].to(dtype)
    if peft_bias is not None:
        out = out + peft_bias.to(dtype)
    return out


def attention_ref(q, k, v, *, causal, window=0, q_offset=0):
    """Oracle attention. q: (b, sq, H, hd); k / v: (b, skv, KV, hd); query
    row r sits at position ``i = q_offset + r`` and sees kv position j when
    ``j <= i`` (``causal``) and ``j > i - window`` (``window > 0``, causal
    only: the reference's symmetric encoder window is not ported). Scores
    in the input dtype, softmax in float32, as the reference."""
    if window and not causal:
        raise NotImplementedError("a window without causality is not ported")
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    q5 = q.reshape(b, sq, kvh, h // kvh, hd)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    s = torch.einsum("bqkgh,bskh->bkgqs", q5, k).float() / math.sqrt(hd)
    p = torch.softmax(s + torch.where(ok, 0.0, NEG_INF), dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return o.reshape(b, sq, h, hd)


def attention_decode(q, k_cache, v_cache, cur_len, *, window=0):
    """Single-token decode attention against a contiguous cache.

    q: (b, 1, H, hd); caches: (b, S, KV, hd); cur_len: scalar — the number
    of valid positions, the new token's KV already written at cur_len - 1
    — or a per-row (b,) vector. A row with cur_len 0 sees nothing and, as
    in the reference, averages the whole cache."""
    b, _, h, hd = q.shape
    S, kvh = k_cache.shape[1], k_cache.shape[2]
    q5 = q.reshape(b, 1, kvh, h // kvh, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", q5, k_cache).float() / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    cl = torch.as_tensor(cur_len, device=q.device).expand(b)
    ok = pos[None, :] < cl[:, None]
    if window:
        ok &= pos[None, :] > (cl - 1 - window)[:, None]
    mask = ok[:, None, None, None, :]
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, hd)


def paged_attention_decode(q, k_pages, v_pages, block_tables, cur_len):
    """Single-token decode attention against a paged KV pool.

    q: (b, 1, H, hd); pages: (num_blocks, block_size, KV, hd);
    block_tables: (b, npages) (unmapped entries point at page 0 and sit past
    cur_len); cur_len: (b,). Gathers each row's pages contiguous, then
    :func:`attention_decode`."""
    b = q.shape[0]
    kvh, hd = k_pages.shape[2], k_pages.shape[3]
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, -1, kvh, hd)
    v = v_pages[bt].reshape(b, -1, kvh, hd)
    return attention_decode(q, k, v, cur_len)


def ragged_paged_attention_decode(q, k_pages, v_pages, block_tables,
                                  token_rows, token_pos):
    """The plain packed ragged attention in the reference's layout.

    q: (T, 1, H, hd) — the tick's packed tokens; k_pages / v_pages:
    (num_blocks, block_size, KV, hd) with the step's KV already written;
    block_tables: (num_slots, npages); token_rows / token_pos: (T,) — each
    token's slot and absolute position (-1 = dead token, output zeros).
    """
    return ragged_paged_attention_plain(q[:, 0], k_pages, v_pages,
                                        block_tables, token_rows,
                                        token_pos)[:, None]
