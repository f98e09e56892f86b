"""Transformer building blocks of the serving path: norm, RoPE, SwiGLU,
attention projections and the plain ragged paged attention.

Counterparts of the functions of the same names in
``repro.models.layers``, with the same tensor layouts: activations
``(b, s, d)``, queries ``(b, s, H, hd)``, weights ``(in, out)`` applied as
``x @ w``. Matmuls run in the compute dtype; norm statistics and softmax in
float32. The port covers what smollm-360m uses: RMSNorm, SwiGLU, RoPE, no
QKV bias, no q/k norm.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import ragged_paged_attention_plain


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

def attn_project_qkv(cfg, p, x, positions, dtype, sincos=None):
    """x: (b, s, d) -> q (b, s, H, hd), k, v (b, s, KV, hd), RoPE applied at
    ``positions`` (or with their precomputed ``sincos``)."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = x.to(dtype)
    q = (x @ p["wq"].to(dtype)).reshape(b, s, h, hd)
    k = (x @ p["wk"].to(dtype)).reshape(b, s, kvh, hd)
    v = (x @ p["wv"].to(dtype)).reshape(b, s, kvh, hd)
    if cfg.pos_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, sincos)
        k = apply_rope(k, positions, cfg.rope_theta, sincos)
    return q, k, v


def attn_output(cfg, p, o, dtype):
    b, s, h, hd = o.shape
    return o.reshape(b, s, h * hd).to(dtype) @ p["wo"].to(dtype)


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
