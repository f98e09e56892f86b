"""Transformer building blocks: norms, RoPE, the MLPs, attention
projections, and the reference's XLA attention paths (whole sequence,
contiguous decode, paged decode, ragged paged; the blockwise chunked one
lives beside the flash kernel's plain version and is re-exported here).

Counterparts of the functions of the same names in
``repro.models.layers``, with the same tensor layouts: activations
``(b, s, d)``, queries ``(b, s, H, hd)``, weights ``(in, out)`` applied as
``x @ w``. Matmuls run in the compute dtype; norm statistics and softmax in
float32. The port covers what its decoders and the paper's encoders use:
RMSNorm, LayerNorm and the non-parametric norm, SwiGLU, GeGLU and the GELU
MLP, RoPE, the QKV bias, qwen3's per-head q/k RMSNorm, and the attention
softcap on every XLA attention path (``tanh(s / softcap) * softcap``).
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from repro_torch.distrib.sharding import (constrain, matmul, reshape_tail,
                                          split_last)
from repro_torch.kernels.aot_bias import rms_norm_plain
from repro_torch.kernels.decode_attention import (
    NEG_INF, ragged_paged_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: F401 (re-exported)
    _mask_bias, _online_chunk_scan, _sdpa_block, _softcap, attention_chunked)


# the name being tagged by checkpoint_name, read in the same thread by the
# selective remat policy (models.model.remat_policy)
_TAG = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Tag the ops run inside with ``name``: a selective remat policy keeps
    their outputs when ``name`` is among ``ModelOptions.remat_save_names``,
    and the backward's recompute does not run them again. The reference
    tags a value (``jax.ad_checkpoint.checkpoint_name``) and XLA drops
    what only fed it; an eager recompute runs every op before a saved one
    all the same, so the port tags the ops that make the value."""
    prev = tagged()
    _TAG.name = name
    try:
        yield
    finally:
        _TAG.name = prev


def tagged():
    """The name :func:`checkpoint_name` is tagging now, or None."""
    return getattr(_TAG, "name", None)


def _trunc_normal(shape, std, generator, device, dtype):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


def dense_init(shape, generator, device, dtype=torch.float32, scale=None):
    """Truncated normal in [-2, 2] standard deviations, std ``scale``
    (default 1/sqrt(fan_in)), as the reference draws dense weights."""
    std = 1.0 / math.sqrt(shape[0]) if scale is None else scale
    return _trunc_normal(shape, std, generator, device, dtype)


def dense_init_sliced(shape, generator, device, dtype=torch.float32):
    """:func:`dense_init` of a stacked leaf ``(n, fan_in, ...)`` with the
    reference's std ``1/sqrt(shape[0])`` (fan-in read on the stacking
    axis, as its ``dense_init`` reads a MoE expert leaf), drawn one
    ``shape[1:]`` slice at a time into a tensor of ``dtype``: no float32
    copy of the whole leaf exists (a llama4 expert leaf is 5.4 G
    values)."""
    std = 1.0 / math.sqrt(shape[0])
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:             # nothing to draw into
        return out
    for i in range(shape[0]):
        out[i] = _trunc_normal(shape[1:], std, generator, device, dtype)
    return out


def embed_init(shape, generator, device, dtype=torch.float32):
    """Truncated normal, std 0.02, as the reference draws embeddings."""
    return _trunc_normal(shape, 0.02, generator, device, dtype)


# ---------------------------------------------------------------------------
# norm, rope, mlp
# ---------------------------------------------------------------------------

def norm_init(cfg, device, d=None):
    """A norm's parameters, float32: ``{"scale"}`` for RMSNorm, ``{"scale",
    "bias"}`` for LayerNorm (ones and zeros), none for the non-parametric
    norm."""
    d = d or cfg.d_model
    ones = lambda: torch.ones(d, dtype=torch.float32, device=device)
    if cfg.norm_type == "rmsnorm":
        return {"scale": ones()}
    if cfg.norm_type == "layernorm":
        return {"scale": ones(),
                "bias": torch.zeros(d, dtype=torch.float32, device=device)}
    if cfg.norm_type == "nonparametric":
        return {}
    raise ValueError(cfg.norm_type)


def apply_norm(cfg, p, x):
    """The config's norm in float32, result in x's dtype. RMSNorm is
    ``aot_bias.rms_norm_plain`` (the arithmetic the fused gather-add + norm
    kernel follows); LayerNorm and the non-parametric norm are the
    reference's ``apply_norm``: mean, biased variance, ``(x - mean) *
    rsqrt(var + eps)``, then ``* scale + bias`` when ``p`` holds them."""
    if cfg.norm_type == "rmsnorm":
        return rms_norm_plain(x, p["scale"], cfg.norm_eps)
    if cfg.norm_type not in ("layernorm", "nonparametric"):
        raise ValueError(cfg.norm_type)
    x32 = x.float()
    xc = x32 - x32.mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(xc.square().mean(dim=-1, keepdim=True)
                         + cfg.norm_eps)
    if p:
        y = y * p["scale"] + p["bias"]
    return y.to(x.dtype)


def rms_head_norm(scale, x, eps=1e-6):
    """qwen3's per-head RMSNorm of q or k over the last axis (head_dim):
    float32 statistics, ``x * rsqrt(mean(x^2) + eps) * scale``, the result
    in x's dtype, as the reference's ``rms_head_norm`` (eps fixed at its
    default, not the config's)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


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


def mlp_init(cfg, generator, device, dtype=torch.float32):
    """The MLP's parameters, drawn as the reference's ``mlp_init`` draws
    them: SwiGLU and GeGLU ``wg``, ``wu`` (d, f), ``wd`` (f, d); the GELU
    MLP ``w1`` (d, f), ``w2`` (f, d) and zero biases ``b1`` (f,), ``b2``
    (d,)."""
    d, f = cfg.d_model, cfg.d_ff
    dense = lambda *shape: dense_init(shape, generator, device, dtype)
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {"wg": dense(d, f), "wu": dense(d, f), "wd": dense(f, d)}
    if cfg.mlp_type == "gelu":
        return {"w1": dense(d, f),
                "b1": torch.zeros(f, dtype=dtype, device=device),
                "w2": dense(f, d),
                "b2": torch.zeros(d, dtype=dtype, device=device)}
    raise NotImplementedError(f"mlp {cfg.mlp_type!r} is not ported")


def apply_mlp(cfg, p, x, dtype):
    """SwiGLU: ``(silu(x wg) * (x wu)) wd``; GeGLU: the same with
    ``gelu`` for ``silu``; the GELU MLP (BERT's, with biases): ``gelu(x w1
    + b1) w2 + b2``. Every GELU is the tanh one (``jax.nn.gelu``'s
    default)."""
    x = x.to(dtype)
    if cfg.mlp_type in ("swiglu", "geglu"):
        g = constrain(matmul(x, p["wg"].to(dtype)), "batch", "seq", "mlp")
        u = constrain(matmul(x, p["wu"].to(dtype)), "batch", "seq", "mlp")
        act = F.silu(g) if cfg.mlp_type == "swiglu" else F.gelu(
            g, approximate="tanh")
        return constrain(matmul(act * u, p["wd"].to(dtype)), "batch", "seq",
                         "embed")
    if cfg.mlp_type == "gelu":
        z = constrain(matmul(x, p["w1"].to(dtype)) + p["b1"].to(dtype),
                      "batch", "seq", "mlp")
        z = F.gelu(z, approximate="tanh")
        return constrain(matmul(z, p["w2"].to(dtype)) + p["b2"].to(dtype),
                         "batch", "seq", "embed")
    raise NotImplementedError(f"mlp {cfg.mlp_type!r} is not ported")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_init(cfg, generator, device, dtype=torch.float32):
    """The attention's parameters: ``wq`` (d, H hd), ``wk`` / ``wv`` (d, KV
    hd), ``wo`` (H hd, d) drawn as :func:`dense_init`, with the config's
    ``qkv_bias`` the float32 zero biases ``bq``, ``bk``, ``bv``, and with
    its ``qk_norm`` the float32 scales ``q_norm``, ``k_norm`` (hd,) of
    ones, as the reference's ``attn_init``."""
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    dense = lambda *shape: dense_init(shape, generator, device, dtype)
    p = {"wq": dense(d, h * hd), "wk": dense(d, kvh * hd),
         "wv": dense(d, kvh * hd), "wo": dense(h * hd, d)}
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kvh * hd),
                            ("bv", kvh * hd)):
            p[name] = torch.zeros(width, dtype=torch.float32, device=device)
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = torch.ones(hd, dtype=torch.float32, device=device)
    return p


def attn_project_qkv(cfg, p, x, positions, dtype, sincos=None,
                     peft_qkv=None):
    """x: (b, s, d) -> q (b, s, H, hd), k, v (b, s, KV, hd), RoPE applied at
    ``positions`` (or with their precomputed ``sincos``). The config's QKV
    bias is added to the projections first, then ``peft_qkv``: (dq, dk,
    dv) deltas, each None or (b, s, width) (LoRA's), both before the
    reshape; then the config's q/k norm per head (:func:`rms_head_norm`),
    then RoPE."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = x.to(dtype)
    q, k, v = (matmul(x, p[w].to(dtype)) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = (y + p[b_].to(dtype)
                   for y, b_ in zip((q, k, v), ("bq", "bk", "bv")))
    if peft_qkv is not None:
        q, k, v = (y if dy is None else y + dy.to(dtype)
                   for y, dy in zip((q, k, v), peft_qkv))
    q = split_last(q, h, hd)
    k = split_last(k, kvh, hd)
    v = split_last(v, kvh, hd)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    if cfg.pos_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, sincos)
        k = apply_rope(k, positions, cfg.rope_theta, sincos)
    return (constrain(q, "batch", "seq", "heads", "head_dim"),
            constrain(k, "batch", "seq", "kv_heads", "head_dim"),
            constrain(v, "batch", "seq", "kv_heads", "head_dim"))


def attn_output(cfg, p, o, dtype, peft_bias=None):
    """o: (b, s, H, hd) -> (b, s, d); ``peft_bias`` (d,) is added after the
    output projection (BitFit's)."""
    b, s, h, hd = o.shape
    out = matmul(reshape_tail(o, 2, h * hd).to(dtype), p["wo"].to(dtype))
    if peft_bias is not None:
        out = out + peft_bias.to(dtype)
    return constrain(out, "batch", "seq", "embed")


def attention_ref(q, k, v, *, causal, window=0, q_offset=0, prefix_len=0,
                  softcap=0.0):
    """Oracle attention, differentiable (the training path's). q: (b, sq,
    H, hd); k / v: (b, skv, KV, hd); query row r sits at position
    ``q_offset + r`` and sees the kv positions :func:`_mask_bias` admits.
    Scores in the input dtype, capped by ``softcap``, softmax in float32,
    as the reference."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    bias = _mask_bias(q_offset + torch.arange(sq, device=q.device),
                      torch.arange(skv, device=q.device), causal=causal,
                      window=window, prefix_len=prefix_len)
    o = _sdpa_block(reshape_tail(q, 2, kvh, h // kvh, hd), k, v, bias,
                    softcap)
    return reshape_tail(o, 2, h, hd)


def attention_decode(q, k_cache, v_cache, cur_len, *, window=0, softcap=0.0):
    """Single-token decode attention against a contiguous cache.

    q: (b, 1, H, hd); caches: (b, S, KV, hd); cur_len: scalar — the number
    of valid positions, the new token's KV already written at cur_len - 1
    — or a per-row (b,) vector. A row with cur_len 0 sees nothing and, as
    in the reference, averages the whole cache."""
    b, _, h, hd = q.shape
    S, kvh = k_cache.shape[1], k_cache.shape[2]
    q5 = reshape_tail(q, 2, kvh, h // kvh, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", q5, k_cache).float() / math.sqrt(hd)
    s = _softcap(s, softcap)
    pos = torch.arange(S, device=q.device)
    cl = torch.as_tensor(cur_len, device=q.device).expand(b)
    ok = pos[None, :] < cl[:, None]
    if window:
        ok &= pos[None, :] > (cl - 1 - window)[:, None]
    mask = ok[:, None, None, None, :]
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    # positions past cur_len contribute exact zeros even where V holds NaN
    # (a row with cur_len 0 still averages the whole cache)
    read = ok | (cl <= 0)[:, None]
    v = torch.where(read[:, :, None, None], v_cache, 0.0)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return reshape_tail(out, 2, h, hd)


def paged_attention_decode(q, k_pages, v_pages, block_tables, cur_len, *,
                           softcap=0.0):
    """Single-token decode attention against a paged KV pool.

    q: (b, 1, H, hd); pages: (num_blocks, block_size, KV, hd);
    block_tables: (b, npages) (unmapped entries point at page 0 and sit past
    cur_len); cur_len: (b,). Gathers each row's pages contiguous, then
    :func:`attention_decode` (scores capped by ``softcap``)."""
    b = q.shape[0]
    kvh, hd = k_pages.shape[2], k_pages.shape[3]
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, -1, kvh, hd)
    v = v_pages[bt].reshape(b, -1, kvh, hd)
    return attention_decode(q, k, v, cur_len, softcap=softcap)


def ragged_paged_attention_decode(q, k_pages, v_pages, block_tables,
                                  token_rows, token_pos, *, softcap=0.0):
    """The plain packed ragged attention in the reference's layout.

    q: (T, 1, H, hd) — the tick's packed tokens; k_pages / v_pages:
    (num_blocks, block_size, KV, hd) with the step's KV already written;
    block_tables: (num_slots, npages); token_rows / token_pos: (T,) — each
    token's slot and absolute position (-1 = dead token, output zeros).
    With ``softcap`` the reference's own walk: each token's slot pages
    gathered, :func:`attention_decode` with ``token_pos + 1`` visible
    positions and capped scores, dead rows zeroed.
    """
    if softcap:
        bt = block_tables.long()[token_rows.long()]
        out = paged_attention_decode(q, k_pages, v_pages, bt,
                                     token_pos.long() + 1, softcap=softcap)
        return torch.where((token_pos >= 0)[:, None, None, None], out, 0.0)
    return ragged_paged_attention_plain(q[:, 0], k_pages, v_pages,
                                        block_tables, token_rows,
                                        token_pos)[:, None]
