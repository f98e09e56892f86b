"""Griffin / RecurrentGemma's recurrent block: a depthwise causal conv and
the RG-LRU gated linear recurrence ``h_t = a_t h_{t-1} + b_t``.

Counterparts of the functions of the same names in
``repro.models.recurrent``, with the same layouts: activations ``(b, s,
d)``, the recurrence's width ``w = lru_width or d_model``, gates per head
from block-diagonal ``(H, w / H, w / H)`` projections, the gates, ``a`` and
the state in float32. The reference computes this block in XLA, outside any
Pallas kernel, and so does the port: plain PyTorch, differentiable (the
training path runs it under autograd).

Whole sequences scan the recurrence as the reference's
``jax.lax.associative_scan`` does, in log depth: :func:`rglru_scan` takes
``ceil(log2 s)`` doubling rounds (Hillis-Steele), each a few elementwise
launches over the whole (b, s, w) tensor, instead of one step per token.
Its products come in another order than JAX's tree, so it agrees with the
reference to float32 rounding, not bit for bit. A decode step (one token
with a cache) is the single update ``a h + b``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distrib.sharding import constrain, matmul
from repro_torch.models.layers import dense_init

_C_MAX = 8.0   # RG-LRU gate exponent scale (Griffin's c)


def rglru_init(cfg, generator, device, dtype=torch.float32):
    """The block's parameters, drawn as the reference's ``rglru_init``
    draws them: ``in_x`` / ``in_gate`` (d, w), ``conv_w`` (K, w) with std
    1/sqrt(K), the per-head gates ``gate_r`` / ``gate_i`` (H, w/H, w/H)
    (std 1/sqrt(H): the reference reads fan-in on the first axis), ``out``
    (w, d), zero biases, and ``lam`` (w,), float32, set so that
    ``sigmoid(lam) ** 8`` is uniform in [0.9, 0.999]."""
    d = cfg.d_model
    w = cfg.lru_width or d
    H = cfg.num_heads
    blk = w // H
    dense = lambda *shape, **kw: dense_init(shape, generator, device, dtype,
                                            **kw)
    zeros = lambda: torch.zeros(w, dtype=dtype, device=device)
    u = torch.empty(w, dtype=torch.float32, device=device).uniform_(
        0.9 ** (1 / _C_MAX), 0.999 ** (1 / _C_MAX), generator=generator)
    return {"in_x": dense(d, w), "in_gate": dense(d, w),
            "conv_w": dense(cfg.conv_width, w,
                            scale=1.0 / math.sqrt(cfg.conv_width)),
            "conv_b": zeros(),
            "gate_r": dense(H, blk, blk), "gate_i": dense(H, blk, blk),
            "gate_rb": zeros(), "gate_ib": zeros(),
            "lam": torch.log(u) - torch.log1p(-u),
            "out": dense(w, d)}


def _conv1d_causal(w, b, x, state: Optional[torch.Tensor]):
    """Depthwise causal conv of width K over x (b, s, w) in x's dtype, the
    (b, K-1, w) ``state`` (the inputs before x; None: zeros) in front.
    Returns (y, new_state): new_state holds the last K-1 inputs."""
    K = w.shape[0]
    if state is None:
        pad = x.new_zeros(x.shape[:1] + (K - 1,) + x.shape[2:])
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], 1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(K))
    y = y + b.to(x.dtype)
    return y, (xp[:, -(K - 1):] if K > 1 else None)


def _block_linear(wt, bias, x, H):
    """Per-head block-diagonal linear: x (b, s, w) @ wt (H, blk, blk)."""
    b, s, w = x.shape
    xh = x.reshape(b, s, H, w // H)
    y = torch.einsum("bshi,hij->bshj", xh, wt.to(x.dtype))
    return y.reshape(b, s, w) + bias.to(x.dtype)


def _gates(p, xc, H):
    """(a, the gated input's multiplier), both (b, s, w) float32, from the
    conv output xc: ``a = exp(-8 r softplus(-lam))`` and ``sqrt(1 - a^2)``
    (clamped at 1e-12) times the input gate i (Griffin's eq. 5)."""
    r = torch.sigmoid(_block_linear(p["gate_r"], p["gate_rb"], xc,
                                    H).float())
    i = torch.sigmoid(_block_linear(p["gate_i"], p["gate_ib"], xc,
                                    H).float())
    log_a = -_C_MAX * r * F.softplus(-p["lam"].float())
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * i


def rglru_scan(a, bterm, h0: Optional[torch.Tensor] = None):
    """``h_t = a_t h_{t-1} + b_t`` over axis 1 of a / bterm (b, s, w)
    float32, h0 (b, w) folded into step 0. Log depth: round k combines each
    position with the one 2^k before it, ``(A, B)[t] <- (A[t - 2^k] A[t],
    A[t] B[t - 2^k] + B[t])``, the reference's associative operator."""
    if h0 is not None:
        bterm = torch.cat([(bterm[:, 0] + a[:, 0] * h0)[:, None],
                           bterm[:, 1:]], 1)
    A, B = a, bterm
    s, k = a.shape[1], 1
    while k < s:
        B = torch.cat([B[:, :k], A[:, k:] * B[:, :-k] + B[:, k:]], 1)
        A = torch.cat([A[:, :k], A[:, k:] * A[:, :-k]], 1)
        k *= 2
    return B


def apply_rglru(cfg, p, x, dtype, cache: Optional[dict] = None):
    """Griffin's recurrent temporal-mixing sublayer on the normed x (b, s,
    d): the GELU gate branch, the conv and RG-LRU branch, their product
    projected back. ``cache``: {"conv": (b, K-1, w), "h": (b, w)} or None.
    With a cache and one token, the single step from ``cache["h"]``; else
    the scan from it (or from zeros). Returns (out (b, s, d), new cache),
    the new state stored in ``dtype`` as the reference stores it."""
    H = cfg.num_heads
    xin = x.to(dtype)
    gate = F.gelu(matmul(xin, p["in_gate"].to(dtype)), approximate="tanh")
    xr = matmul(xin, p["in_x"].to(dtype))
    xr = constrain(xr, "batch", "seq", "lru")
    gate = constrain(gate, "batch", "seq", "lru")
    xc, conv_state = _conv1d_causal(p["conv_w"], p["conv_b"], xr,
                                    cache["conv"] if cache else None)
    a, imult = _gates(p, xc, H)
    bterm = imult * xc.float()
    if cache is not None and x.shape[1] == 1:
        h = a[:, 0] * cache["h"].float() + bterm[:, 0]
        hs = h[:, None]
    else:
        h0 = cache["h"].float() if cache else None
        hs = rglru_scan(a, bterm, h0)
    y = hs.to(dtype) * gate
    out = constrain(matmul(y, p["out"].to(dtype)), "batch", "seq", "embed")
    return out, {"conv": conv_state, "h": hs[:, -1].to(dtype)}


def rglru_init_cache(cfg, batch: int, dtype, device):
    """Zero conv inputs (b, K-1, w) and state (b, w), in ``dtype``."""
    w = cfg.lru_width or cfg.d_model
    return {"conv": torch.zeros(batch, cfg.conv_width - 1, w, dtype=dtype,
                                device=device),
            "h": torch.zeros(batch, w, dtype=dtype, device=device)}
