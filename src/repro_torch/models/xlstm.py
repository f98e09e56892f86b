"""xLSTM's blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Counterparts of the functions of the same names in ``repro.models.xlstm``,
with the same layouts and casts: gates, stabilizers and states in float32,
values cast to the compute dtype where the reference casts them. The
reference computes these blocks in XLA, outside any Pallas kernel, and so
does the port: plain PyTorch, differentiable.

mLSTM runs whole sequences chunkwise (:func:`mlstm_chunkwise`: an
attention-like product inside each chunk of ``ModelOptions.mlstm_chunk``
positions, the (hd, hd) state carried between chunks by a Python loop,
with the xLSTM paper's log-space stabilizer m); a decode step is the
recurrent update (:func:`mlstm_recurrent`, also the tests' oracle). sLSTM's
gates read h_{t-1}, so its recurrence runs one step per token in a Python
loop (:func:`_slstm_scan`), as the reference's ``lax.scan`` does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distrib.sharding import (by_rows, constrain, matmul,
                                          pointwise, split_last)
from repro_torch.models.layers import dense_init
from repro_torch.models.recurrent import _conv1d_causal

NEG = -1e30     # the stabilizer m's start


# ---------------------------------------------------------------------------
# mLSTM core
# ---------------------------------------------------------------------------

def _mlstm_state(b, H, hd, device):
    """A fresh state: C (b, H, hd, hd), n (b, H, hd) zeros, m (b, H) at
    ``NEG``, float32."""
    f32 = torch.float32
    return (torch.zeros(b, H, hd, hd, dtype=f32, device=device),
            torch.zeros(b, H, hd, dtype=f32, device=device),
            torch.full((b, H), NEG, dtype=f32, device=device))


def _mlstm_chunk(q, k, v, i_log, f_log, state):
    """One chunk of the stabilized chunkwise mLSTM, one head per batch row.
    q, k, v: (b, C, hd); i_log, f_log: (b, C); state = (C (b, hd, hd), n
    (b, hd), m (b,)). Returns (h (b, C, hd), new state)."""
    Cm, n, m = state
    C, hd = q.shape[1], q.shape[2]
    scale = 1.0 / math.sqrt(hd)
    b_cum = torch.cumsum(f_log, 1)                       # (b, C) inclusive
    Ftot = b_cum[:, -1]
    # intra-chunk weights w_ij = b_i - b_j + i_log_j (j <= i)
    w = b_cum[:, :, None] - b_cum[:, None, :] + i_log[:, None, :]
    tri = torch.tril(torch.ones(C, C, dtype=torch.bool, device=q.device))
    w = torch.where(tri[None], w, torch.full_like(w, NEG))
    inter_w = b_cum + m[:, None]                         # (b, C)
    m_i = torch.maximum(w.amax(2), inter_w)
    m_i = torch.clamp(m_i, min=NEG)                      # keep finite
    D = torch.exp(w - m_i[:, :, None])
    S = torch.einsum("bih,bjh->bij", q, k) * scale * D
    inter_scale = torch.exp(inter_w - m_i)
    num = torch.einsum("bij,bjh->bih", S, v) + \
        torch.einsum("bih,bhg->big", q, Cm) * scale * inter_scale[:, :, None]
    den = S.sum(2) + torch.einsum("bih,bh->bi", q, n) * scale * inter_scale
    h = num / torch.maximum(den.abs(), torch.exp(-m_i))[:, :, None]
    # the state after the chunk
    up_w = i_log + (Ftot[:, None] - b_cum)               # i_j + sum_{k>j} f_k
    m_new = torch.maximum(Ftot + m, up_w.amax(1))
    decay = torch.exp(Ftot + m - m_new)
    up = torch.exp(up_w - m_new[:, None])
    Cm_new = decay[:, None, None] * Cm + torch.einsum("bj,bjh,bjg->bhg", up,
                                                      k, v)
    n_new = decay[:, None] * n + torch.einsum("bj,bjh->bh", up, k)
    return h, (Cm_new, n_new, m_new)


def mlstm_chunkwise(q, k, v, i_raw, f_raw, state=None, chunk: int = 64):
    """Multi-head chunkwise mLSTM. q, k, v: (b, s, H, hd); i_raw / f_raw:
    (b, s, H). Chunks of ``min(chunk, s)`` positions, or one chunk of s
    where that does not divide s (the reference's rule). Returns (h (b, s,
    H, hd) float32, state (C (b, H, hd, hd), n (b, H, hd), m (b, H)))."""
    b, s, H, hd = q.shape
    f_log = pointwise(F.logsigmoid, f_raw.float())
    i_log = i_raw.float()
    if state is None:
        state = _mlstm_state(b, H, hd, q.device)

    def fold(x):            # (b, s, H, ...) -> (b H, s, ...)
        return x.movedim(2, 1).reshape((b * H, s) + x.shape[3:])
    qf, kf, vf = (fold(x.float()) for x in (q, k, v))
    ilf, flf = fold(i_log), fold(f_log)
    st = (state[0].reshape(b * H, hd, hd), state[1].reshape(b * H, hd),
          state[2].reshape(b * H))
    C = min(chunk, s)
    if s % C:
        C = s
    hs = []
    for c0 in range(0, s, C):
        sl = slice(c0, c0 + C)
        h, st = _mlstm_chunk(qf[:, sl], kf[:, sl], vf[:, sl], ilf[:, sl],
                             flf[:, sl], st)
        hs.append(h)
    h = torch.cat(hs, 1).reshape(b, H, s, hd).movedim(1, 2)
    return h, (st[0].reshape(b, H, hd, hd), st[1].reshape(b, H, hd),
               st[2].reshape(b, H))


def mlstm_recurrent(q, k, v, i_raw, f_raw, state=None):
    """The step-by-step recurrence (a decode step, and the chunkwise form's
    oracle); the same signature as :func:`mlstm_chunkwise`."""
    b, s, H, hd = q.shape
    Cm, n, m = state if state is not None else _mlstm_state(b, H, hd,
                                                             q.device)
    scale = 1.0 / math.sqrt(hd)
    f_log = pointwise(F.logsigmoid, f_raw.float())
    i_log = i_raw.float()
    q, k, v = q.float(), k.float(), v.float()
    hs = []
    for t in range(s):
        qt, kt, vt, it, ft = q[:, t], k[:, t], v[:, t], i_log[:, t], \
            f_log[:, t]
        m_new = torch.maximum(ft + m, it)
        decay = torch.exp(ft + m - m_new)
        inp = torch.exp(it - m_new)
        Cm = decay[..., None, None] * Cm + inp[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = decay[..., None] * n + inp[..., None] * kt
        num = torch.einsum("bhd,bhdg->bhg", qt, Cm) * scale
        den = torch.einsum("bhd,bhd->bh", qt, n) * scale
        hs.append(num / torch.maximum(den.abs(),
                                      torch.exp(-m_new))[..., None])
        m = m_new
    return torch.stack(hs, 1), (Cm, n, m)


# ---------------------------------------------------------------------------
# mLSTM block (the xLSTM paper's Fig. 10 style, projection factor 2)
# ---------------------------------------------------------------------------

def mlstm_block_init(cfg, generator, device, dtype=torch.float32):
    """The block's parameters, drawn as the reference's ``mlstm_block_init``:
    di = 2 d, hd = di / H; ``up`` (d, 2 di), the conv (K, di) std 0.5,
    ``wq`` / ``wk`` / ``wv`` / ``w_o`` (di, di) (``w_o`` std 0.01), the
    gates ``w_i`` / ``w_f`` (di, H) std 0.01 with ``b_f`` open from 3 to 6,
    ``down`` (di, d), the group norm's scale ones."""
    d = cfg.d_model
    di = 2 * d
    H = cfg.num_heads
    dense = lambda *shape, **kw: dense_init(shape, generator, device, dtype,
                                            **kw)
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=device)
    return {"up": dense(d, 2 * di),
            "conv_w": dense(cfg.conv_width, di, scale=0.5),
            "conv_b": zeros(di),
            "wq": dense(di, di), "wk": dense(di, di), "wv": dense(di, di),
            "w_i": dense(di, H, scale=0.01), "b_i": zeros(H),
            "w_f": dense(di, H, scale=0.01),
            "b_f": torch.linspace(3.0, 6.0, H, device=device).to(dtype),
            "gn_scale": torch.ones(di, dtype=dtype, device=device),
            "down": dense(di, d),
            "w_o": dense(di, di, scale=0.01), "b_o": zeros(di)}


def _group_norm(x, scale, H, eps=1e-6):
    """Per-head group norm over the head dim of x (b, s, di), float32
    statistics (biased variance), the result times ``scale`` in x's
    dtype."""
    b, s, di = x.shape
    xh = split_last(x, H, di // H).float()
    mu = xh.mean(-1, keepdim=True)
    var = (xh - mu).square().mean(-1, keepdim=True)
    y = (xh - mu) * torch.rsqrt(var + eps)
    return (y.reshape(b, s, di) * scale).to(x.dtype)


def apply_mlstm_block(cfg, p, x, dtype, cache=None, chunk: int = 64):
    """The mLSTM block on the normed x (b, s, d). ``cache``: {"conv": (b,
    K-1, di), "state": (C, n, m)} or None; with a cache and one token the
    recurrent step, else the chunkwise form from the cache's state (or a
    fresh one). Returns (out (b, s, d), new cache)."""
    b, s, d = x.shape
    H = cfg.num_heads
    di = 2 * d
    hd = di // H
    xin = x.to(dtype)
    up = matmul(xin, p["up"].to(dtype))
    x_up, z = up.chunk(2, -1)
    xc, conv_state = _conv1d_causal(p["conv_w"], p["conv_b"], x_up,
                                    cache["conv"] if cache else None)
    xc = F.silu(xc)
    q = split_last(matmul(xc, p["wq"].to(dtype)), H, hd)
    k = split_last(matmul(xc, p["wk"].to(dtype)), H, hd)
    v = split_last(matmul(x_up, p["wv"].to(dtype)), H, hd)
    i_raw = xc @ p["w_i"].to(dtype) + p["b_i"].to(dtype)        # (b, s, H)
    f_raw = matmul(xc, p["w_f"].to(dtype)) + p["b_f"].to(dtype)
    st = cache["state"] if cache else None
    if cache is not None and s == 1:
        h, st = mlstm_recurrent(q, k, v, i_raw, f_raw, st)
    else:
        h, st = mlstm_chunkwise(q, k, v, i_raw, f_raw, st, chunk=chunk)
    o = torch.sigmoid((matmul(x_up, p["w_o"].to(dtype)) + p["b_o"].to(dtype))
                      .float()).to(dtype)
    y = _group_norm(h.reshape(b, s, di).to(dtype) * o, p["gn_scale"], H)
    y = y * F.silu(z)
    out = constrain(matmul(y, p["down"].to(dtype)), "batch", "seq", "embed")
    return out, {"conv": conv_state, "state": st}


def mlstm_init_cache(cfg, batch: int, dtype, device):
    """Zero conv inputs (b, K-1, di) in ``dtype`` and a fresh float32
    state (the stabilizer m at -1e30)."""
    di = 2 * cfg.d_model
    H = cfg.num_heads
    return {"conv": torch.zeros(batch, cfg.conv_width - 1, di, dtype=dtype,
                                device=device),
            "state": _mlstm_state(batch, H, di // H, device)}


# ---------------------------------------------------------------------------
# sLSTM block: the gates read h_{t-1}, so the scan is sequential
# ---------------------------------------------------------------------------

def slstm_block_init(cfg, generator, device, dtype=torch.float32):
    """The block's parameters, drawn as the reference's
    ``slstm_block_init``: the conv (K, d) std 0.5, input projections
    ``w_z`` / ``w_i`` / ``w_f`` / ``w_o`` (d, d), per-head recurrent
    projections ``r_*`` (H, hd, hd) (std 1/sqrt(H)), ``b_f`` open from 3
    to 6, the group norm's scale, and the gated FFN ``up1`` / ``up2`` (d,
    f) and ``down`` (f, d), f = int(4 d / 3)."""
    d = cfg.d_model
    H = cfg.num_heads
    hd = d // H
    f_up = int(d * 4 / 3)
    dense = lambda *shape, **kw: dense_init(shape, generator, device, dtype,
                                            **kw)
    zeros = lambda: torch.zeros(d, dtype=dtype, device=device)
    p = {"conv_w": dense(cfg.conv_width, d, scale=0.5), "conv_b": zeros()}
    for g in "zifo":
        p[f"w_{g}"] = dense(d, d)
    for g in "zifo":
        p[f"r_{g}"] = dense(H, hd, hd)
    p.update(b_z=zeros(), b_i=zeros(),
             b_f=torch.linspace(3.0, 6.0, d, device=device).to(dtype),
             b_o=zeros(), gn_scale=torch.ones(d, dtype=dtype, device=device),
             up1=dense(d, f_up), up2=dense(d, f_up), down=dense(f_up, d))
    return p


def _rdot(r, h, H):
    """Block-diagonal recurrent matmul of h (b, d) float32 by r (H, hd,
    hd)."""
    b, d = h.shape
    return torch.einsum("bhi,hij->bhj", split_last(h, H, d // H),
                        r).reshape(b, d)


def _slstm_scan(x_z, x_i, x_f, x_o, state, r, H):
    """The recurrence over x_* (b, s, d) float32 from ``state`` {"h", "c",
    "n", "m"} (each (b, d) float32) with the recurrent weights ``r``
    {"z", "i", "f", "o"}, one step per position. Returns (hs (b, s, d),
    the state after the last step)."""
    r = {g: w.float() for g, w in r.items()}
    h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    hs = []
    for t in range(x_z.shape[1]):
        z = torch.tanh(x_z[:, t] + _rdot(r["z"], h, H))
        i_raw = x_i[:, t] + _rdot(r["i"], h, H)
        f_raw = x_f[:, t] + _rdot(r["f"], h, H)
        o = torch.sigmoid(x_o[:, t] + _rdot(r["o"], h, H))
        f_log = pointwise(F.logsigmoid, f_raw)
        m_new = torch.maximum(f_log + m, i_raw)
        fhat = torch.exp(f_log + m - m_new)
        ihat = torch.exp(i_raw - m_new)
        c = fhat * c + ihat * z
        n = fhat * n + ihat
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, 1), {"h": h, "c": c, "n": n, "m": m}


def apply_slstm_block(cfg, p, x, dtype, cache=None):
    """The sLSTM block on the normed x (b, s, d): the conv feeds the i and
    f gates, the recurrence, the group norm, then the gated GELU FFN.
    ``cache``: {"conv": (b, K-1, d), "state": {"h", "c", "n", "m"}} or
    None. Returns (out (b, s, d), new cache)."""
    b, s, d = x.shape
    H = cfg.num_heads
    f32 = torch.float32
    xin = x.to(dtype)
    xc, conv_state = _conv1d_causal(p["conv_w"], p["conv_b"], xin,
                                    cache["conv"] if cache else None)
    xc = F.silu(xc)
    proj = lambda inp, g: (matmul(inp, p[f"w_{g}"].to(dtype))
                           + p[f"b_{g}"].to(dtype)).to(f32)
    x_z, x_o = proj(xin, "z"), proj(xin, "o")
    x_i, x_f = proj(xc, "i"), proj(xc, "f")
    state = cache["state"] if cache else slstm_state(b, d, x.device)
    r = {g: p[f"r_{g}"] for g in "zifo"}
    hs, new_state = by_rows(lambda *a: _slstm_scan(*a, H), x_z, x_i, x_f,
                            x_o, state, whole=(r,))
    y = _group_norm(hs.to(dtype), p["gn_scale"], H)
    u1 = matmul(y, p["up1"].to(dtype))
    u2 = matmul(y, p["up2"].to(dtype))
    out = matmul(F.gelu(u1, approximate="tanh") * u2, p["down"].to(dtype))
    out = constrain(out, "batch", "seq", "embed")
    return out, {"conv": conv_state, "state": new_state}


def slstm_state(batch: int, d: int, device):
    """A fresh float32 state: h, c, n zeros and m at -1e30, each (b, d)."""
    z = lambda: torch.zeros(batch, d, dtype=torch.float32, device=device)
    return {"h": z(), "c": z(), "n": z(),
            "m": torch.full((batch, d), NEG, dtype=torch.float32,
                            device=device)}


def slstm_init_cache(cfg, batch: int, dtype, device):
    """Zero conv inputs (b, K-1, d) in ``dtype`` and a fresh state."""
    d = cfg.d_model
    return {"conv": torch.zeros(batch, cfg.conv_width - 1, d, dtype=dtype,
                                device=device),
            "state": slstm_state(batch, d, device)}
