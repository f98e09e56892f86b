"""Mixture-of-experts FFN: capacity-based gather dispatch.

Counterpart of ``repro.models.moe``'s GSPMD gather path
(``apply_moe_gspmd``) at one group (G = 1: the call's tokens route
together), in plain PyTorch: the reference's routing, dispatch and expert
products are XLA, not Pallas, so there is no kernel to port here.

Routing: the router's logits in float32, softmax, top-k, the k weights
renormalised. Each token's k assignments, flattened in ``(token, k)``
order, take a position in their expert's bucket by an exclusive running
count, so earlier tokens claim capacity first; an assignment at position
``>= C`` (:func:`_capacity`) is dropped: it parks in a dump slot past the
``E * C`` buckets, never clobbers an occupant, and its weight is zeroed.
The experts run as batched products over the ``(E, C, d)`` buckets, the
outputs are gathered back per assignment and summed with their weights,
and a shared expert (llama4's), when the config has one, adds a dense
SwiGLU of every token. So a token's output depends on the tokens before
it in the call when its experts fill (capacity counts every token of the
call, dead padding included): ROADMAP C9.

The reference's explicit expert parallelism (``apply_moe_ep``: shard_map
with all_to_all across a mesh) is distribution, queued in ROADMAP A16.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, dense_init_sliced

def moe_init(cfg, generator, device, dtype=torch.float32):
    """The MoE's parameters with the reference's tree and distributions:
    ``router`` (d, E), ``wg`` / ``wu`` (E, d, f) and ``wd`` (E, f, d)
    truncated-normal with std ``1/sqrt(E)`` (the reference's
    ``dense_init`` reads the expert axis as fan-in: ROADMAP C10), each
    drawn one expert at a time; with a shared expert ``shared`` = {``wg``,
    ``wu`` (d, fs), ``wd`` (fs, d)} at std 1/sqrt(fan_in). The router is
    float32 (the reference routes in float32 from a float32 router); the
    rest is stored in ``dtype``."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    experts = lambda *shape: dense_init_sliced(shape, generator, device,
                                               dtype)
    p = {"router": dense_init((d, E), generator, device, torch.float32),
         "wg": experts(E, d, f), "wu": experts(E, d, f),
         "wd": experts(E, f, d)}
    if m.shared_expert_d_ff:
        fs = m.shared_expert_d_ff
        dense = lambda *shape: dense_init(shape, generator, device, dtype)
        p["shared"] = {"wg": dense(d, fs), "wu": dense(d, fs),
                       "wd": dense(fs, d)}
    return p


def _capacity(tokens: int, cfg) -> int:
    """Each expert's bucket rows for a call of ``tokens`` tokens:
    ``ceil(tokens * k / E * capacity_factor)``, at least 8, rounded up to
    a multiple of 8, as the reference's."""
    m = cfg.moe
    c = int(math.ceil(tokens * m.top_k / m.num_experts * m.capacity_factor))
    return max(8, -(-c // 8) * 8)


def apply_moe(cfg, p, x, dtype, record=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (..., d), the call's tokens in the order they claim capacity
    (row-major over the leading axes) -> (out of x's shape in ``dtype``,
    aux). Router in float32, experts in ``dtype``. ``aux`` holds 0-d
    float32 tensors: ``moe_lb_loss`` (Switch's load balance, E * sum over
    experts of the mean router probability times the share of tokens that
    chose the expert), ``moe_z_loss`` (the mean squared logsumexp of the
    router's logits) and ``moe_dropped_frac`` (the share of the T * k
    assignments dropped by capacity). ``record``: a list that gains this
    call's routing, ``{"top_e": (T, k) int64, "keep": (T, k) bool,
    "rank_e": (T, R) the R = min(k + 8, E) most probable experts in order,
    "rank_p": (T, R) float32 their router probabilities, "tokens": T,
    "capacity": C}`` (device tensors, detached; reading them waits for the
    device)."""
    m = cfg.moe
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    E, k = m.num_experts, m.top_k
    C = _capacity(T, cfg)
    dev = x.device

    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    # position in the expert's bucket: an exclusive running count over the
    # flattened (token, k) assignments
    flat_e = top_e.reshape(T * k)
    onehot = (flat_e[:, None] == torch.arange(E, device=dev)).long()
    pos = torch.cumsum(onehot, dim=0) - onehot
    pos_in_e = pos.gather(1, flat_e[:, None])[:, 0]
    keep = pos_in_e < C                                           # (T k,)
    # dropped assignments park in the dump slot E * C
    slot = torch.where(keep, flat_e * C + pos_in_e,
                       torch.full_like(flat_e, E * C))
    tok_idx = torch.arange(T * k, device=dev) // k
    slot_tok = torch.zeros(E * C + 1, dtype=torch.long, device=dev)
    slot_tok[slot] = tok_idx
    slot_valid = torch.zeros(E * C + 1, dtype=dtype, device=dev)
    slot_valid[slot] = keep.to(dtype)
    slot_tok, slot_valid = slot_tok[:E * C], slot_valid[:E * C]

    xs = xf.to(dtype)[slot_tok] * slot_valid[:, None]             # (E C, d)
    xs = xs.reshape(E, C, d)
    g = torch.bmm(xs, p["wg"].to(dtype))
    u = torch.bmm(xs, p["wu"].to(dtype))
    ys = torch.bmm(F.silu(g) * u, p["wd"].to(dtype)).reshape(E * C, d)
    ys = torch.cat([ys, ys.new_zeros(1, d)])
    gathered = ys[slot].reshape(T, k, d)
    w = top_p.to(dtype) * keep.reshape(T, k).to(dtype)
    out = torch.einsum("tkd,tk->td", gathered, w)

    if m.shared_expert_d_ff:
        sp = p["shared"]
        xd = xf.to(dtype)
        sg = xd @ sp["wg"].to(dtype)
        su = xd @ sp["wu"].to(dtype)
        out = out + (F.silu(sg) * su) @ sp["wd"].to(dtype)

    me = probs.mean(dim=0)
    ce = (onehot.reshape(T, k, E).sum(1) > 0).float().mean(dim=0)
    aux = {"moe_lb_loss": E * (me * ce).sum(),
           "moe_z_loss": torch.logsumexp(logits, dim=-1).square().mean(),
           "moe_dropped_frac": 1.0 - keep.float().mean()}
    if record is not None:
        rank_p, rank_e = torch.topk(probs.detach(), min(k + 8, E), dim=-1)
        record.append({"top_e": top_e.detach(),
                       "keep": keep.reshape(T, k).detach(), "rank_e": rank_e,
                       "rank_p": rank_p, "tokens": T, "capacity": C})
    return out.reshape(x.shape[:-1] + (d,)), aux
