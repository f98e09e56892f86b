"""Mixture-of-experts FFN: capacity-based gather dispatch, and explicit
expert parallelism over all_to_all.

Counterpart of ``repro.models.moe``, in plain PyTorch: the reference's
routing, dispatch and expert products are XLA, not Pallas, so there is no
kernel to port here. :func:`apply_moe_gspmd` is its GSPMD gather path:
tokens route within ``G`` groups, G the mesh's data-group count
(``distrib.sharding.data_group_count``, 1 outside a mesh), each group
with its own capacity, so drops change with G as in the reference.
:func:`apply_moe_ep` is its shard_map path: each rank routes its own
tokens, sends each assignment to the rank that owns its expert over the
model axis (``all_to_all``), runs its local experts and sends the
results back; :func:`apply_moe` takes it when the mesh allows
(:func:`_ep_applicable`).

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

Top-k breaks ties toward the lower expert index, as ``jax.lax.top_k``
does (:func:`top_k`): a router of zeros ties every expert.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.nn.functional import all_reduce, all_to_all_single
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distrib import sharding as shlib
from repro_torch.distrib.sharding import constrain
from repro_torch.models.layers import (checkpoint_name, dense_init,
                                      dense_init_sliced)

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


def top_k(probs, k: int):
    """(values, indices) of the ``k`` largest entries along the last axis,
    in descending order, ties to the lower index (``jax.lax.top_k``'s
    order; ``torch.topk`` does not promise one)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(xf, router, k):
    """Router logits (float32), their softmax, and the top-k weights
    (renormalised) and experts of the tokens ``xf`` (..., d)."""
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)
    return logits, probs, top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9), \
        top_e


def _shared(cfg, p, x, dtype):
    """The shared expert's dense SwiGLU of x (llama4's), or None."""
    if not cfg.moe.shared_expert_d_ff:
        return None
    sp = p["shared"]
    xd = x.to(dtype)
    mm = shlib.matmul
    return mm(F.silu(mm(xd, sp["wg"].to(dtype))) * mm(xd, sp["wu"].to(
        dtype)), sp["wd"].to(dtype))


def apply_moe(cfg, p, x, dtype, record=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`apply_moe_ep` when the mesh allows it
    (:func:`_ep_applicable`), else :func:`apply_moe_gspmd`."""
    if _ep_applicable(cfg, x):
        if record is not None:
            raise NotImplementedError("routes are recorded on the gather "
                                      "path only")
        return apply_moe_ep(cfg, p, x, dtype)
    return apply_moe_gspmd(cfg, p, x, dtype, record)


def apply_moe_gspmd(cfg, p, x, dtype, record=None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (..., d), the call's tokens in the order they claim capacity
    (row-major over the leading axes) -> (out of x's shape in ``dtype``,
    aux). A 3-d x (b, s, d) under a mesh routes in ``G`` groups of whole
    rows (G the data-group count when it divides b, else 1), each group's
    tokens claiming its own capacity ``_capacity(T / G)``. Router in
    float32, experts in ``dtype``. ``aux`` holds 0-d float32 tensors:
    ``moe_lb_loss`` (Switch's load balance, E * sum over experts of the
    mean router probability times the share of tokens that chose the
    expert), ``moe_z_loss`` (the mean squared logsumexp of the router's
    logits) and ``moe_dropped_frac`` (the share of the T * k assignments
    dropped by capacity). ``record``: a list that gains this call's
    routing, ``{"top_e": (T, k) int64, "keep": (T, k) bool, "rank_e": (T,
    R) the R = min(k + 8, E) most probable experts in order, "rank_p": (T,
    R) float32 their router probabilities, "tokens": T, "capacity": C}``
    (device tensors, detached; reading them waits for the device)."""
    m = cfg.moe
    d = x.shape[-1]
    E, k = m.num_experts, m.top_k
    G = shlib.data_group_count() if x.dim() == 3 else 1
    if G <= 0 or x.shape[0] % G:
        G = 1
    T = x.numel() // d
    Tg = T // G
    C = _capacity(Tg, cfg)
    dev = x.device

    xf = constrain(x.reshape(G, Tg, d), "batch", None, "embed")
    logits, probs, top_p, top_e = _route(xf, p["router"], k)  # (G, Tg, ..)
    # position in the expert's bucket: an exclusive running count over
    # each group's flattened (token, k) assignments
    flat_e = top_e.reshape(G, Tg * k)
    onehot = (flat_e[..., None] == torch.arange(E, device=dev)).long()
    pos = torch.cumsum(onehot, dim=1) - onehot
    pos_in_e = pos.gather(2, flat_e[..., None])[..., 0]
    keep = pos_in_e < C                                         # (G, Tg k)
    # dropped assignments park in the dump slot E * C
    slot = torch.where(keep, flat_e * C + pos_in_e,
                       torch.full_like(flat_e, E * C))
    tok_idx = (torch.arange(Tg * k, device=dev) // k).expand(G, Tg * k)
    # each slot's token (slots are unique but for the dump slot, cut below)
    slot_tok = torch.zeros(G, E * C + 1, dtype=torch.long,
                           device=dev).scatter(1, slot, tok_idx)
    slot_valid = torch.zeros(G, E * C + 1, dtype=dtype,
                             device=dev).scatter(1, slot, keep.to(dtype))
    slot_tok, slot_valid = slot_tok[:, :E * C], slot_valid[:, :E * C]

    xs = xf.to(dtype).gather(1, slot_tok[..., None].expand(G, E * C, d))
    xs = (xs * slot_valid[..., None]).reshape(G, E, C, d)
    xs = constrain(xs, "batch", "experts", "expert_capacity", "embed")
    # the experts' products over (E, G C, d): one batched product per
    # expert, whatever G
    xs = xs.permute(1, 0, 2, 3).reshape(E, G * C, d)
    g = torch.bmm(xs, p["wg"].to(dtype))
    u = torch.bmm(xs, p["wu"].to(dtype))
    ys = torch.bmm(F.silu(g) * u, p["wd"].to(dtype))
    ys = ys.reshape(E, G, C, d).permute(1, 0, 2, 3).reshape(G, E * C, d)
    ys = torch.cat([ys, ys.new_zeros(G, 1, d)], 1)
    gathered = ys.gather(1, slot[..., None].expand(G, Tg * k, d))
    gathered = gathered.reshape(G, Tg, k, d)
    w = top_p.to(dtype) * keep.reshape(G, Tg, k).to(dtype)
    out = constrain(torch.einsum("gtkd,gtk->gtd", gathered, w), "batch",
                    "seq", "embed")
    shared = _shared(cfg, p, xf, dtype)
    if shared is not None:
        out = out + shared

    me = probs.reshape(T, E).mean(dim=0)
    ce = (onehot.reshape(T, k, E).sum(1) > 0).float().mean(dim=0)
    aux = {"moe_lb_loss": E * (me * ce).sum(),
           "moe_z_loss": torch.logsumexp(logits, dim=-1).square().mean(),
           "moe_dropped_frac": 1.0 - keep.float().mean()}
    if record is not None:
        rank_p, rank_e = torch.topk(probs.detach().reshape(T, E),
                                    min(k + 8, E), dim=-1)
        record.append({"top_e": top_e.detach().reshape(T, k),
                       "keep": keep.reshape(T, k).detach(), "rank_e": rank_e,
                       "rank_p": rank_p, "tokens": T, "capacity": C})
    return out.reshape(x.shape[:-1] + (d,)), aux


# ---------------------------------------------------------------------------
# explicit expert parallelism: all_to_all to the experts' owners
# ---------------------------------------------------------------------------
#
# Each rank holds T / (G M) tokens (groups over the data axes, a group's
# tokens split over the model axis) and E / M experts (over the model
# axis). It routes its tokens, packs each assignment into the send buffer
# of the model rank that owns its expert (capacity Cs per target, 15%
# slack over the uniform share), exchanges the buffers with all_to_all,
# packs what it received into its local experts' buckets (capacity Ce,
# 25% slack), runs them, and sends the rows back the same way. A token
# can drop at either buffer, as in the reference.

def _batch_axes():
    """(mesh, data axis, model axis) of the active rules, or Nones when
    there is no mesh or the rules give no single expert axis."""
    mesh, rules = shlib._current()
    if mesh is None:
        return None, None, None
    data_ax = rules.get("batch")
    model_ax = rules.get("experts")
    if data_ax is None or model_ax is None or isinstance(model_ax, tuple):
        return None, None, None
    return mesh, data_ax, model_ax


def _ep_applicable(cfg, x) -> bool:
    """True under a ``DeviceMesh`` of more than one rank on the data or
    model axis whose sizes divide the call: whole rows per data group, an
    equal share of tokens per rank (at least top_k) and of experts per
    model rank."""
    mesh, data_ax, model_ax = _batch_axes()
    if not isinstance(mesh, DeviceMesh) or x.dim() != 3:
        return False
    b, s, _ = x.shape
    G = shlib.data_group_count()
    M = shlib.mesh_axes(mesh)[model_ax]
    m = cfg.moe
    if G <= 1 and M <= 1:
        return False
    return (b % max(G, 1) == 0 and (b * s) % (max(G, 1) * M) == 0
            and m.num_experts % M == 0
            and (b * s) // (max(G, 1) * M) >= m.top_k)


def _pmean(x, group, size):
    """The mean of ``x`` over ``group`` (differentiable)."""
    return all_reduce(x, group=group) / size if size > 1 else x


def _exclusive_pos(onehot):
    """Each row's exclusive running count in the column it sets."""
    return torch.cumsum(onehot, dim=0) - onehot


def apply_moe_ep(cfg, p, x, dtype) -> Tuple[torch.Tensor, Dict[str,
                                                                torch.Tensor]]:
    """x: (b, s, d) -> (out, aux) under :func:`use_rules` with a
    ``DeviceMesh``: the reference's ``apply_moe_ep`` (module note above).
    x and the parameters may be DTensors or plain tensors that every rank
    holds alike; the result is a DTensor in x's layout, or a plain tensor
    (every rank the whole) for a plain x. The all_to_alls are
    differentiable, and the aux values (each rank's means over the model
    axis, then over the data axes, as the reference's pmeans) too."""
    mesh, data_ax, model_ax = _batch_axes()
    m = cfg.moe
    b, s, d = x.shape
    T = b * s
    G = max(shlib.data_group_count(), 1)
    axes = list(shlib.mesh_axes(mesh))
    M = shlib.mesh_axes(mesh)[model_ax]
    Tl = T // (G * M)                       # tokens per rank
    E, k = m.num_experts, m.top_k
    E_loc = E // M
    # send capacity per target rank, 15% slack over the uniform share
    Cs = max(8, -(-int(Tl * k / M * max(m.capacity_factor, 1.0) * 1.15)
                  // 8) * 8)
    # local expert bucket capacity
    Ce = max(8, -(-int(M * Cs / E_loc * 1.25) // 8) * 8)
    model_group = mesh.get_group(model_ax)
    data_axes = shlib.mesh_dims(mesh, data_ax)

    # a group's rows lie on its data rank; its tokens split over model
    rows_pl = [Shard(0) if a in data_axes else Replicate() for a in axes]
    tok_pl = [Shard(1) if a == model_ax else p for a, p in zip(axes, rows_pl)]
    exp_pl = [Shard(0) if a == model_ax else Replicate() for a in axes]
    whole = [Replicate()] * mesh.ndim
    local = lambda t, pl: shlib.as_dtensor(t, mesh).redistribute(
        mesh, pl).to_local()
    at = mesh.get_local_rank(model_ax) * Tl
    xl = local(x, rows_pl).reshape(T // G, d)[at:at + Tl].to(dtype)
    router = local(p["router"], whole)
    wg, wu, wd = (local(p[n], exp_pl).to(dtype) for n in ("wg", "wu", "wd"))
    dev = xl.device

    logits, probs, top_p, top_e = _route(xl, router, k)     # (Tl, ..)
    flat_e = top_e.reshape(Tl * k)
    ts = flat_e // E_loc                    # the target model rank
    le = flat_e % E_loc                     # the expert there
    oh = F.one_hot(ts, M)
    pos_s = _exclusive_pos(oh).gather(1, ts[:, None])[:, 0]
    keep = pos_s < Cs
    # an assignment past its target's capacity parks in the dump slot
    slot = torch.where(keep, ts * Cs + pos_s, torch.full_like(ts, M * Cs))
    tok = torch.arange(Tl * k, device=dev) // k

    def pack(vals, n, at):
        buf = torch.zeros((n + 1,) + vals.shape[1:], dtype=vals.dtype,
                          device=dev)
        return buf.index_put((at,), vals)[:n]

    def a2a(t):
        out = torch.empty_like(t)
        return all_to_all_single(out, t.contiguous(), group=model_group)

    send_x = pack(xl[tok], M * Cs, slot)
    send_le = pack(le.to(torch.int32), M * Cs, slot)
    send_ok = pack(keep.to(dtype), M * Cs, slot)
    recv_x = a2a(send_x)                                     # (M Cs, d)
    recv_le = a2a(send_le).long()
    valid = a2a(send_ok) > 0

    # the local experts' buckets: only valid rows claim capacity
    oh2 = F.one_hot(recv_le, E_loc) * valid[:, None]
    pos_e = _exclusive_pos(oh2).gather(1, recv_le[:, None])[:, 0]
    keep2 = (pos_e < Ce) & valid
    slot2 = torch.where(keep2, recv_le * Ce + pos_e,
                        torch.full_like(recv_le, E_loc * Ce))
    xs = pack(recv_x, E_loc * Ce, slot2).reshape(E_loc, Ce, d)
    g = torch.bmm(xs, wg)
    u = torch.bmm(xs, wu)
    ys = torch.bmm(F.silu(g) * u, wd).reshape(E_loc * Ce, d)
    ys = torch.cat([ys, ys.new_zeros(1, d)])
    ret = a2a(ys[slot2])                                     # dump -> 0
    with checkpoint_name("moe_out"):    # the combine, kept by that name
        rows = torch.cat([ret, ret.new_zeros(1, d)])[slot]   # dump -> 0
        # each token's k rows, weighted and summed as the gather path
        # sums them (the reference scatter-adds; on the card index_add's
        # atomics would add in no fixed order)
        out_l = torch.einsum("tkd,tk->td", rows.reshape(Tl, k, d),
                             top_p.to(dtype))

    # aux: local means, averaged over the model axis, then the data axes
    # (ce as the gather path's: the share of tokens routed to expert e)
    me = probs.mean(dim=0)
    ce = torch.zeros(E, device=dev).index_add(
        0, flat_e, torch.ones(Tl * k, device=dev)) / Tl
    lb = E * (_pmean(me, model_group, M) * _pmean(ce, model_group, M)).sum()
    zl = _pmean(torch.logsumexp(logits, dim=-1).square().mean(),
                model_group, M)
    dropped = 1.0 - _pmean(keep.float().mean(), model_group, M)
    for a in data_axes:
        n = shlib.mesh_axes(mesh)[a]
        lb, zl, dropped = (_pmean(v, mesh.get_group(a), n)
                           for v in (lb, zl, dropped))

    with checkpoint_name("moe_out"):
        out = shlib.from_local(out_l.reshape(1, Tl, d), mesh, tok_pl,
                               (G, T // G, d))
        out = out.redistribute(mesh, rows_pl).to_local()    # the group's
        out = shlib.from_local(out.reshape(b // G, s, d), mesh, rows_pl,
                               (b, s, d))
        out = constrain(out, "batch", "seq", "embed")
    shared = _shared(cfg, p, x, dtype)
    if shared is not None:
        out = out + shared
    aux = {"moe_lb_loss": lb, "moe_z_loss": zl, "moe_dropped_frac": dropped}
    if not isinstance(x, DTensor):
        out = out.full_tensor()
    else:       # replicated DTensors, whose gradients come back local
        aux = {k: shlib.as_dtensor(v, mesh) for k, v in aux.items()}
    return out, aux
