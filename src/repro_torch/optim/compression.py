"""Gradient compression for the data-parallel all-reduce: bfloat16 on the
wire with float32 error feedback.

Counterpart of ``repro.optim.compression``. Each rank rounds its gradient
plus the error it carried to bfloat16, the ranks sum the bfloat16 values
(half the bytes of a float32 all-reduce), and each divides the sum by the
group's size in float32. The rounding error stays behind in float32 and is
added to the next step's gradient, so the long-run update stays unbiased.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as T


def init_error_state(grads) -> Any:
    """Zeros (float32) shaped as every leaf of ``grads``."""
    return T.map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                       device=g.device), grads)


def compress_decompress(g, err) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the bfloat16 rounding of ``g + err`` as float32, the new error)."""
    g32 = g.float() + err
    q = g32.to(torch.bfloat16)
    return q.float(), g32 - q.float()


def sum_bf16(q, group=None) -> torch.Tensor:
    """The sum over ``group``'s ranks of the bfloat16 tensor ``q``, with
    bfloat16 on the wire both ways: an all_to_all hands rank r the r-th
    slice of every rank's values, which it sums in float32 (exact for a
    few bfloat16 terms, so in any order) and rounds to bfloat16 once; an
    all_gather returns the slices. Every rank gets the same bits, half the
    bytes of a float32 all-reduce."""
    n = dist.get_world_size(group)
    flat = q.reshape(-1)
    pad = -flat.numel() % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    recv = torch.empty_like(flat)
    dist.all_to_all_single(recv, flat, group=group)
    part = recv.view(n, -1).float().sum(0).to(torch.bfloat16)
    whole = torch.empty_like(flat)
    dist.all_gather_into_tensor(whole, part, group=group)
    return whole[:q.numel()].view(q.shape)


def all_reduce_compressed(grads, err_state, group=None) -> Tuple[Any, Any]:
    """The mean over ``group``'s ranks (default: the world) of the
    bfloat16-compressed ``grads``, with error feedback: returns (mean, new
    error state), trees shaped as ``grads``, float32. The bfloat16 values
    are summed by :func:`sum_bf16` (the reference's ``psum_compressed``:
    bfloat16 on the wire), the sum divided by the group's size in
    float32."""
    n = dist.get_world_size(group)
    means, errs = [], []
    for g, e in zip(T.leaves(grads), T.leaves(err_state)):
        q, new_e = compress_decompress(g, e)
        s = sum_bf16(q.to(torch.bfloat16), group)   # exact: q is bfloat16
        means.append(s.float() / n)
        errs.append(new_e)
    return T.unflatten(grads, means), T.unflatten(grads, errs)
