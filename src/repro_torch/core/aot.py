"""Ahead-of-Time P-Tuning, inference half: fused task tables.

Each layer i of a task carries a vocabulary-indexed bias table
``P^i (V, d)`` added to the hidden states before the layer,
``H'^i = H^i + P^i[x]`` (the paper's Eq. 1). One task is served from its
tables ``(L, V, d)``; a frozen backbone serves many tasks from the stacked
tables ``(L, tasks, V, d)``, one gather-add per layer either way.
Counterpart of the inference functions of ``repro.core.aot``; training and
fusion of real reparametrizations are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.aot_bias import gather_index, take_rows


@dataclass(frozen=True)
class AoTOptions:
    """The reference's options; the port serves ``mode="fused"`` tables
    (fc and kron reparametrizations are training-time, not ported)."""
    mode: str = "fc"            # "fc" | "kron" | "fused"
    rank: int = 64              # FC mapping rank / Kronecker rank
    kron_a: int = 0
    kron_b: int = 0
    nonlin: str = "gelu"        # f in Eq. 3
    dropout: float = 0.1


def rows_fused(layer_p, ids, dtype=torch.float32):
    """layer_p: ``{"table": (V, d)}``; ids: any shape -> rows (..., d) in
    ``dtype``, by ``jnp.take``'s rule as the reference gathers them: a
    negative id wraps once, an id still outside ``[0, V)`` gives NaN."""
    return take_rows(layer_p["table"], ids).to(dtype)


def rows_fused_multitask(table_layer, task_ids, ids, dtype=torch.float32):
    """table_layer: (tasks, V, d); task_ids: (b,); ids: (b, s) -> (b, s, d).
    Out-of-range indices follow the reference's gather (wrap a negative
    index once, then clamp)."""
    n_tasks, vocab = table_layer.shape[0], table_layer.shape[1]
    task = gather_index(task_ids, n_tasks)[:, None]
    return table_layer[task, gather_index(ids, vocab)].to(dtype)


def random_fused(cfg, embed, seed: int = 0, *, rank: int = 8,
                 scale: float = 0.05, vocab_chunk: int = 64,
                 dtype: Optional[torch.dtype] = None):
    """Fabricate a plausibly-scaled fused task table ``{'table': (L, V, d)}``
    on ``embed``'s device, as the reference's ``random_fused`` does: FC
    reparametrization weights (w1, b1, w2, b2 per layer) drawn as normals
    times ``scale``, then fused chunk by chunk over the vocabulary as
    ``gelu(E[ids] @ w1 + b1) @ w2 + b2`` in float32, stored in ``dtype``
    (default float32). The draws come from a ``torch.Generator`` seeded with
    ``seed``; they are not the reference's bits."""
    L, V, d = cfg.num_layers, cfg.vocab_size, cfg.d_model
    dev = embed.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    normal =lambda *shape: torch.randn(shape, generator=gen, device=dev) * scale
    w1, b1, w2, b2 = normal(L, d, rank), normal(L, rank), \
        normal(L, rank, d), normal(L, d)
    table = torch.empty((L, V, d), dtype=dtype or torch.float32, device=dev)
    for i in range(L):
        for lo in range(0, V, vocab_chunk):
            hi = min(V, lo + vocab_chunk)
            x = embed[lo:hi].float()
            rows = F.gelu(x @ w1[i] + b1[i], approximate="tanh") @ w2[i] + b2[i]
            table[i, lo:hi] = rows.to(table.dtype)
    return {"table": table}


def stack_tasks(fused_list):
    """``[{'table': (L, V, d)}, ...]`` per task -> ``{'table': (L, T, V, d)}``,
    layer-major so each layer sees its ``(T, V, d)`` slice."""
    return {"table": torch.stack([f["table"] for f in fused_list], dim=1)}


def table_bytes(cfg, n_tasks: int = 1, bytes_per_el: int = 2) -> int:
    """Memory the fused tables take (the paper trades memory for speed)."""
    return n_tasks * cfg.num_layers * cfg.vocab_size * cfg.d_model * bytes_per_el
