"""Ahead-of-Time P-Tuning (the paper's method): the reparametrizations it
trains, their fusion into tables, and the tables it serves.

Each layer i of a task carries a vocabulary-indexed bias table
``P^i (V, d)`` added to the hidden states before the layer,
``H'^i = H^i + P^i[x]`` (the paper's Eq. 1). Training never materializes
P: two reparametrizations compute only the rows a batch needs (section
3.3), FC ``P = f(E W1 + b1) W2 + b2`` (Eq. 3) and Kronecker
``P = (W_L kron W_M) W_R`` (Eq. 2). Their init makes the initial bias
exactly 0 (FC: W2, b1, b2 zero; Kronecker: W_R zero). After training,
:func:`fuse` materializes the tables ``(L, V, d)``; one task is served from
its tables, a frozen backbone serves many tasks from the stacked tables
``(L, tasks, V, d)``, one gather-add per layer either way. Counterpart of
``repro.core.aot``; the draws come from a ``torch.Generator`` and are not
the reference's bits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import generator
from repro_torch.kernels.aot_bias import gather_index, take_rows
from repro_torch.models.layers import dense_init


@dataclass(frozen=True)
class AoTOptions:
    mode: str = "fc"            # "fc" | "kron" | "fused"
    rank: int = 64              # FC mapping rank / Kronecker rank
    kron_a: int = 0             # 0 = factorize |V| (a * b >= |V|)
    kron_b: int = 0
    nonlin: str = "gelu"        # f in Eq. 3
    dropout: float = 0.1        # on E (FC) / on P_x (Kronecker)


_NONLIN = {"gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's
           "relu": F.relu, "tanh": torch.tanh}


def kron_factors(vocab: int, a: int = 0, b: int = 0) -> Tuple[int, int]:
    """Pick a * b >= |V| (the paper's footnote 1: slightly larger is
    fine): a the power of two near sqrt(|V|), b = ceil(|V| / a)."""
    if a and b:
        if a * b < vocab:
            raise ValueError(f"kron factors {a} x {b} < vocab {vocab}")
        return a, b
    a = 1 << max(1, (int(math.ceil(math.log2(max(vocab, 2)))) + 1) // 2)
    b = -(-vocab // a)
    return a, b


def init(cfg, opt: AoTOptions, generator: torch.Generator, device,
         dtype: torch.dtype = torch.float32):
    """The reparametrization's parameters for all ``cfg.num_layers``
    layers, stacked on axis 0, drawn from ``generator`` on ``device``: FC
    ``w1`` (L, d, r) truncated-normal std 1/sqrt(d), ``b1``, ``w2``, ``b2``
    zero; Kronecker ``wl`` (L, a, r) and ``wm`` (L, b, r) truncated-normal
    std 1/sqrt(r), ``wr`` (L, r * r, d) zero; fused ``table`` (L, V, d)
    zero."""
    L, d, V, r = cfg.num_layers, cfg.d_model, cfg.vocab_size, opt.rank
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    stack = lambda shape, scale=None: torch.stack(
        [dense_init(shape, generator, device, dtype, scale)
         for _ in range(L)])
    if opt.mode == "fc":
        return {"w1": stack((d, r)), "b1": zeros(L, r),
                "w2": zeros(L, r, d), "b2": zeros(L, d)}
    if opt.mode == "kron":
        a, b = kron_factors(V, opt.kron_a, opt.kron_b)
        return {"wl": stack((a, r), 1.0 / math.sqrt(r)),
                "wm": stack((b, r), 1.0 / math.sqrt(r)),
                "wr": zeros(L, r * r, d)}
    if opt.mode == "fused":
        return {"table": zeros(L, V, d)}
    raise ValueError(opt.mode)


def _dropout(x, p: float, generator):
    """Inverted dropout: each element kept with probability 1 - p (drawn
    from ``generator``) and scaled by 1 / (1 - p), else 0."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def rows_fc(layer_p, e_rows, opt: AoTOptions, dtype=torch.float32,
            generator=None):
    """P rows of one layer from the gathered embeddings ``e_rows`` (...,
    d) = E[x]: ``f(E[x] W1 + b1) W2 + b2`` in ``dtype``, with dropout on
    E[x] when ``generator`` is given and ``opt.dropout`` > 0. ``layer_p``:
    one layer's w1 (d, r), b1 (r,), w2 (r, d), b2 (d,)."""
    x = e_rows.to(dtype)
    if generator is not None and opt.dropout > 0:
        x = _dropout(x, opt.dropout, generator)
    h = _NONLIN[opt.nonlin](x @ layer_p["w1"].to(dtype)
                            + layer_p["b1"].to(dtype))
    return h @ layer_p["w2"].to(dtype) + layer_p["b2"].to(dtype)


def rows_kron(layer_p, ids, opt: AoTOptions, dtype=torch.float32,
              generator=None):
    """P rows of one layer by Kronecker lookup: row v = (i, j) with
    ``i = v // b``, ``j = v % b`` is ``vec(W_L[i] kron W_M[j]) W_R``, in
    ``dtype``, with dropout on the rows when ``generator`` is given and
    ``opt.dropout`` > 0. ``layer_p``: wl (a, r), wm (b, r), wr (r * r,
    d); ids: any shape -> (..., d)."""
    b = layer_p["wm"].shape[0]
    ids = ids.long()
    wl = layer_p["wl"].to(dtype)[ids // b]                       # (..., r)
    wm = layer_p["wm"].to(dtype)[ids % b]                        # (..., r)
    r = wl.shape[-1]
    kr = (wl[..., :, None] * wm[..., None, :]).reshape(ids.shape + (r * r,))
    out = kr @ layer_p["wr"].to(dtype)
    if generator is not None and opt.dropout > 0:
        out = _dropout(out, opt.dropout, generator)
    return out


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


def layer_params(aot_params, i: int):
    """Layer ``i``'s slice of stacked reparametrization parameters."""
    return {k: v[i] for k, v in aot_params.items()}


@torch.no_grad()
def fuse(aot_params, cfg, opt: AoTOptions, embed=None,
         vocab_chunk: int = 8192, dtype=torch.float32):
    """The explicit tables ``{"table": (L, V, d)}`` of a reparametrization
    (the paper's section 3.3: P is fused once training is complete), rows
    computed over the vocabulary in chunks of ``vocab_chunk`` ids in
    ``dtype``, without dropout. FC needs the embedding matrix ``embed``
    (V, d)."""
    if opt.mode == "fused":
        return {"table": aot_params["table"].to(dtype)}
    if opt.mode == "fc" and embed is None:
        raise ValueError("FC fusion needs the embedding matrix E")
    L, V, d = cfg.num_layers, cfg.vocab_size, cfg.d_model
    dev = next(iter(aot_params.values())).device
    table = torch.empty((L, V, d), dtype=dtype, device=dev)
    for i in range(L):
        lp = layer_params(aot_params, i)
        for lo in range(0, V, vocab_chunk):
            ids = torch.arange(lo, min(V, lo + vocab_chunk), device=dev)
            table[i, lo:lo + len(ids)] = (
                rows_fc(lp, embed[ids], opt, dtype) if opt.mode == "fc"
                else rows_kron(lp, ids, opt, dtype))
    return {"table": table}


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
    gen = generator(dev, seed)
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
