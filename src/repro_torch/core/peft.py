"""PEFT methods served beside AoT P-Tuning: the baselines of the paper's
Fig. 3 / Table 1 overhead comparison.

Counterpart of ``repro.core.peft`` for serving. Methods:
  ``none``      frozen backbone, no extra params
  ``aot``       Ahead-of-Time P-Tuning, fused tables ``{"table": (L, V, d)}``
  ``bitfit``    bias deltas after the attention output and the MLP, and one
                after the final norm that only ``Model.forward`` adds
  ``lora``      low-rank deltas on W_q and W_v (or fused by ``fuse_lora_into``)
  ``adapters``  Houlsby bottleneck adapters after attention and after the MLP
  ``ptv2``      per-layer K/V prefixes (P-Tuning v2), static batches only

The model takes ``peft = {"method", "params", "opt"}`` (``make``); each
per-layer leaf is stacked on axis 0 in layer order, ``(L, ...)``, as the
reference's are. ``ft``, ``ptv1``, the fc / kron AoT reparametrizations,
the classification head and the trainability masks are training-time and
not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from repro_torch.core.aot import AoTOptions
from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init

METHODS = ("ft", "none", "aot", "bitfit", "lora", "adapters", "ptv1", "ptv2")


@dataclass(frozen=True)
class PEFTOptions:
    method: str = "aot"
    aot: AoTOptions = field(default_factory=AoTOptions)
    lora_rank: int = 16
    lora_alpha: float = 32.0
    adapter_rank: int = 64
    prompt_len: int = 20          # p for ptv1/ptv2
    num_classes: int = 0          # >0 adds a trainable classification head


def init(cfg, opt: PEFTOptions, seed: int = 0, device="cuda",
         dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """The PEFT parameters of ``opt.method`` on ``device``, in ``dtype``,
    with the reference's shapes and distributions (dense matrices
    truncated-normal std 1/sqrt(fan_in), P-Tuning v2 prefixes normal std
    0.02, everything else zero, so that a fresh method leaves the backbone
    unchanged but for the prefixes), drawn from a ``torch.Generator``
    seeded with ``seed``: not the reference's bits."""
    m = opt.method
    if m not in METHODS:
        raise ValueError(m)
    if m in ("ft", "ptv1") or opt.num_classes or (
            m == "aot" and opt.aot.mode != "fused"):
        raise NotImplementedError(
            f"peft {m!r} (aot mode {opt.aot.mode!r}, {opt.num_classes} "
            "classes) is training-time and not ported")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, d, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    dense = lambda *shape: torch.stack(
        [dense_init(shape, gen, dev, dtype) for _ in range(L)])
    if m == "aot":
        return {"aot": {"table": zeros(L, V, d)}}
    if m == "bitfit":
        return {"bitfit": {"attn_out": zeros(L, d), "mlp_out": zeros(L, d),
                           "final": zeros(d)}}
    if m == "lora":
        r = opt.lora_rank
        return {"lora": {"qa": dense(d, r), "qb": zeros(L, r, hq),
                         "va": dense(d, r), "vb": zeros(L, r, hkv)}}
    if m == "adapters":
        r = opt.adapter_rank
        mk = lambda: {"down": dense(d, r), "up": zeros(L, r, d),
                      "b1": zeros(L, r), "b2": zeros(L, d)}
        return {"adapters": {"attn": mk(), "mlp": mk()}}
    if m == "ptv2":
        shape = (L, opt.prompt_len, cfg.num_kv_heads, cfg.head_dim)
        prefix = lambda: (torch.randn(shape, generator=gen, device=dev)
                          * 0.02).to(dtype)
        return {"ptv2": {"pk": prefix(), "pv": prefix()}}
    return {}                                         # none


def make(params, opt: PEFTOptions) -> Dict[str, Any]:
    """The bundle ``Model`` and ``ServeEngine`` take."""
    return {"method": opt.method, "params": params, "opt": opt}


def lora_scale(opt: PEFTOptions) -> float:
    return opt.lora_alpha / opt.lora_rank


def fuse_lora_into(params, peft_params, cfg, opt: PEFTOptions):
    """Serving-time LoRA fusion, ``W' = W + alpha/r * A B`` per layer, on
    W_q and W_v: the paper's "LoRA fused" row (no overhead, one task).
    Returns new backbone parameters; the tensors it does not change are
    shared with ``params``, which is left as it was. The product is taken
    in float32 and rounded once to the weight's dtype, as the reference
    does."""
    lora, s = peft_params["lora"], lora_scale(opt)
    layers = []
    for i, lp in enumerate(params["layers"]):
        attn = dict(lp["attn"])
        for w, a, b in (("wq", "qa", "qb"), ("wv", "va", "vb")):
            delta = (lora[a][i].float() @ lora[b][i].float()) * s
            attn[w] = attn[w] + delta.to(attn[w].dtype)
        layers.append(dict(lp, attn=attn))
    return dict(params, layers=layers)
