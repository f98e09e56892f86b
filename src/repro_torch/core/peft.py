"""The PEFT registry: AoT P-Tuning and every baseline the paper compares
(Table 1, Fig. 3). Counterpart of ``repro.core.peft``. Methods:
  ``ft``        full fine-tuning (no extra params; the backbone is trained)
  ``none``      frozen backbone, no extra params
  ``aot``       Ahead-of-Time P-Tuning: fc / kron reparametrizations
                (trained, ``attn_impl="ref"``) or fused tables
                ``{"table": (L, V, d)}`` (served)
  ``bitfit``    bias deltas after the attention output and the MLP, and one
                after the final norm that only ``Model.forward`` adds
  ``lora``      low-rank deltas on W_q and W_v (or fused by ``fuse_lora_into``)
  ``adapters``  Houlsby bottleneck adapters after attention and after the MLP
  ``ptv1``      a soft prompt prepended to the input embeddings (token or
                audio frames alike; P-Tuning v1; run whole-sequence only)
  ``ptv2``      per-layer K/V prefixes (P-Tuning v2), static batches only

``num_classes`` > 0 adds a trainable classification head ``{"w", "b"}``
(the paper's GLUE protocol, ``Model.classify``). The model takes
``peft = {"method", "params", "opt"}`` (``make``); each per-layer leaf is
stacked on axis 0 in layer order, ``(L, ...)``, as the reference's are.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from repro_torch.core import aot as aot_mod
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
    truncated-normal std 1/sqrt(fan_in), the P-Tuning v1 prompt
    truncated-normal and the v2 prefixes normal, std 0.02, AoT as
    ``aot.init``, everything else zero, so that a fresh method leaves the
    backbone unchanged but for the prompts and prefixes), plus a zero
    classification head when ``opt.num_classes`` > 0, drawn from a
    ``torch.Generator`` seeded with ``seed``: not the reference's bits.
    AoT's fc and kron reparametrizations need discrete input ids: a config
    without them (``aot_applicable`` False: hubert's audio frames) raises
    ValueError in the reference's words; fused tables, which the caller
    indexes by its own ids (hubert's unit-AoT), are allowed."""
    m = opt.method
    if m not in METHODS:
        raise ValueError(m)
    if m == "aot" and not (cfg.aot_applicable or opt.aot.mode == "fused"):
        raise ValueError(f"{cfg.name}: AoT P-Tuning needs discrete input "
                         f"ids ({cfg.aot_note}); choose another method")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, d = cfg.num_layers, cfg.d_model
    hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    dense = lambda *shape: torch.stack(
        [dense_init(shape, gen, dev, dtype) for _ in range(L)])
    params: Dict[str, Any] = {}
    if m == "aot":
        params["aot"] = aot_mod.init(cfg, opt.aot, gen, dev, dtype)
    elif m == "bitfit":
        params["bitfit"] = {"attn_out": zeros(L, d), "mlp_out": zeros(L, d),
                            "final": zeros(d)}
    elif m == "lora":
        r = opt.lora_rank
        params["lora"] = {"qa": dense(d, r), "qb": zeros(L, r, hq),
                          "va": dense(d, r), "vb": zeros(L, r, hkv)}
    elif m == "adapters":
        r = opt.adapter_rank
        mk = lambda: {"down": dense(d, r), "up": zeros(L, r, d),
                      "b1": zeros(L, r), "b2": zeros(L, d)}
        params["adapters"] = {"attn": mk(), "mlp": mk()}
    elif m == "ptv1":
        params["ptv1"] = {"prompt": dense_init((opt.prompt_len, d), gen, dev,
                                               dtype, scale=0.02)}
    elif m == "ptv2":
        shape = (L, opt.prompt_len, cfg.num_kv_heads, cfg.head_dim)
        prefix = lambda: (torch.randn(shape, generator=gen, device=dev)
                          * 0.02).to(dtype)
        params["ptv2"] = {"pk": prefix(), "pv": prefix()}
    if opt.num_classes:
        params["head"] = {"w": zeros(d, opt.num_classes),
                          "b": zeros(opt.num_classes)}
    return params


def make(params, opt: PEFTOptions) -> Dict[str, Any]:
    """The bundle ``Model`` and ``ServeEngine`` take."""
    return {"method": opt.method, "params": params, "opt": opt}


def lora_scale(opt: PEFTOptions) -> float:
    return opt.lora_alpha / opt.lora_rank


def backbone_trainable(opt: PEFTOptions) -> bool:
    """Whether the method trains the backbone (full fine-tuning only)."""
    return opt.method == "ft"


def fuse_lora_into(params, peft_params, cfg, opt: PEFTOptions):
    """Serving-time LoRA fusion, ``W' = W + alpha/r * A B`` per layer, on
    W_q and W_v: the paper's "LoRA fused" row (no overhead, one task).
    Returns new backbone parameters; the tensors it does not change are
    shared with ``params``, which is left as it was. The product is taken
    in float32 and rounded once to the weight's dtype, as the reference
    does. Layers without attention (recurrent blocks) are left as they
    are, as the reference skips every unit that is not ``attn``."""
    lora, s = peft_params["lora"], lora_scale(opt)
    layers = []
    for i, lp in enumerate(params["layers"]):
        if "attn" not in lp:
            layers.append(lp)
            continue
        attn = dict(lp["attn"])
        for w, a, b in (("wq", "qa", "qb"), ("wv", "va", "vb")):
            delta = (lora[a][i].float() @ lora[b][i].float()) * s
            attn[w] = attn[w] + delta.to(attn[w].dtype)
        layers.append(dict(lp, attn=attn))
    return dict(params, layers=layers)
