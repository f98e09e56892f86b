"""Architecture config registry of the port.

``get(name)`` resolves a registered architecture: the causal decoders that
serve (smollm-360m, the serving path's model; olmo-1b with its
non-parametric LayerNorm, qwen2.5-14b with its QKV bias, h2o-danube-1.8b
with its sliding window, ``DECODERS``), and the paper's own encoders
roberta-large and deberta-xl (``PAPER_BACKBONES``), which run the
whole-sequence entry points (``Model.forward`` / ``logits`` /
``classify``) and train.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchConfig, reduced  # noqa: F401
from repro_torch.configs.deberta_xl import CONFIG as _deberta
from repro_torch.configs.h2o_danube_1p8b import CONFIG as _danube
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.qwen2p5_14b import CONFIG as _qwen
from repro_torch.configs.roberta_large import CONFIG as _roberta
from repro_torch.configs.smollm_360m import CONFIG as _smollm

DECODERS: List[ArchConfig] = [_smollm, _olmo, _qwen, _danube]
PAPER_BACKBONES: List[ArchConfig] = [_roberta, _deberta]
REGISTRY: Dict[str, ArchConfig] = {
    c.name: c for c in DECODERS + PAPER_BACKBONES}


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
