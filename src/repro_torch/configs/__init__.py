"""Architecture config registry of the port.

``get(name)`` resolves a registered architecture: smollm-360m, the
serving path's model, and the paper's own encoders roberta-large and
deberta-xl (``PAPER_BACKBONES``), which run the whole-sequence entry
points (``Model.forward`` / ``logits`` / ``classify``) and train.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchConfig, reduced  # noqa: F401
from repro_torch.configs.deberta_xl import CONFIG as _deberta
from repro_torch.configs.roberta_large import CONFIG as _roberta
from repro_torch.configs.smollm_360m import CONFIG as _smollm

PAPER_BACKBONES: List[ArchConfig] = [_roberta, _deberta]
REGISTRY: Dict[str, ArchConfig] = {
    c.name: c for c in [_smollm] + PAPER_BACKBONES}


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
