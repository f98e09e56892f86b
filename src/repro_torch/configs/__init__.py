"""Architecture config registry of the port.

``get(name)`` resolves a registered architecture. The port registers the
backbones it can serve; today that is smollm-360m, the main path's model.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig, reduced  # noqa: F401
from repro_torch.configs.smollm_360m import CONFIG as _smollm

REGISTRY: Dict[str, ArchConfig] = {c.name: c for c in (_smollm,)}


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
