"""Architecture config registry of the port.

``get(name)`` resolves a registered architecture: the causal decoders that
serve (smollm-360m, the serving path's model; olmo-1b with its
non-parametric LayerNorm, qwen2.5-14b with its QKV bias, h2o-danube-1.8b
with its sliding window, ``DECODERS``; the mixture-of-experts decoders
qwen3-moe-30b-a3b, 128 experts top-8 with q/k norm, and
llama4-maverick-400b-a17b, MoE on every second layer with a shared
expert, ``MOE``), the recurrent backbones recurrentgemma-9b (RG-LRU
blocks and local MQA attention) and xlstm-350m (mLSTM / sLSTM), served
as static batches (``RECURRENT``), the two front-ends (``FRONTENDS``):
paligemma-3b (stub SigLIP patches over a bidirectional prefix, static
batches) and hubert-xlarge (stub audio frames, an encoder), and the
paper's own encoders roberta-large and deberta-xl (``PAPER_BACKBONES``);
the encoders run the whole-sequence entry points (``Model.forward`` /
``logits`` / ``classify``) and train. ``REGISTRY`` holds the reference's
twelve configs; ``ASSIGNED`` the reference's ten assigned ones, in its
order (the dry run's cells).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchConfig, reduced  # noqa: F401
from repro_torch.configs.deberta_xl import CONFIG as _deberta
from repro_torch.configs.h2o_danube_1p8b import CONFIG as _danube
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as _llama4
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.paligemma_3b import CONFIG as _pali
from repro_torch.configs.qwen2p5_14b import CONFIG as _qwen
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3moe
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma
from repro_torch.configs.roberta_large import CONFIG as _roberta
from repro_torch.configs.smollm_360m import CONFIG as _smollm
from repro_torch.configs.xlstm_350m import CONFIG as _xlstm

DECODERS: List[ArchConfig] = [_smollm, _olmo, _qwen, _danube]
MOE: List[ArchConfig] = [_qwen3moe, _llama4]
RECURRENT: List[ArchConfig] = [_rgemma, _xlstm]
FRONTENDS: List[ArchConfig] = [_pali, _hubert]
PAPER_BACKBONES: List[ArchConfig] = [_roberta, _deberta]
ASSIGNED: List[ArchConfig] = [_danube, _olmo, _smollm, _qwen, _hubert, _pali,
                               _rgemma, _qwen3moe, _llama4, _xlstm]
REGISTRY: Dict[str, ArchConfig] = {
    c.name: c for c in DECODERS + MOE + RECURRENT + FRONTENDS
    + PAPER_BACKBONES}


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
