"""roberta-large — the paper's primary backbone (AoT P-Tuning, Gavrilov &
Balagansky 2023).

24L d_model=1024 16H d_ff=4096 vocab=50265, learned positions, LayerNorm,
GELU MLP, post-LN, untied head, encoder-only (non-causal). A copy of the
JAX package's ``configs/roberta_large.py``.
"""
from repro_torch.configs.base import ArchConfig, ShapeSpec

CONFIG = ArchConfig(
    name="roberta-large",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=50265,
    attn_kind="full",
    norm_type="layernorm",
    norm_eps=1e-5,
    mlp_type="gelu",
    pos_type="learned",
    causal=False,
    is_encoder_only=True,
    post_ln=True,
    tie_embeddings=False,
    shapes=(ShapeSpec("train_512", "train", 512, 256),
            ShapeSpec("infer_384", "prefill", 384, 64)),
    source="paper backbone (Liu et al. 2019)",
)
