"""deberta-xl — the paper's large backbone (48L, d=1024 per paper §3.1).

A standard encoder: the disentangled attention is simplified to learned
absolute positions, as in the JAX package's ``configs/deberta_xl.py``, of
which this is a copy (the AoT mechanism is independent of the attention
flavor).
"""
from repro_torch.configs.base import ArchConfig, ShapeSpec

CONFIG = ArchConfig(
    name="deberta-xl",
    family="dense",
    num_layers=48,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=128100,
    attn_kind="full",
    norm_type="layernorm",
    norm_eps=1e-7,
    mlp_type="gelu",
    pos_type="learned",
    causal=False,
    is_encoder_only=True,
    post_ln=True,
    tie_embeddings=False,
    shapes=(ShapeSpec("train_512", "train", 512, 256),
            ShapeSpec("infer_384", "prefill", 384, 64)),
    source="paper backbone (He et al. 2020)",
)
