"""olmo-1b — dense transformer with non-parametric LayerNorm.

[arXiv:2402.00838] 16L d_model=2048 16H (kv=16, MHA) d_ff=8192 vocab=50304.
Non-parametric LN means BitFit has no LN params to tune; the BitFit baseline
falls back to attention/MLP projection biases (see core/peft.py).
long_500k skipped: pure full attention.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    attn_kind="full",
    norm_type="nonparametric",
    norm_eps=1e-5,
    mlp_type="swiglu",
    pos_type="rope",
    tie_embeddings=True,
    skip_shapes=(("long_500k", "pure full-attention arch; 512k KV decode needs sub-quadratic attention"),),
    source="arXiv:2402.00838; hf",
    aot_note="standard token-indexed AoT bias",
)
