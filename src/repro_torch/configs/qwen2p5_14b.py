"""qwen2.5-14b — dense GQA transformer with QKV bias.

[hf:Qwen/Qwen2.5-14B] 48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
long_500k skipped: pure full attention.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    attn_kind="full",
    qkv_bias=True,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    pos_type="rope",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    skip_shapes=(("long_500k", "pure full-attention arch; 512k KV decode needs sub-quadratic attention"),),
    source="hf:Qwen/Qwen2.5-14B; hf",
    aot_note="standard token-indexed AoT bias",
)
