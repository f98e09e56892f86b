"""smollm-360m — small llama-architecture dense model.

[hf:HuggingFaceTB/SmolLM] 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
long_500k skipped: pure full attention.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    attn_kind="full",
    norm_type="rmsnorm",
    mlp_type="swiglu",
    pos_type="rope",
    tie_embeddings=True,
    skip_shapes=(("long_500k", "pure full-attention arch; 512k KV decode needs sub-quadratic attention"),),
    source="hf:HuggingFaceTB/SmolLM-360M; hf",
    aot_note="standard token-indexed AoT bias",
)
