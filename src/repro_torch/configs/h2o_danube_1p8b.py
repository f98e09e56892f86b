"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818] 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.
SWA bounds the decode KV cache to the window, so long_500k is runnable.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    attn_kind="swa",
    sliding_window=4096,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    pos_type="rope",
    rope_theta=10_000.0,
    tie_embeddings=False,
    source="arXiv:2401.16818; hf",
    aot_note="standard token-indexed AoT bias",
)
