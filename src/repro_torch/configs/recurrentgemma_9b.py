"""recurrentgemma-9b — Griffin hybrid: RG-LRU recurrent blocks + local attention, 1:2.

[arXiv:2402.19427] 38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000.
Pattern: (recurrent, recurrent, local-attn) repeated; 38 = 12*3 + 2, the two
remainder layers are recurrent. Local attention window 2048. Sub-quadratic:
long_500k runs (recurrent state is O(1); local attn cache is window-bounded).
"""
from repro_torch.configs.base import ArchConfig, BLOCK_ATTN, BLOCK_RGLRU

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    attn_kind="swa",
    sliding_window=2048,
    pattern_unit=(BLOCK_RGLRU, BLOCK_RGLRU, BLOCK_ATTN),
    pattern_remainder=(BLOCK_RGLRU, BLOCK_RGLRU),
    norm_type="rmsnorm",
    mlp_type="geglu",
    pos_type="rope",
    embed_scale=True,
    tie_embeddings=True,
    lru_width=4096,
    conv_width=4,
    source="arXiv:2402.19427; unverified",
    aot_note="AoT bias added before every block; technique is block-type-agnostic",
)
