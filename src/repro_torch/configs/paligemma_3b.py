"""paligemma-3b — VLM: SigLIP patches (stub) + gemma decoder backbone.

[arXiv:2407.07726] 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216.
The vision frontend is a STUB: ``input_specs()`` provides precomputed SigLIP
patch embeddings (b, 256, 1152); the model projects and splices them over the
first 256 token positions (early fusion, prefix-LM attention over the prefix).

AoT applies to text-token positions; image-patch positions index a single
learned sentinel row of P (id = image sentinel). long_500k skipped: full attn.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    attn_kind="full",
    norm_type="rmsnorm",
    mlp_type="geglu",
    pos_type="rope",
    embed_scale=True,
    tie_embeddings=True,
    prefix_lm_len=256,
    frontend="vision_patches",
    frontend_dim=1152,
    frontend_len=256,
    skip_shapes=(("long_500k", "pure full-attention arch; 512k KV decode needs sub-quadratic attention"),),
    aot_note="AoT indexes text tokens; image patches share one learned sentinel row",
    source="arXiv:2407.07726; hf",
)
