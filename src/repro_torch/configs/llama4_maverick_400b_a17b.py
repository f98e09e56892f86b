"""llama4-maverick-400b-a17b — MoE with interleaved expert layers + early fusion.

[hf:meta-llama/Llama-4-Maverick] 48L d_model=5120 40H (GQA kv=8) vocab=202048.
MoE on every 2nd layer: 128 routed experts (top-1, d_ff=8192) + one shared
expert (d_ff=8192); dense layers use d_ff=16384. Early-fusion VLM: image
tokens (stub) spliced into the sequence like paligemma. ~400B total, ~17B
active per token. long_500k skipped: full attention.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=16384,          # dense-layer FFN width (non-MoE layers)
    vocab_size=202048,
    attn_kind="full",
    norm_type="rmsnorm",
    mlp_type="swiglu",
    pos_type="rope",
    rope_theta=500_000.0,
    tie_embeddings=False,
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192, interleave=2,
                  shared_expert_d_ff=8192),
    skip_shapes=(("long_500k", "pure full-attention arch; 512k KV decode needs sub-quadratic attention"),),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    aot_note="AoT indexes text tokens; early-fusion image tokens share a sentinel row",
)
