"""qwen3-moe-30b-a3b — MoE transformer, 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B] 48L d_model=2048 32H (GQA kv=4, head_dim=128, q/k
norm) d_ff_expert=768 vocab=151936. Every layer is MoE (interleave=1), no
shared expert. long_500k skipped: full attention.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,           # per-expert intermediate size (router picks top-8)
    vocab_size=151936,
    attn_kind="full",
    qk_norm=True,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    pos_type="rope",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768, interleave=1),
    skip_shapes=(("long_500k", "pure full-attention arch; 512k KV decode needs sub-quadratic attention"),),
    source="hf:Qwen/Qwen3-30B-A3B; hf",
    aot_note="AoT bias applied before router => input-dependent bias also steers routing",
)
