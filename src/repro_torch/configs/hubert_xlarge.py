"""hubert-xlarge — encoder-only audio transformer (w2v2-style backbone).

[arXiv:2106.07447] 48L d_model=1280 16H (MHA) d_ff=5120 vocab=504 (k-means
target units). The modality frontend is a STUB: ``input_specs()`` provides
precomputed conv-feature frames (b, s, 512); the model projects them to d.

AoT P-Tuning applicability: the inputs are CONTINUOUS frames — there is no
input vocabulary to index P with, so standard AoT is inapplicable (see
DESIGN.md §Arch-applicability). The arch is implemented WITHOUT AoT; PEFT
baselines that do not need token ids (BitFit/LoRA/Adapters/P-Tuning v2)
still apply. An optional "unit-AoT" extension indexes P by the HuBERT target
unit ids when the caller supplies them.

Shape skips: encoder-only => no decode step => decode_32k and long_500k skip.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    attn_kind="full",
    norm_type="layernorm",
    norm_eps=1e-5,
    mlp_type="gelu",
    pos_type="learned",
    causal=False,
    is_encoder_only=True,
    tie_embeddings=False,
    frontend="audio_frames",
    frontend_dim=512,
    skip_shapes=(
        ("decode_32k", "encoder-only arch has no autoregressive decode step"),
        ("long_500k", "encoder-only arch has no autoregressive decode step"),
    ),
    aot_applicable=False,
    aot_note=("continuous frame inputs carry no vocabulary ids; standard AoT "
              "inapplicable — optional unit-AoT indexes target unit ids"),
    source="arXiv:2106.07447; unverified",
)
