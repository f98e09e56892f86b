"""xlstm-350m — xLSTM language model with mLSTM + sLSTM blocks (7:1).

[arXiv:2405.04517] 24 blocks d_model=1024 4H vocab=50304, d_ff=0 (blocks
carry their own up/down projections). Pattern: 7 mLSTM then 1 sLSTM,
repeated 3x (the xLSTM[7:1] ratio). Fully recurrent => long_500k runs with
O(1) per-token state.
"""
from repro_torch.configs.base import ArchConfig, BLOCK_MLSTM, BLOCK_SLSTM

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern_unit=(BLOCK_MLSTM,) * 7 + (BLOCK_SLSTM,),
    norm_type="layernorm",
    norm_eps=1e-5,
    mlp_type="gelu",     # unused (d_ff=0) but keeps the dataclass total
    pos_type="none",
    tie_embeddings=True,
    source="arXiv:2405.04517; unverified",
    aot_note="AoT bias added before every block; technique is block-type-agnostic",
)
