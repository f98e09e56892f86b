"""Config dataclasses for architectures and shapes (stdlib only).

A copy of the JAX package's ``configs/base.py``, kept in the port so that
``repro_torch`` never imports ``repro``. Every architecture is expressed as
an :class:`ArchConfig`; ``repro_torch.models`` consumes these configs and
hard-codes none.

Layers are described by a *pattern unit* (a short tuple of block kinds, e.g.
``("rglru", "rglru", "attn")`` for recurrentgemma) repeated ``n`` times plus an
optional remainder. This lets the model scan over homogeneous stacks while
still expressing heterogeneous (hybrid) architectures faithfully.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Block kinds understood by repro.models.model
BLOCK_ATTN = "attn"          # self-attention + MLP transformer block
BLOCK_RGLRU = "rglru"        # Griffin recurrent block (conv + RG-LRU) + MLP
BLOCK_MLSTM = "mlstm"        # xLSTM mLSTM block (self-contained, no MLP)
BLOCK_SLSTM = "slstm"        # xLSTM sLSTM block (self-contained, no MLP)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # every `interleave`-th layer is MoE (1 = all layers); llama4 uses 2
    interleave: int = 1
    shared_expert_d_ff: int = 0          # 0 = no shared expert
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                 # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The assigned LM-family shape set (identical across the 10 archs).
TRAIN_4K = ShapeSpec("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeSpec("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeSpec("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeSpec("long_500k", "decode", 524288, 1)
LM_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | audio | vlm | hybrid | moe | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                # 0 -> d_model // num_heads
    # --- attention ---
    attn_kind: str = "full"          # "full" | "swa"
    sliding_window: int = 0          # used when attn_kind == "swa" (or by local-attn blocks)
    qkv_bias: bool = False
    qk_norm: bool = False            # qwen3-style RMSNorm on q/k heads
    logit_softcap: float = 0.0       # gemma2-style attn softcap (0 = off)
    # --- layer pattern ---
    pattern_unit: Tuple[str, ...] = (BLOCK_ATTN,)
    pattern_repeats: int = 0         # 0 -> num_layers // len(pattern_unit)
    pattern_remainder: Tuple[str, ...] = ()
    # --- norm / mlp / positions ---
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm | nonparametric
    norm_eps: float = 1e-6
    mlp_type: str = "swiglu"         # swiglu | geglu | gelu
    pos_type: str = "rope"           # rope | learned | none
    rope_theta: float = 10_000.0
    embed_scale: bool = False        # gemma-style sqrt(d) embedding scaling
    tie_embeddings: bool = True
    # --- structure ---
    causal: bool = True
    is_encoder_only: bool = False
    post_ln: bool = False            # post-LN residual (RoBERTa/DeBERTa); default pre-LN
    prefix_lm_len: int = 0           # >0: bidirectional attention over prefix (paligemma)
    # --- modality frontend (stub; provides precomputed frame/patch embeds) ---
    frontend: Optional[str] = None   # None | "audio_frames" | "vision_patches"
    frontend_dim: int = 0            # raw embedding dim fed by the stub
    frontend_len: int = 0            # number of frontend positions (vlm patches)
    # --- moe / recurrent ---
    moe: Optional[MoEConfig] = None
    lru_width: int = 0               # RG-LRU state width (0 -> d_model)
    conv_width: int = 4              # temporal conv width in recurrent blocks
    # --- shapes & applicability ---
    shapes: Tuple[ShapeSpec, ...] = LM_SHAPES
    skip_shapes: Tuple[Tuple[str, str], ...] = ()   # (shape_name, reason)
    # --- AoT P-Tuning applicability (see DESIGN.md §Arch-applicability) ---
    aot_applicable: bool = True
    aot_note: str = ""
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.pattern_repeats == 0:
            unit = len(self.pattern_unit)
            rep = (self.num_layers - len(self.pattern_remainder)) // unit
            object.__setattr__(self, "pattern_repeats", rep)
        got = self.pattern_repeats * len(self.pattern_unit) + len(self.pattern_remainder)
        assert got == self.num_layers, (
            f"{self.name}: pattern covers {got} layers, config says {self.num_layers}")
        assert self.num_heads % self.num_kv_heads == 0, self.name

    # ------------------------------------------------------------------
    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return self.pattern_unit * self.pattern_repeats + self.pattern_remainder

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no shape {name}")

    def shape_skip_reason(self, name: str) -> Optional[str]:
        for n, reason in self.skip_shapes:
            if n == name:
                return reason
        return None

    def runnable_shapes(self) -> Tuple[ShapeSpec, ...]:
        return tuple(s for s in self.shapes if self.shape_skip_reason(s.name) is None)

    def moe_layer_mask(self) -> Tuple[bool, ...]:
        """True for layers that carry a routed-MoE FFN."""
        if self.moe is None:
            return tuple(False for _ in range(self.num_layers))
        step = self.moe.interleave
        # llama4 convention: MoE on layers where (i+1) % step == 0
        return tuple(((i + 1) % step == 0) for i in range(self.num_layers))

    def replace(self, **kw) -> "ArchConfig":
        # pattern_repeats must be recomputed when layer counts change
        if ("num_layers" in kw or "pattern_unit" in kw or
                "pattern_remainder" in kw) and "pattern_repeats" not in kw:
            kw.setdefault("pattern_repeats", 0)
        return dataclasses.replace(self, **kw)


def reduced(cfg: ArchConfig, *, d_model: int = 64, vocab: int = 128,
            repeats: int = 1) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests.

    Keeps the block pattern / norm / mlp / attention flavor of the full config
    while shrinking every dimension.
    """
    heads = max(2, min(4, cfg.num_heads))
    # preserve the GQA ratio if possible
    ratio = max(1, cfg.num_heads // cfg.num_kv_heads)
    kv = max(1, heads // min(ratio, heads))
    moe = cfg.moe
    if moe is not None:
        # capacity_factor = E makes C >= T*k: drop-free routing, so smoke
        # tests can assert decode == full-forward bit-consistency.
        moe = dataclasses.replace(
            moe, num_experts=4, top_k=min(2, moe.top_k), d_ff_expert=d_model * 2,
            shared_expert_d_ff=(d_model * 2 if moe.shared_expert_d_ff else 0),
            capacity_factor=4.0)
        if moe.interleave > 1 and len(cfg.pattern_unit) == 1:
            repeats = max(repeats, moe.interleave)   # cover one full moe period
    remainder = cfg.pattern_remainder[:0]  # drop remainder in smoke configs
    return cfg.replace(
        num_layers=repeats * len(cfg.pattern_unit),
        pattern_repeats=repeats,
        pattern_remainder=remainder,
        shapes=(ShapeSpec("smoke_train", "train", 64, 2),
                ShapeSpec("smoke_decode", "decode", 64, 2)),
        skip_shapes=(),
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads,
        d_ff=0 if cfg.d_ff == 0 else d_model * 3,
        vocab_size=vocab,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        lru_width=0,
        frontend_dim=32 if cfg.frontend else 0,
        frontend_len=4 if cfg.frontend == "vision_patches" else 0,
        prefix_lm_len=4 if cfg.prefix_lm_len else 0,
        moe=moe,
    )
