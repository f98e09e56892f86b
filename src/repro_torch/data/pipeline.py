"""Deterministic, resumable synthetic data: the port's copy of
``repro.data.pipeline`` (numpy only, so a ``(seed, step)`` gives the
reference's batch bit for bit).

``LMStream`` yields next-token-prediction batches drawn from a fixed random
bigram process (learnable structure, so loss curves move). The stream is
deterministic (``(seed, step)`` fixes a batch), shard-aware (each
data-parallel shard takes its rows by ``(shard_id, num_shards)``) and
resumable (``state()`` / ``restore()`` round-trip the cursor).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class LMStream:
    vocab_size: int
    seq_len: int
    batch_size: int                    # per-shard rows
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    branching: int = 4                 # bigram fan-out (smaller = easier)

    def __post_init__(self):
        self._step = 0
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # fixed sparse bigram transition table: v -> `branching` successors
        self._succ = rng.integers(0, v, size=(v, self.branching), dtype=np.int64)

    # -- resume ----------------------------------------------------------
    def state(self) -> Dict:
        return {"step": self._step, "seed": self.seed,
                "shard_id": self.shard_id, "num_shards": self.num_shards}

    def restore(self, state: Dict):
        if state["seed"] != self.seed:
            raise ValueError("resuming a different stream")
        self._step = int(state["step"])

    # -- batches ----------------------------------------------------------
    def _rows(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.seed, step, self.shard_id, self.num_shards))
        b, s = self.batch_size, self.seq_len
        toks = np.empty((b, s + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=b)
        choice = rng.integers(0, self.branching, size=(b, s))
        for t in range(s):
            toks[:, t + 1] = self._succ[toks[:, t], choice[:, t]]
        return toks

    def next(self) -> Dict[str, np.ndarray]:
        toks = self._rows(self._step)
        self._step += 1
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self):
        while True:
            yield self.next()


def input_batch_for(cfg, shape, seed: int = 0, kind: Optional[str] = None):
    """A numpy batch for ``cfg`` at ``shape`` (a ``configs.ShapeSpec``):
    tokens, plus labels for a ``train`` shape."""
    rng = np.random.default_rng(seed)
    kind = kind or shape.kind
    b, s = shape.global_batch, shape.seq_len
    batch = {}
    if cfg.frontend == "audio_frames":
        batch["frames"] = rng.normal(size=(b, s, cfg.frontend_dim)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        if cfg.frontend == "vision_patches":
            batch["patches"] = rng.normal(
                size=(b, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    if kind == "train":
        batch["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return batch
