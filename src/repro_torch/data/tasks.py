"""Synthetic classification tasks, the offline stand-in for GLUE /
SuperGLUE: the port's copy of ``repro.data.tasks``.

Each task plants class-conditional keyword tokens into otherwise random
sequences; the label is recoverable from which keyword set dominates. The
signal is token-identity-based, which is the inductive bias AoT P-Tuning
(vocabulary-indexed biases) should exploit and BitFit (a constant bias)
should not (the paper's section 3.4).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class ClassificationTask:
    name: str
    vocab_size: int
    seq_len: int
    num_classes: int
    seed: int
    keywords_per_class: int = 8
    signal_tokens: int = 6          # planted keyword occurrences per row

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.keywords = rng.choice(
            self.vocab_size, size=(self.num_classes, self.keywords_per_class),
            replace=False)

    def batch(self, batch_size: int, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        b, s = batch_size, self.seq_len
        toks = rng.integers(0, self.vocab_size, size=(b, s))
        labels = rng.integers(0, self.num_classes, size=b)
        for i in range(b):
            pos = rng.choice(s, size=self.signal_tokens, replace=False)
            toks[i, pos] = rng.choice(self.keywords[labels[i]], size=self.signal_tokens)
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}


def make_task_suite(vocab_size: int, seq_len: int = 64, seeds=(0, 1, 2, 3),
                    num_classes: int = 2) -> List[ClassificationTask]:
    """A small SuperGLUE-like suite: several binary tasks, distinct seeds."""
    return [ClassificationTask(name=f"synth-{i}", vocab_size=vocab_size,
                               seq_len=seq_len, num_classes=num_classes,
                               seed=1000 + i) for i, _ in enumerate(seeds)]
