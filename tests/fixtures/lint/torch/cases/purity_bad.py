"""Seeded dispatch-purity violations, reached from Model.mixed_step and
from a kernel wrapper of kernels_ops.py."""
import time

import numpy as np
import torch

_CACHE = None


def _deep_helper(x):
    print("two calls below the root")
    return x


def _norm(x):
    return _deep_helper(x)


class Model:
    def mixed_step(self, params, tokens, metrics):
        global _CACHE
        _CACHE = tokens
        t0 = time.perf_counter()
        noise = np.random.normal(size=3)
        drop = torch.rand(4)
        metrics.counter_ticks.inc()
        return _norm(tokens), t0, noise, drop

    def unrelated(self):
        print("not reachable from a root")
