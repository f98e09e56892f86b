"""Learning-rate schedules (step -> lr), the port's counterparts of
``repro.optim.schedules``: each is a function of the step (an int or a
0-d tensor) returning a Python float, computed in float32 as the
reference computes it."""
from __future__ import annotations

import numpy as np

f32 = np.float32


def constant(lr: float):
    return lambda step: float(f32(lr))


def linear_warmup(lr: float, warmup_steps: int):
    def fn(step):
        s = f32(int(step))
        w = min(f32(1.0), s / f32(max(1, warmup_steps)))
        return float(f32(lr) * w)
    return fn


def cosine(lr: float, total_steps: int, warmup_steps: int = 0,
           final_frac: float = 0.1):
    def fn(step):
        s = f32(int(step))
        w = min(f32(1.0), s / f32(max(1, warmup_steps))) if warmup_steps \
            else f32(1.0)
        prog = np.clip((s - f32(warmup_steps))
                       / f32(max(1, total_steps - warmup_steps)),
                       f32(0.0), f32(1.0))
        c = f32(final_frac) + f32(1 - final_frac) * f32(0.5) * (
            f32(1) + np.cos(f32(np.pi) * prog))
        return float(f32(lr) * w * c)
    return fn
