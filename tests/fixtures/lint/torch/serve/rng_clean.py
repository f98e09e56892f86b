"""rng-discipline's clean twin: counter-derived keys, generators made at
the draw from counters, and draw wrappers whose keys are their callers'."""
import numpy as np


def random_bits(keys, n):
    return keys[:, :1].expand(-1, n)


def gumbel(keys, n):
    bits = random_bits(keys, n)
    return bits


def draw(logits, base_keys, steps):
    keys = step_keys(base_keys, steps)
    return gumbel(keys, logits.shape[-1])


def draw_inline(logits, seed, sample_idx, j):
    return gumbel(fold_in(fold_in(prng_key(seed), sample_idx), j),
                  logits.shape[-1])


def fault_coin(seed, tick, salt):
    return np.random.default_rng([seed, tick, salt]).random(2)
