"""A draw with a raw key, in the port's idiom (line 8)."""
import torch


def bad_raw_draw(logits, seed):
    # a key made here from the seed alone, with no counter folded in
    key = prng_key(seed)
    return gumbel(key, logits.shape[-1])
