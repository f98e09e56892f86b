"""The clean twin: every draw names its generator."""
import numpy as np
import torch


def init(shape, seed):
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(shape, generator=gen)
    b = torch.empty(shape).uniform_(-1, 1, generator=gen)
    noise = np.random.default_rng(seed).random(3)
    return w, b, noise
