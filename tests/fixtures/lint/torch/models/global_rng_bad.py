"""Seeded global-generator draws (scope: models/, train/, core/, serve/)."""
import numpy as np
import torch


def init(shape):
    torch.manual_seed(0)
    w = torch.randn(shape)
    b = torch.empty(shape).uniform_(-1, 1)
    noise = np.random.rand(3)
    return w, b, noise
