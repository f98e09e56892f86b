"""Seeded rng-discipline violations of the serve scope in the port's
idiom: a kept numpy generator and a torch draw advance stateful streams."""
import torch


def bad_kept_generator(rng):
    return rng.random(2)


def bad_torch_draw(logits, gen):
    return torch.multinomial(logits.softmax(-1), 1, generator=gen)
