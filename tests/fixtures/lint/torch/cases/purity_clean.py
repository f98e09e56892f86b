"""dispatch-purity's clean twin: effects stay around the step."""
import time

import torch


def _norm(x, gen):
    return x * torch.rand(x.shape, generator=gen)


class Model:
    def mixed_step(self, params, tokens, gen):
        return _norm(tokens, gen)


def serve_tick(model, tokens, gen, metrics):
    t0 = time.perf_counter()
    out = model.mixed_step(None, tokens, gen)
    metrics.ticks.inc()
    print(time.perf_counter() - t0)
    return out
