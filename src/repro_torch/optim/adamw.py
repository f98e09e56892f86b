"""AdamW over trees of tensors: the port's counterpart of
``repro.optim.adamw``, with its arithmetic and order (float32 moments,
bias corrections ``1 - b ** t`` in float32,
``delta = mh / (sqrt(vh) + eps) + wd * p``, then ``p - lr * delta``).
``torch.optim.AdamW`` orders the decay and the bias correction otherwise,
so the port does not use it.

The trainers split the parameters into a trainable and a frozen tree
before the optimizer sees them, so the frozen backbone carries no
optimizer state and needs no mask; ``mask`` (a tree of bools, True =
decay) serves partial-backbone regimes.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import numpy as np
import torch

from repro_torch import tree as T


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a 0-d tensor
    on the leaves' device; 0 for an empty tree on the CPU), the leaves
    summed in the reference's order (``tree.sorted_leaves``)."""
    xs = T.sorted_leaves(tree)
    if not xs:
        return torch.zeros(())
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in xs]).sum())


def clip_by_global_norm(tree, max_norm: float):
    """(``tree`` scaled by ``min(1, max_norm / max(norm, 1e-9))``, norm):
    each leaf scaled in float32 and cast back to its dtype."""
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return T.map(lambda x: (x.float() * scale).to(x.dtype), tree), g


def adamw(lr: Union[Callable[[int], float], float], b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
          mask=None):
    """Returns (init_fn, update_fn); ``lr`` is a float or a schedule of the
    step (1 at the first update). ``update_fn(grads, state, params)``
    returns new parameter tensors (detached) and the new state; it leaves
    its inputs as they were."""
    lr_fn = lr if callable(lr) else (lambda _: float(np.float32(lr)))

    def init_fn(params) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return AdamWState(step=0, mu=T.map(zeros, params),
                          nu=T.map(zeros, params))

    @torch.no_grad()
    def update_fn(grads, state: AdamWState, params):
        step = state.step + 1
        t = np.float32(step)
        lr_t = lr_fn(step)
        c1 = float(np.float32(1.0) - np.float32(b1) ** t)
        c2 = float(np.float32(1.0) - np.float32(b2) ** t)

        def upd(g, m, v, p, decay_ok=True):
            g32 = g.float()
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * g32.square()
            delta = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay and decay_ok:
                delta = delta + weight_decay * p.float()
            return (p.detach().float() - lr_t * delta).to(p.dtype), m, v

        masks = T.leaves(mask) if mask is not None else None
        out = [upd(*a) if masks is None else upd(*a, masks[i])
               for i, a in enumerate(zip(T.leaves(grads), T.leaves(state.mu),
                                         T.leaves(state.nu),
                                         T.leaves(params)))]
        new = [T.unflatten(params, [o[k] for o in out]) for k in range(3)]
        return new[0], AdamWState(step=step, mu=new[1], nu=new[2])

    return init_fn, update_fn
