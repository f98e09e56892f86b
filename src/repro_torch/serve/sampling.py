"""Stochastic sampling for the serving engine: params, masking, RNG streams.

Counterpart of ``repro.serve.sampling``. Every request carries a
:class:`SamplingParams`; the scheduler threads the per-slot vectors
(temperature, top-k, top-p, RNG key, step) into one :func:`sample_tokens`
call per tick.

RNG contract (what makes preempt-and-recompute exact): each sample owns a
counter-based key stream derived only from constants of the request,

    base_key = fold_in(PRNGKey(seed), sample_idx)
    step_key = fold_in(base_key, j)          # j = index of the output token

and token j is always drawn with ``step_key(j)``. The keys, the random bits
and the Gumbel noise are JAX's own (threefry2x32, partitionable bit layout,
as JAX 0.9 uses by default), computed here on int64 tensors, so a
stochastic stream equals the reference's draw for draw.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode controls.

    temperature: 0.0 = greedy (exact argmax); > 0 scales logits.
    top_k: keep the k highest logits (0 = off).
    top_p: nucleus sampling, keep the smallest descending-probability
        prefix with cumulative mass >= top_p (1.0 = off).
    n: parallel samples per prompt (the port serves n = 1 so far).
    seed: root of the request's counter-based RNG stream.
    max_tokens: overrides Request.max_new_tokens when set.
    stop: extra stop-token ids.
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    n: int = 1
    seed: int = 0
    max_tokens: Optional[int] = None
    stop: Tuple[int, ...] = ()

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def validate(self) -> None:
        # NaN fails every comparison, so check finiteness explicitly
        if not math.isfinite(self.temperature):
            raise ValueError(
                f"temperature must be finite (got {self.temperature})")
        if not math.isfinite(self.top_p):
            raise ValueError(f"top_p must be finite (got {self.top_p})")
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0 (got {self.temperature})")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (got {self.top_k})")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1] (got {self.top_p})")
        if self.n < 1:
            raise ValueError(f"n must be >= 1 (got {self.n})")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1 (got {self.max_tokens})")


# ---------------------------------------------------------------------------
# threefry2x32 (JAX's PRNG), on int64 tensors holding uint32 words
# ---------------------------------------------------------------------------

def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block cipher (20 rounds) on uint32 words held in
    int64 tensors; key words k0, k1 broadcast against counters x0, x1."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (32-bit seeds): (2,) int64 [0, seed]."""
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} is out of the 32-bit range")
    return torch.tensor([0, seed & _M32], dtype=torch.int64)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: keys (..., 2) int64, data (...)
    integers -> (..., 2) int64."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & _M32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` (uint32) per key: keys (b, 2) ->
    (b, n) int64. Partitionable layout: element i is
    ``y0 ^ y1`` of the cipher at counter (hi32(i), lo32(i))."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    y0, y1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], i >> 32, i & _M32)
    return y0 ^ y1


def _fma(a, b, c):
    # a float32 fused multiply-add: the float32 product is exact in
    # float64, so rounding the float64 sum once gives fma(a, b, c)
    return (a.double() * b.double() + c.double()).float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal float32 values, computed as the JAX
    reference's CPU backend computes it (the Cephes polynomial XLA emits
    for ``logf``), so that Gumbel noise matches the reference bit for bit;
    ``torch.log`` differs from it in the last bit about one time in seven."""
    m, e = torch.frexp(x)
    e = e.float()
    small = m < 0.707106781186547524
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    x2 = x * x
    x3 = x2 * x
    p = [7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
         -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
         2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1]
    c = lambda v: torch.full_like(x, v)
    y = _fma(x, c(p[0]), c(p[1]))
    y1 = _fma(x, c(p[3]), c(p[4]))
    y2 = _fma(x, c(p[6]), c(p[7]))
    y = _fma(y, x, c(p[2]))
    y1 = _fma(y1, x, c(p[5]))
    y2 = _fma(y2, x, c(p[8]))
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * -2.12194440e-4)
    x = _fma(c(-0.5), x2, x)
    x = x + y
    return _fma(e, c(0.693359375), x)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` per key (the default "low"
    mode): (b, 2) keys -> (b, n) float32."""
    tiny = torch.finfo(torch.float32).tiny
    bits = random_bits(keys, n)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    u = mant.view(torch.float32) - 1.0
    u = torch.clamp(u + tiny, min=tiny)          # uniform on [tiny, 1)
    return -xla_log(-xla_log(u))


@lru_cache(maxsize=4096)
def _base_key_cached(seed: int, sample_idx: int) -> Tuple[int, int]:
    k = fold_in(prng_key(seed), sample_idx)
    return int(k[0]), int(k[1])


def request_base_key(seed: int, sample_idx: int = 0) -> np.ndarray:
    """The (2,) uint32 root key of one sample's stream (host-side, cached)."""
    return np.asarray(_base_key_cached(int(seed), int(sample_idx)), np.uint32)


def step_keys(base_keys: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Per-row step keys ``fold_in(base_keys[i], steps[i])``: (b, 2), (b,)."""
    return fold_in(base_keys, steps)


# ---------------------------------------------------------------------------
# masking and the draw
# ---------------------------------------------------------------------------

def masked_logits(logits, temps, top_ks, top_ps):
    """Temperature-scale then top-k / top-p mask a batch of logit rows.

    logits: (b, V); temps, top_ks, top_ps: (b,). Returns (b, V) float32
    logits with excluded tokens at the float32 minimum. Both filters keep a
    prefix of the descending-sorted row, described by one cutoff value and
    a tie budget: tokens tied at the cutoff survive in index order, only as
    many as the kept-prefix length allows (a stable-argsort oracle's
    choice), so duplicated logits can never keep more than k tokens."""
    logits = logits.float()
    V = logits.shape[-1]
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    sorted_desc = -torch.sort(-scaled, dim=-1).values
    rank = torch.arange(V, device=logits.device)[None, :]
    k = torch.where(top_ks <= 0, V, torch.clamp(top_ks, max=V))[:, None]
    keep = rank < k
    # the reference's softmax: exp(x - max) / sum
    e = torch.exp(sorted_desc - sorted_desc.max(dim=-1, keepdim=True).values)
    probs = e / e.sum(dim=-1, keepdim=True)
    mass_before = torch.cumsum(probs, dim=-1) - probs    # exclusive cumsum
    # p >= 1 disables nucleus filtering outright: a float32 cumsum can round
    # to 1.0 before the tail
    keep &= (mass_before < top_ps[:, None]) | (top_ps[:, None] >= 1.0)
    keep[:, 0] = True                                    # never mask rank 0
    n_keep = keep.sum(dim=-1, keepdim=True)              # a prefix
    cutoff = torch.gather(sorted_desc, -1, n_keep - 1)
    above = scaled > cutoff
    tie = scaled == cutoff
    tie_budget = n_keep - above.sum(dim=-1, keepdim=True)
    tie_rank = torch.cumsum(tie.int(), dim=-1) - 1       # index-order rank
    neg = torch.finfo(torch.float32).min
    return torch.where(above | (tie & (tie_rank < tie_budget)), scaled,
                       torch.full_like(scaled, neg))


def sample_tokens(logits, temps, top_ks, top_ps, base_keys, steps):
    """One token per row from heterogeneous per-row sampling params.

    logits: (b, V); temps / top_ks / top_ps: (b,); base_keys: (b, 2) int64
    uint32 words; steps: (b,) output-token indices. Rows at temperature 0
    take the exact argmax; the others draw
    ``argmax(masked_logits + gumbel(fold_in(base, step)))``, which is
    ``jax.random.categorical``. Returns (b,) int64 tokens."""
    logits = logits.float()
    greedy = logits.argmax(dim=-1)
    ml = masked_logits(logits, temps, top_ks, top_ps)
    g = gumbel(step_keys(base_keys, steps), logits.shape[-1])
    drawn = (g + ml).argmax(dim=-1)
    return torch.where(temps <= 0.0, greedy, drawn)
