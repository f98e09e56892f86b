"""The port's sampling against the JAX reference's: threefry keys, random
bits and Gumbel noise bit for bit, ``masked_logits`` exactly (ties
included), and the same tokens from ``sample_tokens``, greedy and
stochastic."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import sampling as JS
from repro_torch.serve import sampling as PS

SEEDS = [0, 1, 7, 123456, 2 ** 31 - 1, 2 ** 31 + 5, -1]
MASKED_LOGITS = jax.jit(JS.masked_logits)
SAMPLE_TOKENS = jax.jit(JS.sample_tokens)


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_keys_and_bits_bitwise(seed):
    kj = jax.random.PRNGKey(seed)
    kt = PS.prng_key(seed)
    np.testing.assert_array_equal(kt.numpy(), _u32(kj))
    for data in (0, 1, 5, 1000, 2 ** 31 + 3):
        np.testing.assert_array_equal(
            PS.fold_in(kt, data).numpy(),
            _u32(jax.random.fold_in(kj, data)))
    np.testing.assert_array_equal(
        PS.random_bits(kt[None], 4099).numpy()[0],
        _u32(jax.random.bits(kj, (4099,))))


def test_gumbel_bitwise():
    keys = [jax.random.fold_in(jax.random.PRNGKey(s), 3) for s in range(6)]
    kt = torch.stack([torch.from_numpy(_u32(k)) for k in keys])
    got = PS.gumbel(kt, 50000).numpy()
    want = np.stack([np.asarray(jax.random.gumbel(k, (50000,), jnp.float32))
                     for k in keys])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed,idx", [(0, 0), (5, 0), (5, 3), (99, 1)])
def test_request_base_key(seed, idx):
    np.testing.assert_array_equal(PS.request_base_key(seed, idx),
                                  JS.request_base_key(seed, idx))


def _rows(rng, b, V):
    """Logit rows with duplicated values (ties at any cutoff) on a coarse
    grid, so top-p masses sit far from the kept-prefix boundaries."""
    return (rng.integers(-8, 8, (b, V)) * 0.75).astype(np.float32)


SETTINGS = [  # (temperature, top_k, top_p) per row
    (0.7, 0, 1.0), (1.0, 3, 1.0), (1.3, 0, 0.6), (0.9, 5, 0.8),
    (0.0, 0, 1.0), (2.0, 1, 0.3), (1.0, 40, 1.0), (0.5, 2, 0.95)]


def test_masked_logits_equal_ties_included(rng):
    b, V = len(SETTINGS), 40
    logits = _rows(rng, b, V)
    temps, top_ks, top_ps = (np.asarray(c) for c in zip(*SETTINGS))
    temps, top_ps = temps.astype(np.float32), top_ps.astype(np.float32)
    top_ks = top_ks.astype(np.int32)
    want = np.asarray(MASKED_LOGITS(jnp.asarray(logits), jnp.asarray(temps),
                                    jnp.asarray(top_ks), jnp.asarray(top_ps)))
    got = PS.masked_logits(torch.from_numpy(logits), torch.from_numpy(temps),
                           torch.from_numpy(top_ks),
                           torch.from_numpy(top_ps)).numpy()
    np.testing.assert_array_equal(got, want)
    # the tie budget: a row never keeps more than top_k tokens
    kept = (got > np.finfo(np.float32).min).sum(-1)
    for row, (_, k, _) in enumerate(SETTINGS):
        if k:
            assert kept[row] <= k


@pytest.mark.parametrize("stochastic", [False, True])
def test_sample_tokens_same_tokens(rng, stochastic):
    b, V = len(SETTINGS), 64
    draws = 0
    for step in range(6):
        logits = rng.normal(size=(b, V)).astype(np.float32) * 2
        temps = np.asarray([s[0] for s in SETTINGS], np.float32)
        if not stochastic:
            temps[:] = 0.0
        top_ks = np.asarray([s[1] for s in SETTINGS], np.int32)
        top_ps = np.asarray([s[2] for s in SETTINGS], np.float32)
        keys = np.stack([JS.request_base_key(100 + i) for i in range(b)])
        steps = np.full(b, step, np.int32)
        want = np.asarray(SAMPLE_TOKENS(
            jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks),
            jnp.asarray(top_ps), jnp.asarray(keys), jnp.asarray(steps)))
        got = PS.sample_tokens(
            torch.from_numpy(logits), torch.from_numpy(temps),
            torch.from_numpy(top_ks), torch.from_numpy(top_ps),
            torch.from_numpy(keys.astype(np.int64)),
            torch.from_numpy(steps)).numpy()
        np.testing.assert_array_equal(got, want)
        draws += int((got != logits.argmax(-1)).sum())
    assert (draws > 0) == stochastic, "stochastic rows never left argmax"


BAD = [dict(temperature=float("nan")), dict(top_p=float("inf")),
       dict(temperature=-0.1), dict(top_k=-1), dict(top_p=0.0),
       dict(top_p=1.5), dict(n=0), dict(max_tokens=0)]


@pytest.mark.parametrize("bad", BAD, ids=lambda d: next(iter(d)))
def test_sampling_params_validate_like_reference(bad):
    with pytest.raises(ValueError) as want:
        JS.SamplingParams(**bad).validate()
    with pytest.raises(ValueError) as got:
        PS.SamplingParams(**bad).validate()
    assert str(got.value) == str(want.value)
    PS.SamplingParams(temperature=0.8, top_k=5, top_p=0.9).validate()
