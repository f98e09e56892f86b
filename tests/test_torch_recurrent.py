"""The port's RG-LRU block (``repro_torch.models.recurrent``) against the
reference's (``repro.models.recurrent``) on the same numpy inputs from a
seed: the causal conv with and without its state, the log-depth scan
against ``jax.lax.associative_scan``, the gates, the whole block from a
zero and from a carried state, step by step against whole, in float32
within 2e-5 and in bfloat16 within 2e-2 of the output's largest magnitude.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_util import one_torch_thread  # noqa: F401 (autouse fixture)
from port_util import np32
from recurrent_util import cfgs
from repro.models import recurrent as JR
from repro_torch.models import recurrent as R

TOL = dict(atol=2e-5, rtol=2e-5)
# the reference's functions jitted (eager JAX compiles op by op, 5-15x
# slower on the CPU); configs and dtypes are static
conv_ref = jax.jit(JR._conv1d_causal)
scan_ref = jax.jit(JR.rglru_scan)
gates_ref = jax.jit(JR._gates, static_argnums=2)
rglru_ref = jax.jit(JR.apply_rglru, static_argnums=(0, 3))


def _cfg():
    return cfgs("rgemma")


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _params(seed=0):
    """The reference's ``rglru_init`` (numpy) and the same values as the
    port's tensors."""
    jcfg, _ = _cfg()
    jp = jax.device_get(jax.jit(JR.rglru_init, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def test_init_matches_reference_tree():
    """Shapes, dtypes and the distributions' reach: lam puts
    ``sigmoid(lam) ** 8`` in [0.9, 0.999], the gates' std is 1/sqrt(H)."""
    jcfg, cfg = _cfg()
    jp, _ = _params()
    gen = torch.Generator().manual_seed(0)
    mine = R.rglru_init(cfg, gen, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in mine.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in jp.items()}
    a = torch.sigmoid(mine["lam"]) ** 8
    assert 0.9 - 1e-6 <= float(a.min()) and float(a.max()) <= 0.999 + 1e-6
    assert mine["lam"].dtype == torch.float32
    bf = R.rglru_init(cfg, gen, "cpu", torch.bfloat16)
    assert bf["lam"].dtype == torch.float32
    assert bf["in_x"].dtype == torch.bfloat16


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 2, 9])
def test_conv1d_causal_matches_reference(s, with_state):
    rng = np.random.default_rng(s)
    K, w = 4, 16
    cw, cb = _rand(rng, K, w), _rand(rng, w)
    x = _rand(rng, 2, s, w)
    st = _rand(rng, 2, K - 1, w) if with_state else None
    jy, jst = conv_ref(jnp.asarray(cw), jnp.asarray(cb), jnp.asarray(x),
                       None if st is None else jnp.asarray(st))
    y, new = R._conv1d_causal(torch.from_numpy(cw), torch.from_numpy(cb),
                              torch.from_numpy(x),
                              None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(np32(y), np32(jy), **TOL)
    np.testing.assert_array_equal(np32(new), np32(jst))


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("s", [1, 7, 64])
def test_scan_matches_associative_scan(s, h0):
    """The doubling scan against the reference's ``associative_scan``
    (products in another order: 2e-5, not bitwise), a in (0, 1) as the
    gates make it."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 24)).astype(np.float32)
    b = _rand(rng, 2, s, 24)
    h = _rand(rng, 2, 24) if h0 else None
    want = scan_ref(jnp.asarray(a), jnp.asarray(b),
                    None if h is None else jnp.asarray(h))
    got = R.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                       None if h is None else torch.from_numpy(h))
    np.testing.assert_allclose(np32(got), np32(want), **TOL)
    # and the recurrence written out
    ref, prev = [], (h if h0 else np.zeros((2, 24), np.float32))
    for t in range(s):
        prev = a[:, t] * prev + b[:, t]
        ref.append(prev)
    np.testing.assert_allclose(np32(got), np.stack(ref, 1), **TOL)


def test_gates_match_reference():
    jcfg, _ = _cfg()
    jp, pp = _params()
    xc = _rand(np.random.default_rng(2), 2, 5, jcfg.d_model)
    ja, jm = gates_ref(jp, jnp.asarray(xc), jcfg.num_heads)
    a, m = R._gates(pp, torch.from_numpy(xc), jcfg.num_heads)
    np.testing.assert_allclose(np32(a), np32(ja), **TOL)
    np.testing.assert_allclose(np32(m), np32(jm), **TOL)


def _block_inputs(s, dtype, cache, seed=3):
    jcfg, _ = _cfg()
    rng = np.random.default_rng(seed)
    x = _rand(rng, 2, s, jcfg.d_model)
    c = None
    if cache:
        c = {"conv": _rand(rng, 2, jcfg.conv_width - 1, jcfg.d_model),
             "h": _rand(rng, 2, jcfg.d_model)}
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jc = None if c is None else {k: jnp.asarray(v, jdt) for k, v in c.items()}
    pc = None if c is None else {k: torch.from_numpy(v).to(dtype)
                                 for k, v in c.items()}
    return x, jc, pc, jdt


def _close(got, want, dtype):
    g, w = np32(got), np32(want)
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-2 * max(1.0, np.abs(w).max()))
    else:
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cache", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("s", [1, 12])
def test_apply_rglru_matches_reference(s, cache, dtype):
    """The whole block from zeros or a carried (conv, h) state; with a
    state and one token, the decode step. Output and new state."""
    jcfg, _ = _cfg()
    jp, pp = _params()
    x, jc, pc, jdt = _block_inputs(s, dtype, cache)
    jout, jnew = rglru_ref(jcfg, jp, jnp.asarray(x), jdt, jc)
    out, new = R.apply_rglru(jcfg, pp, torch.from_numpy(x), dtype, pc)
    assert out.dtype == dtype and new["h"].dtype == dtype
    _close(out, jout, dtype)
    for k in ("conv", "h"):
        _close(new[k], jnew[k], dtype)


def test_steps_equal_whole():
    """12 decode steps from a zero cache give the whole scan's outputs and
    final state (within float32 rounding)."""
    jcfg, _ = _cfg()
    _, pp = _params()
    x, _, _, _ = _block_inputs(12, torch.float32, False)
    x = torch.from_numpy(x)
    whole, last = R.apply_rglru(jcfg, pp, x, torch.float32)
    cache = R.rglru_init_cache(jcfg, 2, torch.float32, "cpu")
    outs = []
    for t in range(12):
        o, cache = R.apply_rglru(jcfg, pp, x[:, t:t + 1], torch.float32,
                                 cache)
        outs.append(o)
    np.testing.assert_allclose(np32(torch.cat(outs, 1)), np32(whole), **TOL)
    # the projections of one token and of twelve agree to float32 rounding
    for k in ("conv", "h"):
        np.testing.assert_allclose(np32(cache[k]), np32(last[k]), **TOL)


def test_init_cache_matches_reference():
    jcfg, cfg = _cfg()
    jc = JR.rglru_init_cache(jcfg, 3, jnp.bfloat16)
    c = R.rglru_init_cache(cfg, 3, torch.bfloat16, "cpu")
    for k in ("conv", "h"):
        assert tuple(c[k].shape) == jc[k].shape and c[k].dtype == \
            torch.bfloat16 and not c[k].any()
