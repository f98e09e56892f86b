"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the
reference's (``repro.models.xlstm``) on the same numpy inputs from a seed:
the chunkwise mLSTM at chunks of 1, 4 and 16 (and the reference's
one-chunk fallback) against the reference's and against the recurrent
oracle, the recurrent step, the group norm, both blocks whole, from a
carried cache and one step at a time, and the caches' -1e30 stabilizers;
float32 within 2e-5, bfloat16 within 2e-2 of the output's largest
magnitude. And ROADMAP C13: the whole stack at the reference's own init,
both packages against a float64 run of the port.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_util import one_torch_thread  # noqa: F401 (autouse fixture)
from port_util import np32
from recurrent_util import cfgs
from repro.models import xlstm as JX
from repro_torch.models import xlstm as X

TOL = dict(atol=2e-5, rtol=2e-5)
# the reference's functions jitted (eager JAX compiles op by op, 4-5x
# slower on the CPU); configs, dtypes and the chunk are static
chunkwise_ref = jax.jit(JX.mlstm_chunkwise, static_argnames=("chunk",))
recurrent_ref = jax.jit(JX.mlstm_recurrent)
group_norm_ref = jax.jit(JX._group_norm, static_argnums=2)
mlstm_ref = jax.jit(JX.apply_mlstm_block, static_argnums=(0, 3),
                    static_argnames=("chunk",))
slstm_ref = jax.jit(JX.apply_slstm_block, static_argnums=(0, 3))
INIT_REF = {"mlstm": jax.jit(JX.mlstm_block_init, static_argnums=1),
            "slstm": jax.jit(JX.slstm_block_init, static_argnums=1)}


def _cfg():
    return cfgs("xlstm")


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _qkv(s, seed=0, b=2, H=2, hd=8):
    rng = np.random.default_rng(seed)
    q, k, v = (_rand(rng, b, s, H, hd) for _ in range(3))
    i_raw = _rand(rng, b, s, H)
    f_raw = _rand(rng, b, s, H) + 2.0
    return q, k, v, i_raw, f_raw


def _state(seed, b=2, H=2, hd=8):
    rng = np.random.default_rng(seed)
    return (_rand(rng, b, H, hd, hd, scale=0.3), _rand(rng, b, H, hd),
            _rand(rng, b, H))


def _both(xs):
    return [jnp.asarray(x) for x in xs], [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("state", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("chunk", [1, 4, 16, 5])
def test_mlstm_chunkwise_matches_reference(chunk, state):
    """16 positions at chunks of 1, 4 and 16, and 5 (no divisor: one chunk
    of 16, the reference's rule); from a fresh state or a carried one; h
    and the state against the reference's chunkwise form and against the
    step-by-step recurrence."""
    xs = _qkv(16)
    st = _state(1) if state else None
    (jq, jk, jv, ji, jf), (q, k, v, i, f) = _both(xs)
    jst = None if st is None else tuple(jnp.asarray(x) for x in st)
    pst = None if st is None else tuple(torch.from_numpy(x) for x in st)
    jh, jnew = chunkwise_ref(jq, jk, jv, ji, jf, jst, chunk=chunk)
    h, new = X.mlstm_chunkwise(q, k, v, i, f, pst, chunk=chunk)
    np.testing.assert_allclose(np32(h), np32(jh), **TOL)
    for a, b in zip(new, jnew):
        np.testing.assert_allclose(np32(a), np32(b), **TOL)
    # the oracle: the same h, and the same state once the stabilizer m,
    # which the two forms pick differently, is multiplied back in
    rh, rnew = X.mlstm_recurrent(q, k, v, i, f, pst)
    np.testing.assert_allclose(np32(h), np32(rh), rtol=1e-4, atol=1e-4)
    unstab = lambda st_: (
        np32(st_[0]) * np.exp(np32(st_[2]))[..., None, None],
        np32(st_[1]) * np.exp(np32(st_[2]))[..., None])
    for a, b in zip(unstab(new), unstab(rnew)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_mlstm_recurrent_matches_reference():
    xs = _qkv(6, seed=4)
    st = _state(5)
    (jq, jk, jv, ji, jf), (q, k, v, i, f) = _both(xs)
    jh, jnew = recurrent_ref(jq, jk, jv, ji, jf,
                             tuple(jnp.asarray(x) for x in st))
    h, new = X.mlstm_recurrent(q, k, v, i, f,
                               tuple(torch.from_numpy(x) for x in st))
    np.testing.assert_allclose(np32(h), np32(jh), **TOL)
    for a, b in zip(new, jnew):
        np.testing.assert_allclose(np32(a), np32(b), **TOL)


def test_group_norm_matches_reference():
    rng = np.random.default_rng(6)
    x, sc = _rand(rng, 2, 3, 32), _rand(rng, 32)
    np.testing.assert_allclose(
        np32(X._group_norm(torch.from_numpy(x), torch.from_numpy(sc), 4)),
        np32(group_norm_ref(jnp.asarray(x), jnp.asarray(sc), 4)), **TOL)


@functools.lru_cache(maxsize=None)
def _block(kind, seed=0):
    """(reference params (numpy), port params) of an mLSTM or sLSTM block
    from the reference's init, the zero biases redrawn small so that a
    missing add shows."""
    jcfg, _ = _cfg()
    jp = jax.device_get(INIT_REF[kind](jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 7)
    for k in list(jp):
        if k.startswith("b_") or k == "conv_b":
            jp[k] = (np.asarray(jp[k]) + rng.normal(size=jp[k].shape) * 0.1
                     ).astype(np.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _apply(kind, side):
    if side == "ref":
        return mlstm_ref if kind == "mlstm" else slstm_ref
    return X.apply_mlstm_block if kind == "mlstm" else X.apply_slstm_block


def _leaves(out, cache):
    return [np32(out)] + jax.tree.leaves(_numpy_tree(cache))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_blocks_match_reference(kind, dtype):
    """A block over 8 positions from a fresh state, then one decode step
    from its cache: outputs and every cache leaf. (The chunkwise form from
    a carried state: ``test_mlstm_chunkwise_matches_reference``.) float32
    within 2e-5 of the reference; bfloat16 by 7c's rule, no further from
    the reference's float32 run than twice the reference's own bf16 run
    is: the gates' exponentials and the group norm amplify bf16 rounding
    (one element of an mLSTM block's bf16 output parts from the
    reference's by 0.037 at a scale of 1.7 on these inputs)."""
    jcfg, cfg = _cfg()
    jp, pp = _block(kind)
    x = _rand(np.random.default_rng(8), 2, 9, jcfg.d_model)
    kw = dict(chunk=4) if kind == "mlstm" else {}
    jfn, fn = _apply(kind, "ref"), _apply(kind, "port")
    jc = j32 = c = None
    for lo, hi in ((0, 8), (8, 9)):
        xs = x[:, lo:hi]
        out, c = fn(cfg, pp, torch.from_numpy(xs), dtype, c, **kw)
        assert out.dtype == dtype
        got = _leaves(out, c)
        if dtype == torch.float32:
            jout, jc = jfn(jcfg, jp, jnp.asarray(xs), jnp.float32, jc, **kw)
            want = _leaves(jout, jax.device_get(jc))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, **TOL)
            continue
        jout, jc = jfn(jcfg, jp, jnp.asarray(xs), jnp.bfloat16, jc, **kw)
        jo32, j32 = jfn(jcfg, jp, jnp.asarray(xs), jnp.float32, j32, **kw)
        want = _leaves(jout, jax.device_get(jc))
        ref32 = _leaves(jo32, jax.device_get(j32))
        assert len(got) == len(want) == len(ref32)
        for a, b, r in zip(got, want, ref32):
            assert np.abs(a - r).max() <= 2 * np.abs(b - r).max() + 1e-6


def _numpy_tree(c):
    """A port cache entry as numpy leaves in the reference's tree."""
    if isinstance(c, dict):
        return {k: _numpy_tree(v) for k, v in c.items()}
    if isinstance(c, tuple):
        return tuple(_numpy_tree(v) for v in c)
    return np32(c)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_and_cache_match_reference(kind):
    """Block inits' shapes and dtypes (sLSTM's FFN width int(4 d / 3)),
    and the caches: conv inputs in the compute dtype, float32 states, the
    stabilizer m at -1e30."""
    jcfg, cfg = _cfg()
    jp, _ = _block(kind)
    init = X.mlstm_block_init if kind == "mlstm" else X.slstm_block_init
    mine = init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: v.shape for k, v in jp.items()}
    if kind == "slstm":
        assert mine["up1"].shape[1] == int(cfg.d_model * 4 / 3)
    jinit = JX.mlstm_init_cache if kind == "mlstm" else JX.slstm_init_cache
    pinit = X.mlstm_init_cache if kind == "mlstm" else X.slstm_init_cache
    jc = jax.device_get(jinit(jcfg, 3, jnp.bfloat16))
    c = pinit(cfg, 3, torch.bfloat16, "cpu")
    got, want = jax.tree.leaves(_numpy_tree(c)), jax.tree.leaves(jc)
    assert [a.shape for a in got] == [b.shape for b in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    assert c["conv"].dtype == torch.bfloat16
    state = c["state"]
    m = state[2] if kind == "mlstm" else state["m"]
    assert m.dtype == torch.float32 and bool((m == -1e30).all())


@contextlib.contextmanager
def _float64_everywhere():
    """Widen the port's float32 casts (``Tensor.float`` and
    ``torch.float32``, which the xLSTM blocks take for gates, stabilizers
    and states) to float64 while open: a float64 run of the same code."""
    to_float, f32 = torch.Tensor.float, torch.float32
    torch.Tensor.float, torch.float32 = torch.Tensor.double, torch.float64
    try:
        yield
    finally:
        torch.Tensor.float, torch.float32 = to_float, f32


def test_c13_float32_parting_is_rounding_at_the_references_init():
    """ROADMAP C13: reduced xlstm (8 blocks) at the reference's own init,
    ten prompts of 64 tokens (seeds 0-9) in one batch, mLSTM chunks of 64.
    The two packages' float32 logits part by more than 2e-5, and each sits
    about as far from a float64 run of the port: the port's largest error
    against it is no larger than the reference's, so the parting is the
    float32 rounding of an ill-conditioned stack, not the port's error."""
    from repro.models.model import Model as JModel
    from repro.models.model import ModelOptions as JOpts
    from repro_torch import bridge
    from repro_torch.models.model import Model, ModelOptions
    jcfg, cfg = cfgs("xlstm")
    jmodel = JModel(jcfg, JOpts(mlstm_chunk=64))
    jp = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    toks = np.concatenate([np.random.default_rng(s).integers(
        0, cfg.vocab_size, (2, 64)) for s in range(10)]).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, t: jmodel.logits(p, {"tokens": t})[
        0])(jp, jnp.asarray(toks)))
    params = bridge.params_from_jax(cfg, jp, device="cpu")
    got = Model(cfg, ModelOptions(mlstm_chunk=64), device="cpu").logits(
        params, torch.from_numpy(toks)).numpy()
    with _float64_everywhere():
        model64 = Model(cfg, ModelOptions(
            mlstm_chunk=64, compute_dtype=torch.float64,
            param_dtype=torch.float64), device="cpu")
        exact = model64.logits(jax.tree.map(lambda x: x.double(), params),
                               torch.from_numpy(toks)).numpy()
    assert exact.dtype == np.float64
    port_err, ref_err = np.abs(got - exact).max(), np.abs(want - exact).max()
    assert np.abs(got - want).max() > 2e-5
    assert port_err <= ref_err, (port_err, ref_err)
