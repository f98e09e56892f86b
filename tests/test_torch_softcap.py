"""The attention softcap (``tanh(s / softcap) * softcap``, a config's
``logit_softcap``) in the port against the JAX reference, on a reduced
smollm-360m with ``logit_softcap=30.0`` and the reference's weights
carried over by the bridge, in float32 within 2e-5: the whole-sequence
logits on each ``attn_impl`` (the kernel path sends softcap to
``attention_chunked``, as the reference's wrapper does), prefill then a
contiguous decode step, a paged decode step and a mixed tick (softcap
goes to the plain decode, paged and ragged walks, as in the reference;
no kernel is launched). A control shows the cap changes the logits by
more than the tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_util import both, np32
from repro import configs as jconfigs
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions as JOptions
from repro_torch import bridge
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models.model import Model, ModelOptions

TOL = dict(atol=2e-5, rtol=2e-5)
CAP = 30.0
B, S, MAX_LEN = 3, 12, 16


def _scaled(tree, key=None):
    if isinstance(tree, dict):
        return {k: _scaled(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_scaled(v) for v in tree]
    return tree * 8.0 if key in ("wq", "wk") else tree


@pytest.fixture(scope="module")
def capped():
    jcfg = jconfigs.reduced(jconfigs.get("smollm-360m"),
                            repeats=2).replace(logit_softcap=CAP)
    cfg = configs.reduced(configs.get("smollm-360m"),
                          repeats=2).replace(logit_softcap=CAP)
    jmodel = JModel(jcfg, JOptions(chunk_q=8, chunk_kv=8))
    # larger scores, so that the cap bites: q and k projections times 8
    host = _scaled(jax.device_get(jmodel.init(jax.random.PRNGKey(0))))
    jparams = jax.tree.map(jnp.asarray, host)
    params = bridge.params_from_jax(cfg, host, device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, jmodel, jparams, params, tokens


@pytest.mark.parametrize("impl", ["kernel", "chunked", "ref"])
def test_logits_match_reference(capped, impl):
    cfg, jmodel, jparams, params, tokens = capped
    want = jmodel.logits(jparams, {"tokens": jnp.asarray(tokens)})[0]
    model = Model(cfg, ModelOptions(attn_impl=impl, chunk_q=8, chunk_kv=8),
                  device="cpu")
    ops.reset_launches()
    got = model.logits(params, torch.from_numpy(tokens))
    np.testing.assert_allclose(np32(got), np32(want), **TOL)
    if impl == "kernel":
        assert ops.chunked_calls() == cfg.num_layers
    # the control: without the cap the logits move by more than TOL
    plain = Model(cfg.replace(logit_softcap=0.0),
                  ModelOptions(attn_impl=impl), device="cpu")
    off = plain.logits(params, torch.from_numpy(tokens))
    assert float((off - got).abs().max()) > 1e-3


def test_prefill_then_decode_match_reference(capped):
    cfg, jmodel, jparams, params, tokens = capped
    lg_j, cache_j, pos_j = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(tokens)}, max_len=MAX_LEN)
    model = Model(cfg, device="cpu")
    lg, cache, pos = model.prefill(params, torch.from_numpy(tokens),
                                   max_len=MAX_LEN)
    np.testing.assert_allclose(np32(lg), np32(lg_j), **TOL)
    assert pos == int(pos_j)
    nxt = np.asarray([[5], [17], [99]], np.int32)
    dl_j, _ = jmodel.decode_step(jparams, jnp.asarray(nxt), pos_j, cache_j)
    ops.reset_launches()
    dl, _ = model.decode_step(params, torch.from_numpy(nxt), pos, cache)
    np.testing.assert_allclose(np32(dl), np32(dl_j), **TOL)
    assert sum(ops.launches().values()) == 0


def _pool(cfg, rng, nb=16, bs=4, npages=4, slots=3):
    shape = (cfg.num_layers, nb, bs, cfg.num_kv_heads, cfg.head_dim)
    bt = rng.permutation(np.arange(1, nb))[:slots * npages]
    return (rng.normal(size=shape), rng.normal(size=shape),
            bt.reshape(slots, npages).astype(np.int32))


def test_paged_decode_matches_reference(capped):
    cfg, jmodel, jparams, params, _ = capped
    rng = np.random.default_rng(1)
    k, v, bt = _pool(cfg, rng)
    depths = np.asarray([9, 5, 14], np.int32)
    tokens = np.asarray([[9], [41], [2]], np.int32)
    (kj, kt), (vj, vt) = both(k), both(v)
    lg_j, _ = jmodel.decode_step(jparams, jnp.asarray(tokens),
                                 jnp.asarray(depths),
                                 [{"b0": {"k": kj, "v": vj}}],
                                 block_tables=jnp.asarray(bt))
    model = Model(cfg, device="cpu")
    lg, _ = model.decode_step(params, torch.from_numpy(tokens),
                              torch.from_numpy(depths), {"k": kt, "v": vt},
                              block_tables=torch.from_numpy(bt))
    np.testing.assert_allclose(np32(lg), np32(lg_j), **TOL)


def test_mixed_tick_matches_reference(capped):
    cfg, jmodel, jparams, params, _ = capped
    rng = np.random.default_rng(2)
    k, v, bt = _pool(cfg, rng)
    rows = np.asarray([0, 1, 1, 1, 2, 2, 2, 0, 0], np.int32)
    pos = np.asarray([9, 5, 6, 7, 0, 1, 2, -1, -1], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (len(rows), 1)).astype(np.int32)
    lidx = np.asarray([0, 3, 6], np.int32)
    (kj, kt), (vj, vt) = both(k), both(v)
    ints = [both(a) for a in (tokens, rows, pos, bt, lidx)]
    (tokj, tokt), (rj, rt), (pj, pt), (btj, btt), (lj, lt) = ints
    lg_j, cache_j = jmodel.mixed_step(jparams, tokj, rj, pj,
                                      [{"b0": {"k": kj, "v": vj}}],
                                      block_tables=btj, logit_idx=lj)
    model = Model(cfg, device="cpu")
    lg, cache = model.mixed_step(params, tokt, rt, pt,
                                 {"k": kt.clone(), "v": vt.clone()},
                                 block_tables=btt, logit_idx=lt)
    np.testing.assert_allclose(np32(lg), np32(lg_j), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(np32(cache[name])[:, 1:],
                                   np32(cache_j[0]["b0"][name])[:, 1:], **TOL)
