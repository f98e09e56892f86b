"""The port's model against the JAX reference's, on the reference's
``tiny_lm`` weights and fused task tables carried over by the bridge.

``mixed_step`` must give logits within 2e-5 of the reference's and write the
same K/V (within 2e-5; page 0, the dead tokens' scratch page, excluded)
for a decode-only tick, one prefill chunk, and several chunks with decode
rows and dead padding; its greedy decode tokens must equal the reference's
``decode_step`` tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_util import (both, jax_peft, jax_tasks, np32, port_lm, port_tables,
                       port_tasks_peft)
from repro_torch.models.model import Model

TOL = dict(atol=2e-5, rtol=2e-5)
N_TASKS, BS, NB, NPAGES = 3, 4, 24, 4          # pool: 16 tokens per slot


@pytest.fixture(scope="module")
def lm(tiny_lm):
    cfg, jmodel, jparams = tiny_lm
    tasks = jax_tasks(cfg, jparams, N_TASKS)
    model, params = port_lm(tiny_lm)
    return cfg, jmodel, jparams, tasks, model, params, port_tables(tasks)


def test_bridge_carries_every_weight(lm):
    cfg, _, jparams, tasks, model, params, tables = lm
    assert Model.param_count(params) == sum(
        x.size for x in jax.tree.leaves(jparams))
    g = jparams["groups"][0]["b0"]
    np.testing.assert_array_equal(params["embed"]["tok"].numpy(),
                                  np.asarray(jparams["embed"]["tok"]))
    assert len(params["layers"]) == cfg.num_layers
    for i, lp in enumerate(params["layers"]):
        np.testing.assert_array_equal(lp["attn"]["wq"].numpy(),
                                      np.asarray(g["attn"]["wq"][i]))
        np.testing.assert_array_equal(lp["mlp"]["wd"].numpy(),
                                      np.asarray(g["mlp"]["wd"][i]))
    assert tables["table"].shape == (cfg.num_layers, N_TASKS, cfg.vocab_size,
                                     cfg.d_model)
    for t in range(N_TASKS):
        np.testing.assert_array_equal(tables["table"][:, t].numpy(),
                                      np.asarray(tasks[t]["table"]))


# (token_rows, token_pos) over 3 slots; slot depths before the tick are
# 9, 5 and 0 resident tokens (slot 2 is empty)
PACKINGS = {
    "decode_only": ([0, 1], [9, 5]),
    "one_chunk": ([2, 2, 2, 2, 2, 2], [0, 1, 2, 3, 4, 5]),
    "chunks_decode_dead": ([0, 1, 1, 1, 2, 2, 2, 0, 0],
                           [9, 5, 6, 7, 0, 1, 2, -1, -1]),
}
DEPTHS = [9, 5, 0]


def _pool(rng, cfg):
    """Random resident K/V in scrambled pages, as numpy."""
    shape = (cfg.num_layers, NB, BS, cfg.num_kv_heads, cfg.head_dim)
    bt = np.zeros((3, NPAGES), np.int32)
    avail = list(rng.permutation(np.arange(1, NB)))
    for s in range(3):
        for j in range(NPAGES):
            bt[s, j] = avail.pop()
    return rng.normal(size=shape), rng.normal(size=shape), bt


@pytest.mark.parametrize("packing", sorted(PACKINGS))
def test_mixed_step_matches_reference(rng, lm, packing):
    cfg, jmodel, jparams, tasks, model, params, tables = lm
    rows, pos = PACKINGS[packing]
    T = len(rows)
    k, v, bt = _pool(rng, cfg)
    tokens = rng.integers(0, cfg.vocab_size, (T, 1)).astype(np.int32)
    task_of_slot = np.asarray([2, 0, 1], np.int32)
    token_tasks = task_of_slot[np.asarray(rows)]
    lidx = np.zeros(3, np.int32)
    for t, (r, p) in enumerate(zip(rows, pos)):
        if p >= 0:
            lidx[r] = t                 # each slot reports its last token
    (kj, kt), (vj, vt) = both(k), both(v)
    ints = [both(np.asarray(a, np.int32))
            for a in (tokens, rows, pos, bt, token_tasks, lidx)]
    (tokj, tokt), (rj, rt), (pj, pt), (btj, btt), (tkj, tkt), (lj, lt) = ints
    jcache = [{"b0": {"k": kj, "v": vj}}]
    lg_j, cache_j = jmodel.mixed_step(jparams, tokj, rj, pj, jcache,
                                      jax_peft(tasks, tkj), block_tables=btj,
                                      logit_idx=lj)
    peft = port_tasks_peft(tables, tkt)
    cache = {"k": kt.clone(), "v": vt.clone()}
    lg, cache = model.mixed_step(params, tokt, rt, pt, cache, peft,
                                 block_tables=btt, logit_idx=lt)
    live = sorted({r for r, p in zip(rows, pos) if p >= 0})
    np.testing.assert_allclose(np32(lg)[live], np32(lg_j)[live], **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(np32(cache[name])[:, 1:],
                                   np32(cache_j[0]["b0"][name])[:, 1:], **TOL)


def test_decode_tokens_equal_reference_decode_step(rng, lm):
    """Greedy tokens from the port's mixed_step (decode tokens only) equal
    the reference's paged decode_step tokens."""
    cfg, jmodel, jparams, tasks, model, params, tables = lm
    k, v, bt = _pool(rng, cfg)
    depths = np.asarray(DEPTHS[:2] + [3], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    task_ids = np.asarray([1, 2, 0], np.int32)
    (kj, kt), (vj, vt) = both(k), both(v)
    (tokj, tokt), (dj, dt), (btj, btt), (tj, tt) = [
        both(a) for a in (tokens, depths, bt, task_ids)]
    lg_j, _ = jmodel.decode_step(jparams, tokj, dj, [{"b0": {"k": kj, "v": vj}}],
                                 jax_peft(tasks, tj), block_tables=btj)
    rows = torch.arange(3, dtype=torch.int32)
    peft = port_tasks_peft(tables, tt)
    lg, _ = model.mixed_step(params, tokt, rows, dt, {"k": kt, "v": vt}, peft,
                             block_tables=btt, logit_idx=rows)
    np.testing.assert_array_equal(lg.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(lg_j[:, -1], -1)))
    np.testing.assert_allclose(np32(lg), np32(lg_j[:, -1]), **TOL)
