"""The port's whole-prompt prefill, decode step and static batch against the
JAX reference's, on the reference's ``tiny_lm`` weights and fused task
tables carried over by the bridge.

The reference runs with ``attn_impl="pallas"`` (its Pallas kernels in
interpret mode: flash attention in the prefill, the contiguous or paged
decode kernel in the decode step); the port runs its kernels' plain
versions. Logits and caches must agree within 2e-5 and greedy tokens must
be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_util import jax_peft, jax_tasks, np32, port_lm, port_tables
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions as JModelOptions
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.serve.engine import ServeConfig, ServeEngine

TOL = dict(atol=2e-5, rtol=2e-5)
MAX_LEN, N_TASKS, B, S = 40, 3, 3, 12
TASK_IDS = np.asarray([2, 0, 1], np.int32)


@pytest.fixture(scope="module")
def engines(tiny_lm):
    cfg, _, jparams = tiny_lm
    tasks = jax_tasks(cfg, jparams, N_TASKS)
    jmodel = JModel(cfg, JModelOptions(attn_impl="pallas"))
    jeng = JServeEngine(jmodel, jparams, JServeConfig(max_len=MAX_LEN),
                        fused_tasks=tasks)
    model, params = port_lm(tiny_lm)
    eng = ServeEngine(model, params, ServeConfig(max_len=MAX_LEN),
                      fused_tasks=port_tables(tasks))
    return cfg, tasks, jeng, eng


def _prompts(cfg, seed=5):
    rr = np.random.default_rng(seed)
    return rr.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _peft(eng, task_ids):
    return eng._peft(torch.from_numpy(np.asarray(task_ids, np.int32)))


def _port_cache(cfg, jcache):
    return bridge.cache_from_jax(cfg, jax.device_get(jcache), device="cpu")


def _same_cache(cfg, cache, jcache):
    want = _port_cache(cfg, jcache)
    for name in ("k", "v"):
        np.testing.assert_allclose(np32(cache[name]), np32(want[name]),
                                   **TOL)


@pytest.mark.parametrize("last_pos", [None, 7])
def test_prefill_matches_reference(engines, last_pos):
    cfg, _, jeng, eng = engines
    prompts = _prompts(cfg)
    tids = jnp.asarray(TASK_IDS)
    if last_pos is None:
        lg_j, cache_j, pos_j = jeng._prefill(jeng.params,
                                             jnp.asarray(prompts), tids)
    else:
        lg_j, cache_j, pos_j = jeng._prefill_at(
            jeng.params, jnp.asarray(prompts), jnp.int32(last_pos), tids)
    lg, cache, pos = eng.model.prefill(
        eng.params, torch.from_numpy(prompts), _peft(eng, TASK_IDS),
        max_len=eng.cache_len, last_pos=last_pos)
    assert pos == int(pos_j) == S
    assert lg.shape == tuple(lg_j.shape) == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(np32(lg), np32(lg_j), **TOL)
    assert cache["k"].shape == (cfg.num_layers, B, MAX_LEN,
                                cfg.num_kv_heads, cfg.head_dim)
    _same_cache(cfg, cache, cache_j)


@pytest.fixture(scope="module")
def prefilled(engines):
    """The reference's prefill cache of ``_prompts`` (the decode tests'
    common start)."""
    cfg, _, jeng, _ = engines
    _, cache_j, _ = jeng._prefill(jeng.params, jnp.asarray(_prompts(cfg)),
                                  jnp.asarray(TASK_IDS))
    return cache_j


@pytest.mark.parametrize("pos", [S, [S, S - 3, 5]],
                         ids=["scalar", "per_row"])
def test_contiguous_decode_step_matches_reference(engines, prefilled, pos):
    cfg, _, jeng, eng = engines
    tokens = np.asarray([[3], [77], [120]], np.int32)
    pos_j = jnp.int32(pos) if isinstance(pos, int) else \
        jnp.asarray(pos, jnp.int32)
    lg_j, cache_j = jeng._decode(jeng.params, jnp.asarray(tokens), pos_j,
                                 prefilled, jnp.asarray(TASK_IDS))
    pos_t = pos if isinstance(pos, int) else \
        torch.tensor(pos, dtype=torch.int32)
    lg, cache = eng.model.decode_step(
        eng.params, torch.from_numpy(tokens), pos_t,
        _port_cache(cfg, prefilled), _peft(eng, TASK_IDS))
    np.testing.assert_allclose(np32(lg), np32(lg_j), **TOL)
    np.testing.assert_array_equal(lg[:, -1].argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(lg_j[:, -1], -1)))
    _same_cache(cfg, cache, cache_j)


def test_paged_decode_step_matches_reference(engines, prefilled):
    """A pool filled from the prefill (each row's resident positions in
    scrambled pages), one paged decode step in both packages."""
    cfg, tasks, jeng, eng = engines
    bs, npages, nb = 4, 4, 16
    depths = np.asarray([S, 9, 5], np.int32)      # the new token's rows
    rr = np.random.default_rng(11)
    dense = {n: np.asarray(prefilled[0]["b0"][n]) for n in ("k", "v")}
    pool = {n: rr.normal(size=(cfg.num_layers, nb, bs) + d.shape[3:])
            .astype(np.float32) for n, d in dense.items()}
    bt = rr.permutation(np.arange(1, nb))[:B * npages].reshape(B, npages)
    bt = bt.astype(np.int32)
    for n in ("k", "v"):
        for b in range(B):
            for p in range(depths[b]):
                pool[n][:, bt[b, p // bs], p % bs] = dense[n][:, b, p]
    tokens = np.asarray([[9], [41], [2]], np.int32)

    @jax.jit
    def ref_step(params, tok, pos, cache, tids, tables):
        return jeng.model.decode_step(params, tok, pos, cache,
                                      jax_peft(tasks, tids),
                                      block_tables=tables)
    jpool = [{"b0": {n: jnp.asarray(pool[n]) for n in ("k", "v")}}]
    lg_j, cache_j = ref_step(jeng.params, jnp.asarray(tokens),
                             jnp.asarray(depths), jpool,
                             jnp.asarray(TASK_IDS), jnp.asarray(bt))
    cache = {n: torch.from_numpy(pool[n].copy()) for n in ("k", "v")}
    lg, cache = eng.model.decode_step(
        eng.params, torch.from_numpy(tokens), torch.from_numpy(depths),
        cache, _peft(eng, TASK_IDS), block_tables=torch.from_numpy(bt))
    np.testing.assert_allclose(np32(lg), np32(lg_j), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(np32(cache[n]), np32(cache_j[0]["b0"][n]),
                                   **TOL)
    # the paged step is the contiguous step on the same rows
    lg_c, _ = eng.model.decode_step(
        eng.params, torch.from_numpy(tokens), torch.from_numpy(depths),
        _port_cache(cfg, prefilled), _peft(eng, TASK_IDS))
    np.testing.assert_allclose(np32(lg), np32(lg_c), **TOL)


def test_cache_from_jax_orders_layers(tiny_lm):
    cfg, jmodel, _ = tiny_lm
    jcache = jmodel.init_cache(2, 8)
    marked = jax.tree.map(
        lambda x: x + jnp.arange(x.shape[0], dtype=x.dtype).reshape(
            (-1,) + (1,) * (x.ndim - 1)), jcache)
    cache = bridge.cache_from_jax(cfg, jax.device_get(marked), device="cpu")
    assert cache["k"].shape == (cfg.num_layers, 2, 8, cfg.num_kv_heads,
                                cfg.head_dim)
    for i in range(cfg.num_layers):
        assert bool((cache["v"][i] == i).all())


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "one_task"])
def test_generate_tokens_equal_reference(engines, mixed):
    cfg, _, jeng, eng = engines
    prompts = _prompts(cfg, seed=9)
    task_ids = TASK_IDS if mixed else None
    want = jeng.generate(prompts, 6, task_ids)
    d0 = eng.dispatches
    got = eng.generate(prompts, 6, task_ids)
    assert got.shape == (B, 6) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert eng.dispatches == d0, "generate counts no dispatch (as reference)"


@pytest.fixture()
def kernel_checks(monkeypatch):
    """Route each ``ops`` wrapper through its CUDA entry point's argument
    checks (types, shapes, contiguity: everything but the device, which no
    CPU tensor passes) and then its plain version, counting launches."""
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "_on_cpu", lambda *xs: False)
    for fn in ops.WRAPPERS:
        name = fn.__name__
        kernel = getattr(ops, f"{name}_kernel")
        plain = getattr(ops, f"{name}_plain")

        def checked(*a, kernel=kernel, plain=plain, **kw):
            with pytest.raises(ValueError, match="needs CUDA tensors"):
                kernel(*a, **kw)
            return plain(*a, **kw)
        monkeypatch.setattr(ops, f"{name}_kernel", checked)
    ops.reset_launches()
    yield ops
    ops.reset_launches()


def test_every_path_hands_its_kernels_what_they_take(engines, kernel_checks):
    """The whole-prompt prefill of one bucket-padded prompt, the slotted
    decode, the static batch and a paged decode step give every kernel
    arguments its CUDA entry point accepts, one launch per layer."""
    cfg, _, _, eng = engines
    ops, L = kernel_checks, cfg.num_layers
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = _prompts(cfg)[0, :11]
    first, cache = eng.prefill_request(toks, 11, 2)
    assert ops.launches()["flash_attention"] == L
    ops.reset_launches()
    eng.decode_mixed(np.asarray([[first[0]], [5]], np.int32),
                     np.asarray([11, 0], np.int32),
                     {n: c.expand(-1, 2, -1, -1, -1).contiguous()
                      for n, c in cache.items()}, np.asarray([2, 0], np.int32))
    assert ops.launches()["decode_attention"] == L
    ops.reset_launches()
    eng.generate(_prompts(cfg), 2, TASK_IDS)
    assert ops.launches() == dict(
        ops.launches(), flash_attention=L, decode_attention=2 * L,
        aot_gather_add_multitask=3 * L)
    ops.reset_launches()
    pool = {n: torch.zeros(L, 8, 4, cfg.num_kv_heads, cfg.head_dim)
            for n in ("k", "v")}
    eng.model.decode_step(eng.params, torch.ones(B, 1, dtype=torch.int32),
                          torch.tensor([0, 3, 6], dtype=torch.int32), pool,
                          _peft(eng, TASK_IDS),
                          block_tables=torch.arange(1, 7, dtype=torch.int32)
                          .view(B, 2))
    assert ops.launches()["paged_decode_attention"] == L
