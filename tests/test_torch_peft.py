"""The port's PEFT serving, the methods of the paper's Fig. 3 overhead
comparison, against the JAX reference's ``ServeEngine(peft=...)``.

The reference's ``tiny_lm`` weights and its PEFT parameters (drawn with
``repro.core.peft.init``, every leaf then redrawn as normals x 0.1 so that
each method changes the output) are carried over by the bridge. The
reference runs with ``attn_impl="pallas"`` (its Pallas kernels in interpret
mode; P-Tuning v2's prefill goes to its XLA path, as the reference sends
``q_offset`` there); the port runs its kernels' plain versions. For each
method: prefill logits and cache, three decode steps, ``generate`` tokens
and ``Model.logits`` within 2e-5 in float32 (LoRA within the reference's
own 2e-4 / 1e-4, ``tests/test_serve.py``), greedy tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_util import both, np32, port_lm
from repro.core import aot as jax_aot
from repro.core import peft as jpeft
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions as JModelOptions
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.core import peft as port_peft
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.scheduler import (ContinuousScheduler, InvalidConfig,
                                         SchedulerConfig)

from test_torch_model import PACKINGS, _pool
from test_torch_prefill import kernel_checks  # noqa: F401 (a fixture)

METHODS = ["none", "aot", "bitfit", "lora", "adapters", "ptv2"]
TOL = dict(atol=2e-5, rtol=2e-5)
LORA_TOL = dict(atol=2e-4, rtol=1e-4)       # the reference's own, for LoRA
MAX_LEN, B, S, STEPS, PROMPT_LEN = 40, 3, 12, 3, 4


def _tol(method):
    return LORA_TOL if method.startswith("lora") else TOL


def jax_bundle(cfg, jparams, method):
    """The reference's bundle for ``method`` (None for the backbone)."""
    if method == "none":
        return None
    if method == "aot":         # one task's fused tables, (L, V, d)
        opt = jpeft.PEFTOptions(method="aot",
                                aot=jax_aot.AoTOptions(mode="fused"))
        return jpeft.make({"aot": jax_aot.random_fused(
            cfg, jparams["embed"]["tok"], seed=7)}, opt)
    opt = jpeft.PEFTOptions(method=method, prompt_len=PROMPT_LEN,
                            lora_rank=4, adapter_rank=8)
    pp = jpeft.init(jax.random.PRNGKey(1), cfg, opt)
    leaves, tree = jax.tree.flatten(pp)
    keys = jax.random.split(jax.random.PRNGKey(3), len(leaves))
    pp = jax.tree.unflatten(tree, [jax.random.normal(k, x.shape) * 0.1
                                   for k, x in zip(keys, leaves)])
    return jpeft.make(pp, opt)


def port_bundle(bundle):
    if bundle is None:
        return None
    return bridge.peft_from_jax(jax.device_get(bundle["params"]),
                                bundle["opt"], device="cpu")


@pytest.fixture(scope="module")
def lm(tiny_lm):
    cfg, _, jparams = tiny_lm
    jmodel = JModel(cfg, JModelOptions(attn_impl="pallas"))
    model, params = port_lm(tiny_lm)
    return cfg, jmodel, jparams, model, params


@pytest.fixture(scope="module")
def engines(lm):
    """method -> (reference engine, port engine, port bundle)."""
    cfg, jmodel, jparams, model, params = lm
    out = {}
    for method in METHODS:
        jb = jax_bundle(cfg, jparams, method)
        pb = port_bundle(jb)
        out[method] = (
            JServeEngine(jmodel, jparams, JServeConfig(max_len=MAX_LEN),
                         peft=jb),
            ServeEngine(model, params, ServeConfig(max_len=MAX_LEN),
                        peft=pb), pb)
    return out


def _prompts(cfg, seed=5):
    rr = np.random.default_rng(seed)
    return rr.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _port_cache(cfg, jcache):
    return bridge.cache_from_jax(cfg, jax.device_get(jcache), device="cpu")


def _ref_prefill(jeng, prompts):
    return jeng._prefill(jeng.params, jnp.asarray(prompts),
                         jnp.zeros(B, jnp.int32))


@pytest.mark.parametrize("method", METHODS)
def test_prefill_and_decode_steps_match_reference(lm, engines, method):
    """Prefill logits, pos and the whole cache (P-Tuning v2's prefix in rows
    [0, p)), then three decode steps fed the reference's greedy tokens."""
    cfg = lm[0]
    jeng, eng, _ = engines[method]
    tol = _tol(method)
    prompts = _prompts(cfg)
    lg_j, cache_j, pos_j = _ref_prefill(jeng, prompts)
    lg, cache, pos = eng.model.prefill(eng.params, torch.from_numpy(prompts),
                                       eng._peft(None), max_len=eng.cache_len)
    assert pos == int(pos_j) == S + (PROMPT_LEN if method == "ptv2" else 0)
    np.testing.assert_allclose(np32(lg), np32(lg_j), **tol)
    for step in range(STEPS + 1):
        want = _port_cache(cfg, cache_j)
        for name in ("k", "v"):
            np.testing.assert_allclose(np32(cache[name]), np32(want[name]),
                                       err_msg=f"step {step}", **tol)
        if step == STEPS:
            break
        tok = np.array(jnp.argmax(lg_j[:, -1], -1), np.int32)[:, None]
        np.testing.assert_array_equal(lg[:, -1].argmax(-1).numpy(), tok[:, 0])
        lg_j, cache_j = jeng._decode(jeng.params, jnp.asarray(tok),
                                     pos_j + step, cache_j,
                                     jnp.zeros(B, jnp.int32))
        lg, cache = eng.model.decode_step(eng.params, torch.from_numpy(tok),
                                          pos + step, cache, eng._peft(None))
        np.testing.assert_allclose(np32(lg), np32(lg_j),
                                   err_msg=f"step {step}", **tol)


@pytest.mark.parametrize("method", METHODS)
def test_generate_tokens_equal_reference(lm, engines, method):
    jeng, eng, _ = engines[method]
    prompts = _prompts(lm[0], seed=9)
    want = jeng.generate(prompts, 6)
    got = eng.generate(prompts, 6)
    assert got.shape == (B, 6) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert eng.num_tasks is None and jeng.num_tasks is None


@pytest.mark.parametrize("method", METHODS)
def test_logits_match_reference(lm, engines, method):
    """``Model.logits`` (the whole-sequence forward Fig. 3 times), BitFit's
    ``final`` bias included; ``prefill`` leaves that bias out, as in the
    reference, so only BitFit's last logits differ from the prefill's."""
    cfg, jmodel, jparams, model, params = lm
    jeng, eng, pb = engines[method]
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    ref = jax.jit(lambda p, t: jmodel.logits(p, {"tokens": t}, jeng.peft))
    want, _ = ref(jparams, jnp.asarray(tokens))
    got = model.logits(params, torch.from_numpy(tokens), pb)
    assert got.shape == (2, 10, cfg.vocab_size)
    np.testing.assert_allclose(np32(got), np32(want), **_tol(method))
    last, _, _ = model.prefill(params, torch.from_numpy(tokens), pb,
                               max_len=MAX_LEN)
    differs = not np.allclose(np32(got[:, -1:]), np32(last), **TOL)
    assert differs == (method == "bitfit")


def test_fused_lora_matches_unfused_and_reference(lm, engines):
    """``fuse_lora_into`` against the unfused bundle (the reference's
    tolerance) and its weights against the reference's fusion; the fused
    engine generates the reference's fused engine's tokens."""
    cfg, jmodel, jparams, model, params = lm
    jeng, _, pb = engines["lora"]
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    fused = port_peft.fuse_lora_into(params, pb["params"], cfg, pb["opt"])
    np.testing.assert_allclose(np32(model.logits(fused, tokens)),
                               np32(model.logits(params, tokens, pb)),
                               **LORA_TOL)
    jfused = jpeft.fuse_lora_into(jparams, jeng.peft["params"], cfg,
                                  jeng.peft["opt"])
    want = bridge.params_from_jax(cfg, jax.device_get(jfused), device="cpu")
    for i, lp in enumerate(fused["layers"]):
        for w in ("wq", "wk", "wv", "wo"):
            np.testing.assert_allclose(np32(lp["attn"][w]),
                                       np32(want["layers"][i]["attn"][w]),
                                       atol=1e-6, rtol=1e-6)
    wk = fused["layers"][0]["attn"]["wk"]
    assert wk is params["layers"][0]["attn"]["wk"]
    assert not torch.equal(fused["layers"][0]["attn"]["wq"],
                           params["layers"][0]["attn"]["wq"])
    prompts = _prompts(cfg, seed=6)
    got = ServeEngine(model, fused, ServeConfig(max_len=MAX_LEN)).generate(
        prompts, 4)
    ref = JServeEngine(jeng.model, jfused, JServeConfig(max_len=MAX_LEN))
    np.testing.assert_array_equal(got, ref.generate(prompts, 4))


@pytest.mark.parametrize("method", ["bitfit", "lora", "adapters"])
def test_mixed_step_with_peft_matches_reference(rng, lm, engines, method):
    """One paged tick (chunks, decode rows and dead tokens) with the
    method's hooks in every layer."""
    cfg, jmodel, jparams, model, params = lm
    jeng, _, pb = engines[method]
    rows, pos = PACKINGS["chunks_decode_dead"]
    T = len(rows)
    k, v, bt = _pool(rng, cfg)
    tokens = rng.integers(0, cfg.vocab_size, (T, 1)).astype(np.int32)
    lidx = np.zeros(3, np.int32)
    for t, (r, p) in enumerate(zip(rows, pos)):
        if p >= 0:
            lidx[r] = t
    (kj, kt), (vj, vt) = both(k), both(v)
    (tokj, tokt), (rj, rt), (pj, pt), (btj, btt), (lj, lt) = [
        both(np.asarray(a, np.int32)) for a in (tokens, rows, pos, bt, lidx)]
    lg_j, cache_j = jmodel.mixed_step(jparams, tokj, rj, pj,
                                      [{"b0": {"k": kj, "v": vj}}],
                                      jeng.peft, block_tables=btj,
                                      logit_idx=lj)
    lg, cache = model.mixed_step(params, tokt, rt, pt,
                                 {"k": kt.clone(), "v": vt.clone()}, pb,
                                 block_tables=btt, logit_idx=lt)
    live = sorted({r for r, p in zip(rows, pos) if p >= 0})
    np.testing.assert_allclose(np32(lg)[live], np32(lg_j)[live],
                               **_tol(method))
    for name in ("k", "v"):        # page 0: the dead tokens' scratch page
        np.testing.assert_allclose(np32(cache[name])[:, 1:],
                                   np32(cache_j[0]["b0"][name])[:, 1:],
                                   **_tol(method))


def test_ptv2_refuses_the_paged_paths(lm, engines):
    """The reference's paged and ragged steps skip the prefix silently;
    the port raises, and its scheduler refuses a ptv2 engine as the
    reference's does."""
    cfg, _, _, model, params = lm
    _, eng, pb = engines["ptv2"]
    pool = model.init_paged_cache(8, 4)
    bt = torch.arange(1, 7, dtype=torch.int32).view(3, 2)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="paged pool"):
        model.decode_step(params, torch.ones(3, 1, dtype=torch.int32),
                          i32([0, 3, 6]), pool, pb, block_tables=bt)
    with pytest.raises(NotImplementedError, match="paged pool"):
        model.mixed_step(params, torch.ones(2, 1, dtype=torch.int32),
                         i32([0, 1]), i32([0, 0]), pool, pb, block_tables=bt,
                         logit_idx=i32([0, 1, 1]))
    for layout in ("paged", "slots"):
        with pytest.raises(InvalidConfig, match="static batches"):
            ContinuousScheduler(eng, SchedulerConfig(kv_layout=layout))


def test_single_table_engine_equals_one_task_engine(lm, engines):
    """One task's tables served as a bundle (the single-table gather-add)
    and as the only task of stacked tables (the multi-task one): the same
    logits bitwise and the same tokens."""
    cfg, _, _, model, params = lm
    _, single, pb = engines["aot"]
    table = pb["params"]["aot"]["table"]
    stacked = ServeEngine(model, params, ServeConfig(max_len=MAX_LEN),
                          fused_tasks={"table": table[:, None].contiguous()})
    prompts = _prompts(cfg, seed=8)
    toks = torch.from_numpy(prompts)
    zeros = torch.zeros(B, dtype=torch.int32)
    lg_1, cache_1, _ = model.prefill(params, toks, single._peft(zeros),
                                     max_len=MAX_LEN)
    lg_n, cache_n, _ = model.prefill(params, toks, stacked._peft(zeros),
                                     max_len=MAX_LEN)
    assert torch.equal(lg_1, lg_n) and torch.equal(cache_1["k"],
                                                   cache_n["k"])
    np.testing.assert_array_equal(single.generate(prompts, 5),
                                  stacked.generate(prompts, 5))
    assert stacked.num_tasks == 1 and single.num_tasks is None


@pytest.mark.parametrize("method", ["aot", "ptv2"])
def test_peft_paths_hand_their_kernels_what_they_take(lm, engines, method,
                                                      kernel_checks):
    """The static batch with one task's tables (the single-table
    gather-add, once per layer per call) or a P-Tuning v2 prefix (flash
    with q_offset) passes every kernel's argument checks."""
    cfg = lm[0]
    ops, L = kernel_checks, cfg.num_layers
    _, eng, _ = engines[method]
    eng.generate(_prompts(cfg), 2)
    assert ops.launches() == dict(
        ops.launches(), flash_attention=L, decode_attention=2 * L,
        aot_gather_add=3 * L if method == "aot" else 0,
        aot_gather_add_multitask=0)


@pytest.mark.parametrize("method", METHODS)
def test_init_matches_reference_shapes(lm, method):
    """``core.peft.init``: the reference's leaves, shapes and zeros (the
    draws are the port's own)."""
    cfg = lm[0]
    kw = dict(prompt_len=PROMPT_LEN, lora_rank=4, adapter_rank=8,
              aot=jax_aot.AoTOptions(mode="fused"))
    want = jpeft.init(jax.random.PRNGKey(0), cfg,
                      jpeft.PEFTOptions(method=method, **kw))
    opt = port_peft.PEFTOptions(
        method=method, **dict(kw, aot=port_peft.AoTOptions(mode="fused")))
    got = port_peft.init(cfg, opt, seed=0, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(g.shape) == w.shape, path
        assert bool((g == 0).all()) == bool((w == 0).all()), path
    assert port_peft.make(got, opt)["method"] == method
