"""The port's decoder variants against the JAX reference, on reduced
configs (2 layers, d 64) with the reference's weights carried by the
bridge: olmo-1b's non-parametric pre-LN, qwen2.5-14b's QKV bias (seeded
non-zero biases, so a missing add shows) and untied head, h2o-danube-1.8b's
sliding window with its ring-buffered decode cache, GeGLU and the
embeddings' sqrt(d) scale.

The reference runs with ``attn_impl="pallas"`` (its Pallas kernels in
interpret mode, as ``tests/test_models_smoke.py`` and the other port tests
run it); the port runs its kernels' plain versions. float32 results agree
within 2e-5 and greedy tokens are equal. ROADMAP C7: where the reference's
bucket-padded prefill of a prompt longer than the window keeps padding in
its ring, the port is held to the reference's unpadded ``Model.logits``,
and the reference's padded path is shown to be off.
"""
import dataclasses
import functools
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_util import jax_peft, jax_tasks, np32, port_tables, port_tasks_peft
from repro import configs as jconfigs
from repro.core import aot as JA
from repro.core import peft as JP
from repro.data.pipeline import LMStream
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions as JOpts
from repro.serve import recovery as jrec
from repro.serve import scheduler as jsched
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.sampling import SamplingParams as JSampling
from repro.train import step as JS
from repro_torch import bridge, configs
from repro_torch import tree as T
from repro_torch.launch import serve as launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import model as model_mod
from repro_torch.models.model import Model, ModelOptions
from repro_torch.serve import recovery as rec
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.kv_pool import SlotKVPool
from repro_torch.serve.sampling import SamplingParams
from repro_torch.train import step as PS

NAMES = ["olmo-1b", "qwen2.5-14b", "h2o-danube-1.8b"]
DANUBE = "h2o-danube-1.8b"
GEGLU = "geglu"             # reduced smollm-360m with GeGLU and embed_scale
TOL = dict(atol=2e-5, rtol=2e-5)
METHODS = ["none", "aot", "aot4", "bitfit", "lora", "adapters", "ptv2"]
B, S = 2, 20
REF = SimpleNamespace(name="reference", S=jsched, R=jrec, Sampling=JSampling)
PORT = SimpleNamespace(name="port", S=sched_mod, R=rec,
                       Sampling=SamplingParams)


def _cfgs(name, window=0):
    """The reference's and the port's reduced config of ``name``."""
    out = []
    for mod in (jconfigs, configs):
        base = "smollm-360m" if name == GEGLU else name
        cfg = mod.reduced(mod.get(base), repeats=2)
        if name == GEGLU:
            cfg = cfg.replace(mlp_type="geglu", embed_scale=True)
        if window:
            cfg = cfg.replace(sliding_window=window)
        out.append(cfg)
    return out


@functools.lru_cache(maxsize=None)
def setup(name, window=0):
    """(port cfg, reference model, reference params, port model, port
    params): the reference's init (qwen2.5's QKV biases redrawn as seeded
    normals x 0.1), carried into the port by the bridge."""
    jcfg, cfg = _cfgs(name, window)
    jmodel = JModel(jcfg, JOpts(attn_impl="pallas"))
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(11)
        attn = jparams["groups"][0]["b0"]["attn"]
        for b in ("bq", "bk", "bv"):
            attn[b] = (rng.normal(size=attn[b].shape) * 0.1).astype(
                np.float32)
    model = Model(cfg, ModelOptions(), device="cpu")
    params = bridge.params_from_jax(cfg, jparams, device="cpu")
    return cfg, jmodel, jparams, model, params


def _tokens(cfg, b=B, s=S, seed=5):
    rr = np.random.default_rng(seed)
    return rr.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _bundles(cfg, jparams, method, classify=False):
    """(reference bundle, port bundle) for ``method``; ``aot4``: four
    stacked fused tasks with per-row task ids. ``classify`` adds a seeded
    classification head to both."""
    if method == "none":
        opt = JP.PEFTOptions(method="none")
        jb = JP.make({}, opt)
    elif method in ("aot", "aot4"):
        tasks = jax_tasks(cfg, jparams, 1 if method == "aot" else 4)
        tids = np.arange(B, dtype=np.int32) % len(tasks)
        if method == "aot":
            jb = JP.make({"aot": tasks[0]}, JP.PEFTOptions(
                method="aot", aot=JA.AoTOptions(mode="fused")))
        else:
            jb = jax_peft(tasks, jnp.asarray(tids))
            pb = port_tasks_peft(port_tables(tasks), torch.from_numpy(tids))
    else:
        opt = JP.PEFTOptions(method=method, prompt_len=4, lora_rank=4,
                             adapter_rank=8)
        pp = JP.init(jax.random.PRNGKey(1), cfg, opt)
        leaves, tree = jax.tree.flatten(pp)
        keys = jax.random.split(jax.random.PRNGKey(3), len(leaves))
        jb = JP.make(jax.tree.unflatten(tree, [
            jax.random.normal(k, x.shape) * 0.1
            for k, x in zip(keys, leaves)]), opt)
    jb = dict(jb, params=jax.device_get(dict(jb["params"])))
    if classify:
        rng = np.random.default_rng(9)
        jb["params"]["head"] = {
            "w": (rng.normal(size=(cfg.d_model, 3)) * 0.1).astype(np.float32),
            "b": (rng.normal(size=3) * 0.1).astype(np.float32)}
    if method == "aot4":
        if classify:
            pb = dict(pb, params=dict(pb["params"], head={
                k: torch.from_numpy(v) for k, v in
                jb["params"]["head"].items()}))
        return jb, pb
    return jb, bridge.peft_from_jax(jb["params"], jb["opt"], device="cpu")


# ---------------------------------------------------------------------------
# configs, init, the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_config_copies_equal_reference(name):
    """The port's config files and ``reduced`` keep every field of the
    reference's (qkv_bias, norm_type, rope_theta, the window cut to
    min(window, 16) among them)."""
    assert dataclasses.asdict(configs.get(name)) == dataclasses.asdict(
        jconfigs.get(name))
    jcfg, cfg = _cfgs(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    full = configs.get(name)
    assert (cfg.qkv_bias, cfg.norm_type, cfg.rope_theta) == (
        full.qkv_bias, full.norm_type, full.rope_theta)
    assert cfg.sliding_window == min(full.sliding_window, 16)
    Model(full, device="cpu")           # check_supported accepts it


@pytest.mark.parametrize("change,match", [
    # the two front-ends, the bidirectional prefix and softcap are ported:
    # an unknown front-end, audio frames under a head tied to the token
    # table they lack, and a prefix over recurrent blocks are still refused
    (dict(frontend="video_frames"), "frontend"),
    (dict(frontend="audio_frames", tie_embeddings=True), "frontend"),
    (dict(prefix_lm_len=4, pattern_unit=("rglru",)), "prefix"),
    (dict(attn_kind="swa", sliding_window=0), "attention")],
    ids=["change1-frontend", "change2-frontend", "change3-prefix",
         "change4-attention"])
def test_check_supported_still_refuses(change, match):
    cfg = configs.reduced(configs.get("smollm-360m")).replace(**change)
    with pytest.raises(NotImplementedError, match=match):
        model_mod.check_supported(cfg)


def test_check_supported_accepts_softcap():
    """Softcap runs on the plain attention paths (tests/test_torch_softcap.py
    holds them against the reference)."""
    cfg = configs.reduced(configs.get("smollm-360m")).replace(
        logit_softcap=30.0)
    model_mod.check_supported(cfg)
    model_mod.check_servable(cfg)


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "xlstm-350m"])
def test_check_supported_accepts_recurrent_stacks(name):
    """The recurrent block kinds (RG-LRU, mLSTM, sLSTM) and xLSTM's lack of
    positions are ported: both full configs pass both checks."""
    model_mod.check_supported(configs.get(name))
    model_mod.check_servable(configs.get(name))


@pytest.mark.parametrize("name", NAMES + [GEGLU])
def test_init_tree_matches_reference(name):
    """``Model.init`` gives the reference's tree: shapes and dtypes of
    every leaf (qwen2.5's float32 QKV biases, olmo's empty norm dicts)."""
    cfg, jmodel, jparams, model, _ = setup(name)
    mine = bridge.params_to_jax(cfg, model.init(0))
    shapes = lambda t: jax.tree.map(lambda x: (x.shape, str(x.dtype)), t)
    assert shapes(mine) == shapes(jparams)
    assert jax.tree.structure(mine) == jax.tree.structure(jparams)
    if name == "qwen2.5-14b":
        bf = Model(cfg, ModelOptions(param_dtype=torch.bfloat16),
                   device="cpu").init(0)
        assert bf["layers"][0]["attn"]["bq"].dtype == torch.float32
        assert bf["layers"][0]["attn"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["olmo-1b", "qwen2.5-14b"])
def test_bridge_round_trip(name):
    """params_from_jax then params_to_jax gives the reference's tree back
    bitwise, olmo's empty norms (``{}`` for ln1, ln2, final_norm) and
    qwen2.5's QKV biases (kept float32 under a bf16 cast) included."""
    cfg, _, jparams, _, params = setup(name)
    back = bridge.params_to_jax(cfg, params)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    if name == "olmo-1b":
        assert params["final_norm"] == {} and all(
            lp["ln1"] == {} and lp["ln2"] == {} for lp in params["layers"])
        assert back["final_norm"] == {}
        assert back["groups"][0]["b0"]["ln1"] == {}
    else:
        bf = bridge.params_from_jax(cfg, jparams, device="cpu",
                                    dtype=torch.bfloat16)
        attn = bf["layers"][1]["attn"]
        assert attn["bk"].dtype == torch.float32
        assert attn["wk"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            attn["bk"].numpy(), jparams["groups"][0]["b0"]["attn"]["bk"][1])


# ---------------------------------------------------------------------------
# (a) whole sequences: logits and classify, every served method
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", NAMES)
def test_logits_and_classify_match_reference(name, method):
    cfg, jmodel, jparams, model, params = setup(name)
    toks = _tokens(cfg)
    jb, pb = _bundles(cfg, jparams, method, classify=True)
    want = jax.jit(lambda t: jmodel.logits(jparams, {"tokens": t}, jb)[0])(
        jnp.asarray(toks))
    got = model.logits(params, torch.from_numpy(toks), pb)
    np.testing.assert_allclose(np32(got), np32(want), **TOL)
    assert torch.equal(got.argmax(-1), torch.from_numpy(
        np.array(jnp.argmax(want, -1))).long())
    want_c = jax.jit(lambda t: jmodel.classify(jparams, {"tokens": t},
                                               jb)[0])(jnp.asarray(toks))
    got_c = model.classify(params, torch.from_numpy(toks), pb)
    np.testing.assert_allclose(np32(got_c), np32(want_c), **TOL)


# ---------------------------------------------------------------------------
# (b) danube's ring: prefill + decode steps, the cache's shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
@pytest.mark.parametrize("window,max_len", [(6, 24), (24, 24), (30, 24)],
                         ids=["ring", "ring_whole", "not_ring"])
def test_ring_prefill_and_decode_match_reference(window, max_len, per_row):
    """Prefill 8 tokens, then 16 decode steps (the ring of 6 wraps twice):
    the logits and the whole cache after every step against the
    reference's, the logits also against its whole-sequence logits (the
    SWA mask over 24 positions)."""
    cfg, jmodel, jparams, model, params = setup(DANUBE, window)
    toks = _tokens(cfg, s=24)
    full = jax.jit(lambda t: jmodel.logits(jparams, {"tokens": t})[0])(
        jnp.asarray(toks))
    jpre = jax.jit(lambda t: jmodel.prefill(jparams, {"tokens": t},
                                            max_len=max_len))
    jdec = jax.jit(lambda t, p, c: jmodel.decode_step(jparams, t, p, c))
    jlg, jcache, _ = jpre(jnp.asarray(toks[:, :8]))
    lg, cache, pos = model.prefill(params, torch.from_numpy(toks[:, :8]),
                                   max_len=max_len)
    rows = min(window, max_len)
    assert cache["k"].shape == (2, B, rows, cfg.num_kv_heads, cfg.head_dim)
    assert model.is_ring(rows) == (window <= max_len)
    assert pos == 8
    np.testing.assert_allclose(np32(lg), np32(jlg), **TOL)
    for t in range(8, 24):
        np.testing.assert_allclose(np32(lg[:, 0]), np32(full[:, t - 1]),
                                   **TOL)
        want = bridge.cache_from_jax(cfg, jax.device_get(jcache),
                                     device="cpu")
        for n in ("k", "v"):
            np.testing.assert_allclose(np32(cache[n]), np32(want[n]), **TOL)
        step = toks[:, t:t + 1]
        jp = jnp.full((B,), t, jnp.int32) if per_row else jnp.int32(t)
        pp = torch.full((B,), t) if per_row else t
        jlg, jcache = jdec(jnp.asarray(step), jp, jcache)
        lg, cache = model.decode_step(params, torch.from_numpy(step), pp,
                                      cache)
        np.testing.assert_allclose(np32(lg), np32(jlg), **TOL)


def test_ring_cache_bounded():
    """The reference's ``test_swa_ring_cache_bounded``, and the pools: the
    cache of a window-8 stack at max_len 1024 has 8 rows; the engine's
    request cache and the slotted pool have the same ring length; a
    window at least max_len leaves the cache at max_len rows, not a
    ring."""
    _, cfg = _cfgs(DANUBE, 8)
    model = Model(cfg, device="cpu")
    assert model.cache_specs(2, 1024)["k"][0][2] == 8
    jmodel = JModel(_cfgs(DANUBE, 8)[0], JOpts())
    assert jmodel.cache_specs(2, 1024)[0]["b0"]["k"].shape[2] == 8
    for max_len in (8, 9, 300, 1000):
        assert model._cache_len(max_len) == jmodel._cache_len(max_len)
    params = model.init(0)
    eng = ServeEngine(model, params, ServeConfig(max_len=1000))
    _, req_cache = eng.prefill_request(np.zeros((1, 16), np.int32), 5, 0)
    pool = SlotKVPool(model, 3, 1000)
    assert req_cache["k"].shape[2] == pool.cache["k"].shape[2] == 8
    pool.write_prefill(pool.alloc(0), req_cache, 5)
    assert pool.leak_report() == []
    assert model.cache_specs(2, 8)["k"][0][2] == 8
    assert model.cache_specs(2, 6)["k"][0][2] == 6
    assert not model.is_ring(6)


def test_ring_spans():
    for n in range(0, 30):
        for rows in (1, 3, 6, 8):
            got = {}
            for lo, hi, at in model_mod.ring_spans(n, rows):
                for j in range(lo, hi):
                    got[at + j - lo] = j
            want = {j % rows: j for j in range(max(0, n - rows), n)}
            assert got == want, (n, rows)


@pytest.mark.parametrize("method", ["ptv2", "aot", "lora"])
def test_ring_peft_prefill_and_decode_match_reference(method):
    """P-Tuning v2 on a ring (its prefix takes cache rows and is windowed
    like any position, as in the reference), AoT and LoRA: prefill of 10
    tokens into a ring of 6, then 8 decode steps, against the
    reference."""
    cfg, jmodel, jparams, model, params = setup(DANUBE, 6)
    toks = _tokens(cfg, s=18)
    jb, pb = _bundles(cfg, jparams, method)
    jlg, jcache, jpos = jax.jit(lambda t: jmodel.prefill(
        jparams, {"tokens": t}, jb, max_len=32))(jnp.asarray(toks[:, :10]))
    lg, cache, pos = model.prefill(params, torch.from_numpy(toks[:, :10]),
                                   pb, max_len=32)
    assert pos == int(jpos) == 10 + (4 if method == "ptv2" else 0)
    jdec = jax.jit(lambda t, p, c: jmodel.decode_step(jparams, t, p, c, jb))
    for t in range(10, 18):
        np.testing.assert_allclose(np32(lg), np32(jlg), **TOL)
        want = bridge.cache_from_jax(cfg, jax.device_get(jcache),
                                     device="cpu")
        np.testing.assert_allclose(np32(cache["k"]), np32(want["k"]), **TOL)
        p = pos + t - 10
        jlg, jcache = jdec(jnp.asarray(toks[:, t:t + 1]), jnp.int32(p),
                           jcache)
        lg, cache = model.decode_step(params,
                                      torch.from_numpy(toks[:, t:t + 1]), p,
                                      cache, pb)
    np.testing.assert_allclose(np32(lg), np32(jlg), **TOL)


# ---------------------------------------------------------------------------
# (c) generate and the serving streams, tick for tick
# ---------------------------------------------------------------------------

def _engines(name, max_len=48, n_tasks=3, window=0):
    cfg, jmodel, jparams, model, params = setup(name, window)
    tasks = jax_tasks(cfg, jparams, n_tasks)
    jeng = JServeEngine(jmodel, jparams, JServeConfig(max_len=max_len),
                        fused_tasks=tasks)
    eng = ServeEngine(model, params, ServeConfig(max_len=max_len),
                      fused_tasks=port_tables(tasks))
    return cfg, jeng, eng


@pytest.mark.parametrize("name", NAMES)
def test_generate_matches_reference(name):
    """The static batch: 3 prompts of 12 with mixed tasks, 20 greedy steps
    (danube's ring of 16 wraps)."""
    cfg, jeng, eng = _engines(name)
    prompts = _tokens(cfg, b=3, s=12)
    tids = np.asarray([2, 0, 1], np.int32)
    want = jeng.generate(prompts, 20, tids)
    got = eng.generate(prompts, 20, tids)
    np.testing.assert_array_equal(got, np.asarray(want))


def _workload(ns, cfg, stochastic, seed=17, lo=3, hi=17):
    rr = np.random.default_rng(seed)
    reqs = []
    for i in range(7):
        sp = None
        if stochastic:
            sp = ns.Sampling(temperature=0.8, top_p=0.9,
                             top_k=5 if i % 2 else 0, seed=60 + i)
        reqs.append(ns.S.Request(
            rid=i, prompt=rr.integers(0, cfg.vocab_size,
                                      int(rr.integers(lo, hi))).astype(
                                          np.int32),
            task_id=int(rr.integers(0, 3)),
            max_new_tokens=int(rr.integers(2, 14)), sampling=sp))
    return reqs


LAYOUTS = {
    "slots": dict(kv_layout="slots", num_slots=3, bucket_min=8),
    "paged_chunked": dict(kv_layout="paged", num_slots=3, bucket_min=8,
                          block_size=4, num_blocks=20, prefill_chunk=8),
    "paged_whole": dict(kv_layout="paged", num_slots=3, bucket_min=8,
                        block_size=4, num_blocks=14, prefill_chunk=0),
}
STREAMS = [(n, lay) for n in NAMES for lay in sorted(LAYOUTS)
           if n != DANUBE or lay == "slots"]


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("name,layout", STREAMS)
def test_streams_match_reference(name, layout, stochastic):
    """Every layout each config serves (danube: slots only, every bucket
    at most its window of 16), greedy and sampled: the scheduler's state
    after every tick, tokens and dispatches equal to the reference's."""
    from port_util import assert_traces_equal, trace_ticks
    cfg, jeng, eng = _engines(name)
    runs = []
    for ns, e in ((REF, jeng), (PORT, eng)):
        sched = trace_ticks(ns.S.ContinuousScheduler(
            e, ns.S.SchedulerConfig(**LAYOUTS[layout])))
        d0 = e.dispatches
        reqs = _workload(ns, cfg, stochastic)
        for r in reqs:
            sched.submit(r)
        sched.run()
        runs.append((sched, e.dispatches - d0, [r.out for r in reqs]))
    (jsch, jd, jout), (sch, d, out) = runs
    assert_traces_equal([jsch], [sch])
    assert sch.drain_check() == []
    assert (d, out) == (jd, jout)


# ---------------------------------------------------------------------------
# (d) ROADMAP C7: a padded bucket longer than the window
# ---------------------------------------------------------------------------

def test_c7_padded_prefill_past_the_window():
    """Window 8, max_len 32 (a ring of 8): a prompt of 10 right-padded to
    a bucket of 16 (last_pos 9), then decode steps at per-row positions
    10-13. The port's logits and tokens equal the reference's *unpadded*
    ``Model.logits`` within 2e-5; the reference's own padded path (it
    rolls the padded tail into the ring) is off by more than 0.1."""
    cfg, jmodel, jparams, model, params = setup(DANUBE, 8)
    seq = _tokens(cfg, b=1, s=14)
    full = np32(jax.jit(lambda t: jmodel.logits(jparams, {"tokens": t})[0])(
        jnp.asarray(seq)))
    padded = np.zeros((1, 16), np.int32)
    padded[0, :10] = seq[0, :10]
    jlg, jcache, _ = jax.jit(lambda t: jmodel.prefill(
        jparams, {"tokens": t}, max_len=32, last_pos=jnp.int32(9)))(
            jnp.asarray(padded))
    lg, cache, _ = model.prefill(params, torch.from_numpy(padded),
                                 max_len=32, last_pos=9)
    assert cache["k"].shape[2] == 8
    np.testing.assert_allclose(np32(lg[:, 0]), full[:, 9], **TOL)
    jdec = jax.jit(lambda t, p, c: jmodel.decode_step(jparams, t, p, c))
    ref_err = 0.0
    for t in range(10, 14):
        step = seq[:, t:t + 1]
        jlg, jcache = jdec(jnp.asarray(step), jnp.full((1,), t, jnp.int32),
                           jcache)
        lg, cache = model.decode_step(params, torch.from_numpy(step),
                                      torch.full((1,), t), cache)
        np.testing.assert_allclose(np32(lg[:, 0]), full[:, t], **TOL)
        assert int(lg[0, 0].argmax()) == int(full[0, t].argmax())
        ref_err = max(ref_err, float(np.abs(np32(jlg[:, 0]) - full[:, t])
                                     .max()))
    assert ref_err > 0.1, ref_err


def test_c7_slots_stream_equals_generate_alone():
    """The slots stream with prompts of 9-15 tokens (bucket 16) at window
    8: each request's greedy tokens equal those of its prompt alone
    through the reference's ``generate`` (no padding, so its ring is
    right) and the port's."""
    cfg, jeng, eng = _engines(DANUBE, max_len=40, window=8)
    reqs = _workload(PORT, cfg, False, seed=23, lo=9, hi=16)
    sched = sched_mod.ContinuousScheduler(eng, sched_mod.SchedulerConfig(
        kv_layout="slots", num_slots=3, bucket_min=16))
    for r in reqs:
        sched.submit(r)
    sched.run()
    assert sched.drain_check() == []
    for r in reqs:
        n = r.max_new_tokens
        tid = np.asarray([r.task_id], np.int32)
        want = np.asarray(jeng.generate(r.prompt[None], n, tid))[0]
        np.testing.assert_array_equal(eng.generate(r.prompt[None], n,
                                                   tid)[0], want)
        assert list(r.out) == want.tolist(), r.rid


# ---------------------------------------------------------------------------
# (e) sliding windows on the paged paths: refused with the reference's words
# ---------------------------------------------------------------------------

def test_swa_refused_on_every_paged_path():
    cfg, jmodel, jparams, model, params = setup(DANUBE)
    tok = np.zeros((2, 1), np.int32)
    bt = np.ones((2, 2), np.int32)
    pos = np.asarray([3, 5], np.int32)
    with pytest.raises(NotImplementedError) as ref:
        jmodel.decode_step(jparams, jnp.asarray(tok), jnp.asarray(pos),
                           jmodel.init_paged_cache(4, 4),
                           block_tables=jnp.asarray(bt))
    with pytest.raises(NotImplementedError) as mine:
        model.decode_step(params, torch.from_numpy(tok),
                          torch.from_numpy(pos), model.init_paged_cache(4, 4),
                          block_tables=torch.from_numpy(bt))
    assert str(mine.value) == str(ref.value) == model_mod.SWA_PAGED_DECODE
    rows = np.asarray([0, 1], np.int32)
    with pytest.raises(NotImplementedError) as ref:
        jmodel.mixed_step(jparams, jnp.asarray(tok), jnp.asarray(rows),
                          jnp.asarray(pos), jmodel.init_paged_cache(4, 4),
                          block_tables=jnp.asarray(bt))
    with pytest.raises(NotImplementedError) as mine:
        model.mixed_step(params, torch.from_numpy(tok),
                         torch.from_numpy(rows), torch.from_numpy(pos),
                         model.init_paged_cache(4, 4),
                         block_tables=torch.from_numpy(bt))
    assert str(mine.value) == str(ref.value) == model_mod.SWA_PAGED_TICK
    _, jeng, eng = _engines(DANUBE)
    for knobs in (dict(), dict(kv_layout="paged", prefill_chunk=8)):
        with pytest.raises(AssertionError) as ref:
            jsched.ContinuousScheduler(jeng, jsched.SchedulerConfig(**knobs))
        with pytest.raises(sched_mod.InvalidConfig) as mine:
            sched_mod.ContinuousScheduler(eng,
                                          sched_mod.SchedulerConfig(**knobs))
        assert str(mine.value) == str(ref.value)


# ---------------------------------------------------------------------------
# (f) one AoT fc training step per config under attn_impl="ref"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES + [GEGLU])
def test_aot_fc_train_step_matches_reference(name):
    """Loss within 1e-5 relative and every gradient leaf within 1e-4 of
    its largest |g| against ``jax.grad``; the parameters after one AdamW
    step (lr 1e-3) within 1e-5. Danube at 32 tokens, past its window of
    16."""
    cfg, _, jparams, _, params = setup(name)
    popt = JP.PEFTOptions(method="aot", aot=JA.AoTOptions(
        mode="fc", rank=4, dropout=0.0))
    rng = np.random.default_rng(0)
    pp = jax.device_get(jax.tree.map(lambda x: x + jnp.asarray(
        rng.normal(size=x.shape) * 0.05, x.dtype),
        JP.init(jax.random.PRNGKey(1), cfg, popt)))
    batch = LMStream(cfg.vocab_size, 32, 4, seed=0).next()
    jt = JS.TrainConfig(peft=popt, lr=1e-3, loss_chunk=8)
    bundle = bridge.peft_from_jax(pp, popt, device="cpu")
    pt = PS.TrainConfig(peft=bundle["opt"], lr=1e-3, loss_chunk=8)
    jmodel = JModel(cfg, JOpts(attn_impl="ref", remat=False))
    model = Model(cfg, ModelOptions(attn_impl="ref"), device="cpu")
    jtr, jfr = JS.split_train(jparams, pp, "aot")
    ptr, pfr = PS.split_train(params, bundle["params"], "aot")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jloss_fn = JS.make_loss_fn(jmodel, jt)
    with torch.enable_grad():
        ploss, _ = PS.make_loss_fn(model, pt)(ptr, pfr, pb, None)
        grads = torch.autograd.grad(ploss, T.leaves(ptr), allow_unused=True)
    ploss = ploss.detach()
    jloss, _ = jax.jit(jloss_fn, static_argnums=3)(jtr, jfr, jb, None)
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jg = jax.jit(jax.grad(lambda t: jloss_fn(t, jfr, jb, None)[0]))(jtr)
    pg = bridge.to_numpy(T.unflatten(ptr, list(grads))["peft"])
    flat_j = jax.tree.leaves(jax.device_get(jg)["peft"])
    flat_p = jax.tree.leaves(pg)
    assert len(flat_j) == len(flat_p)
    for a, b in zip(flat_j, flat_p):
        top = np.abs(a).max()
        assert top > 0
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * top)
    jinit, jstep = JS.make_train_step(jmodel, jt)
    pinit, pstep = PS.make_train_step(model, pt)
    js, _ = jax.jit(jstep)(jinit(jtr), jfr, jb, None)
    ps, _ = pstep(pinit(ptr), pfr, pb, None)
    for a, b in zip(jax.tree.leaves(jax.device_get(js["trainable"])),
                    jax.tree.leaves(bridge.to_numpy(ps["trainable"]))):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# (g) GeGLU and embed_scale (no registered config uses them yet)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["none", "aot4", "bitfit", "ptv2"])
def test_geglu_embed_scale_logits_match_reference(method):
    cfg, jmodel, jparams, model, params = setup(GEGLU)
    toks = _tokens(cfg)
    jb, pb = _bundles(cfg, jparams, method)
    want = jax.jit(lambda t: jmodel.logits(jparams, {"tokens": t}, jb)[0])(
        jnp.asarray(toks))
    np.testing.assert_allclose(
        np32(model.logits(params, torch.from_numpy(toks), pb)), np32(want),
        **TOL)


def test_geglu_embed_scale_aot_fc_reads_unscaled_rows():
    """AoT's fc reparametrization reads E[ids] before the sqrt(d) scale,
    as the reference's ``_embed`` hands it ``e_rows``: logits under
    attn_impl="ref" against the reference's."""
    cfg, _, jparams, _, params = setup(GEGLU)
    popt = JP.PEFTOptions(method="aot", aot=JA.AoTOptions(
        mode="fc", rank=4, dropout=0.0))
    rng = np.random.default_rng(2)
    pp = jax.device_get(jax.tree.map(lambda x: x + jnp.asarray(
        rng.normal(size=x.shape) * 0.05, x.dtype),
        JP.init(jax.random.PRNGKey(1), cfg, popt)))
    toks = _tokens(cfg)
    want = JModel(cfg, JOpts(attn_impl="ref")).logits(
        jparams, {"tokens": jnp.asarray(toks)}, JP.make(pp, popt))[0]
    got = Model(cfg, ModelOptions(attn_impl="ref"), device="cpu").logits(
        params, torch.from_numpy(toks), bridge.peft_from_jax(pp, popt,
                                                             device="cpu"))
    np.testing.assert_allclose(np32(got), np32(want), **TOL)


@pytest.mark.parametrize("layout", ["slots", "paged_chunked"])
def test_geglu_embed_scale_serving_matches_reference(layout):
    """Prefill + decode (generate) and a stream through the paged tick or
    the slots, with the embeddings scaled in every entry point."""
    cfg, jeng, eng = _engines(GEGLU)
    prompts = _tokens(cfg, b=3, s=10)
    tids = np.asarray([1, 2, 0], np.int32)
    np.testing.assert_array_equal(eng.generate(prompts, 6, tids),
                                  np.asarray(jeng.generate(prompts, 6, tids)))
    outs = []
    for ns, e in ((REF, jeng), (PORT, eng)):
        sched = ns.S.ContinuousScheduler(e, ns.S.SchedulerConfig(
            **LAYOUTS[layout]))
        reqs = _workload(ns, cfg, False, seed=4)
        for r in reqs:
            sched.submit(r)
        sched.run()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# (i) crash and restore of a danube slots stream
# ---------------------------------------------------------------------------

def _crash_restore(ns, eng, cfg, tmp_path, kill_tick):
    kw = dict(kv_layout="slots", num_slots=3, bucket_min=8)

    def arrivals():
        rng = np.random.default_rng(31)
        return [(int(rng.integers(0, 6)), ns.S.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, int(
                rng.integers(3, 17))).astype(np.int32),
            task_id=int(rng.integers(0, 3)),
            max_new_tokens=int(rng.integers(6, 14)))) for i in range(6)]

    streams = lambda fin: {rid: list(map(int, r.out))
                           for rid, r in sorted(fin.items())}
    baseline = streams(ns.S.ContinuousScheduler(
        eng, ns.S.SchedulerConfig(**kw)).run_stream(arrivals()))
    path = str(tmp_path / f"{ns.name}.jsonl")
    sched = ns.S.ContinuousScheduler(eng, ns.S.SchedulerConfig(**kw),
                                     journal=ns.R.RequestJournal(path))
    todo = sorted(arrivals(), key=lambda a: a[0])
    while todo or sched.busy():
        if not sched.busy() and todo[0][0] > sched.clock:
            sched.clock = todo[0][0]
        while todo and todo[0][0] <= sched.clock:
            sched.submit(todo.pop(0)[1])
        sched.step()
        if sched.ticks >= kill_tick:
            break
    assert sched.busy()
    sched.journal.close()
    snap = ns.R.replay_journal(path)
    sched2 = ns.S.ContinuousScheduler(eng, ns.S.SchedulerConfig(**kw),
                                      journal=ns.R.RequestJournal(path))
    counts = sched2.restore(snap)
    for _, r in todo:
        sched2.submit(r)
    fin = sched2.run()
    assert streams(fin) == baseline
    assert sched2.pool.leak_report() == []
    snap2 = json.loads(json.dumps(sched2.snapshot()))
    return baseline, counts, snap2


@pytest.mark.parametrize("kill_tick", [3, 8])
def test_slots_crash_restore_equals_uncrashed(tmp_path, kill_tick):
    """A danube slots stream journaled, abandoned after a tick (requests
    past the window of 16 in flight) and restored: every stream bitwise
    the uncrashed run's, the pool leak-free; the restore counts and the
    final snapshot equal the reference's."""
    cfg, jeng, eng = _engines(DANUBE)
    got = {ns.name: _crash_restore(ns, e, cfg, tmp_path, kill_tick)
           for ns, e in ((REF, jeng), (PORT, eng))}
    assert got["port"] == got["reference"]
    assert got["port"][1]["live"] > 0


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

BASE = ["--device", "cpu", "--reduced", "--demo", "--tasks", "2",
        "--requests", "4", "--rate", "0.7", "--slots", "2", "--prompt", "12",
        "--steps", "6", "--max-len", "48", "--quiet"]


@pytest.mark.parametrize("name", NAMES)
def test_launcher_serves_each_decoder(name):
    """``--arch`` takes each decoder: danube with ``--layout slots`` (and
    ``--static``), olmo and qwen2.5 on the paged tick; ``--layout paged``
    refuses danube with the scheduler's error."""
    args = BASE + ["--arch", name]
    if name == DANUBE:
        sched = launcher.main(args + ["--layout", "slots"])
        assert not sched.paged
        with pytest.raises(sched_mod.InvalidConfig, match="kv_layout='slots'"):
            launcher.main(args)
        assert launcher.main(args + ["--static"]).shape == (4, 6)
    else:
        sched = launcher.main(args)
        assert sched.paged
    assert len(sched.finished) == 4 and sched.drain_check() == []


@pytest.mark.parametrize("name", NAMES)
def test_train_launcher_trains_each_decoder(name, tmp_path, capsys):
    train_launcher.main(["--device", "cpu", "--reduced", "--arch", name,
                         "--steps", "2", "--method", "aot", "--ckpt-dir",
                         str(tmp_path)])
    assert "events: []" in capsys.readouterr().out
