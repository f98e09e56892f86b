"""The recurrent backbones through the port's entry points against the JAX
reference, on reduced configs (``recurrent_util``: ``rgemma``, ``rgemma5``
with the (rglru, rglru) remainder and a ring of 8, ``xlstm`` and its
two-block cut ``xlstm2``), one set of weights on both sides (the port's
init carried into the reference's layout by the bridge): logits and
classify per PEFT method, prefill then decode steps (logits and every
cache leaf), the static batch's tokens, the AoT fc train step, the bridge
and checkpoint round trips, the serving paths that refuse them with the
reference's reason, and the padded prefill's state (ROADMAP C11: the
reference folds bucket padding into a recurrent state; the port does the
same).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_util import one_torch_thread  # noqa: F401 (autouse fixture)
from port_util import np32, port_tables
from recurrent_util import (TOL, assert_caches_close, bundles, setup,
                            task_tables, tokens)
from repro import configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import aot as JA
from repro.core import peft as JP
from repro.data.pipeline import LMStream
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions as JOpts
from repro.serve import scheduler as jsched
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import step as JS
from repro_torch import bridge, configs
from repro_torch import tree as T
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import peft as peft_mod
from repro_torch.launch import serve as launcher
from repro_torch.models import model as model_mod
from repro_torch.models.model import Model, ModelOptions
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.train import step as PS

METHODS = ["none", "aot", "aot4", "bitfit", "lora", "adapters", "ptv2"]
# every method on the 3-layer unit; on xLSTM (cut to one mLSTM and one
# sLSTM block: the 8-block stack's forward is held in
# test_prefill_and_decode_match_reference) the methods with a hook there
# (AoT's rows before each block, BitFit's final bias; LoRA, the adapters
# and the v2 prefix find no layer of theirs there, as in the reference);
# the two-group stack with per-layer leaves it regroups (four tasks'
# tables, LoRA's factors on its one attention layer)
CASES = [("rgemma", m) for m in METHODS] + [
    ("xlstm2", m) for m in ("none", "aot4", "bitfit")] + [
    ("rgemma5", m) for m in ("aot4", "lora")]


# ---------------------------------------------------------------------------
# configs, init, the bridge, checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["recurrentgemma-9b", "xlstm-350m"])
def test_configs_copy_the_reference_and_are_supported(name):
    """The port's config files equal the reference's field for field, and
    ``check_supported`` / ``check_servable`` accept the full configs."""
    assert dataclasses.asdict(configs.get(name)) == dataclasses.asdict(
        jconfigs.get(name))
    model_mod.check_supported(configs.get(name))
    model_mod.check_servable(configs.get(name))
    Model(configs.get(name), device="cpu")


@pytest.mark.parametrize("variant", ["rgemma5", "xlstm"])
def test_init_tree_matches_reference(variant):
    """``Model.init`` in the reference's grouped tree (two groups for
    rgemma5): every leaf's shape and dtype against the reference's
    ``init`` (traced for its shapes); bf16 parameters keep RG-LRU's lam and
    the norms float32; the fresh cache's tree, leaves and the stabilizers'
    -1e30 against the reference's ``init_cache``, and carried over by
    ``bridge.cache_from_jax`` bitwise."""
    cfg, jmodel, _, model, params = setup(variant)
    mine = bridge.params_to_jax(cfg, params)
    want = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    shapes = lambda t: jax.tree.map(lambda x: (x.shape, str(x.dtype)), t)
    assert shapes(mine) == shapes(want)
    assert jax.tree.structure(mine) == jax.tree.structure(want)
    assert len(mine["groups"]) == (2 if variant == "rgemma5" else 1)
    bf = Model(cfg, ModelOptions(param_dtype=torch.bfloat16),
               device="cpu").init(0)
    if variant.startswith("rgemma"):
        assert bf["layers"][0]["rglru"]["lam"].dtype == torch.float32
        assert bf["layers"][0]["rglru"]["in_x"].dtype == torch.bfloat16
    cache = model.init_cache(3, 24)
    jcache = jax.device_get(jmodel.init_cache(3, 24))
    assert jax.tree.structure(bridge.cache_to_jax(cfg, cache)) == \
        jax.tree.structure(jcache)
    assert_caches_close(cfg, cache, jcache, exact=True)
    assert_caches_close(cfg, bridge.cache_from_jax(cfg, jcache, device="cpu"),
                        jcache, exact=True)
    first = cache["layers"][0]["conv"]
    assert model.cache_specs(3, 24)["layers"][0]["conv"] == (
        tuple(first.shape), first.dtype)


@pytest.mark.parametrize("variant", ["rgemma5", "xlstm"])
def test_bridge_and_checkpoint_round_trip(variant, tmp_path):
    """params_to_jax then params_from_jax is bitwise, and so is the other
    way round from seeded values in the reference's init tree; a
    checkpoint of the grouped parameters written by the port and by the
    reference gives the same ``manifest.json`` and the same bytes, and
    each restores into the other bitwise."""
    cfg, jmodel, jparams, _, params = setup(variant)
    again = bridge.params_from_jax(cfg, jparams, device="cpu")
    for a, b in zip(T.leaves(again), T.leaves(params)):
        assert torch.equal(a, b)
    rng = np.random.default_rng(4)
    theirs = jax.tree.map(
        lambda x: rng.normal(size=x.shape).astype(x.dtype),
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
    back = bridge.params_to_jax(cfg, bridge.params_from_jax(cfg, theirs,
                                                            device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(theirs)):
        np.testing.assert_array_equal(a, np.asarray(b))
    back = bridge.params_to_jax(cfg, params)
    port_tree = T.map(lambda x: torch.from_numpy(np.array(x)), back)
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        3, port_tree, extra={"arch": cfg.name})
    JManager(str(tmp_path / "ref"), async_save=False).save(
        3, jparams, extra={"arch": cfg.name})
    files = {}
    for side in ("port", "ref"):
        d = tmp_path / side / "step_0000000003"
        with np.load(d / "arrays.npz") as z:
            files[side] = ((d / "manifest.json").read_text(),
                           {k: z[k].tobytes() for k in z.files})
    assert files["port"] == files["ref"]
    assert json.loads(files["port"][0])["structure"] == str(
        jax.tree.structure(jparams))
    got, extra = CheckpointManager(str(tmp_path / "ref")).restore(port_tree)
    assert extra == {"arch": cfg.name}
    mine = bridge.params_from_jax(cfg, bridge.to_numpy(got), device="cpu")
    for a, b in zip(T.leaves(mine), T.leaves(params)):
        assert torch.equal(a, b)
    jgot, _ = JManager(str(tmp_path / "port")).restore(jparams)
    for a, b in zip(jax.tree.leaves(jgot), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# whole sequences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,method", CASES)
def test_logits_match_reference(variant, method):
    cfg, jmodel, jparams, model, params = setup(variant)
    toks = tokens(cfg)
    jb, pb = bundles(variant, method)
    want = jax.jit(lambda t: jmodel.logits(jparams, {"tokens": t}, jb)[0])(
        jnp.asarray(toks))
    np.testing.assert_allclose(
        np32(model.logits(params, torch.from_numpy(toks), pb)), np32(want),
        **TOL)


@pytest.mark.parametrize("variant,method", [("rgemma", "aot4"),
                                            ("xlstm2", "bitfit")])
def test_classify_matches_reference(variant, method):
    """The paper's protocol, the last position's hidden state through a
    seeded head: the same forward as ``logits``, so two cases stand for
    the grid (the AoT rows before RG-LRU and attention, BitFit's final
    bias on xLSTM)."""
    cfg, jmodel, jparams, model, params = setup(variant)
    toks = tokens(cfg)
    jb, pb = bundles(variant, method, classify=True)
    want = jax.jit(lambda t: jmodel.classify(jparams, {"tokens": t}, jb)[0])(
        jnp.asarray(toks))
    np.testing.assert_allclose(
        np32(model.classify(params, torch.from_numpy(toks), pb)), np32(want),
        **TOL)


# ---------------------------------------------------------------------------
# prefill, decode steps, the static batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,method",
                         [("rgemma5", "ptv2"), ("xlstm", "aot4")])
def test_prefill_and_decode_match_reference(variant, method):
    """Prefill 12 tokens (past rgemma5's window of 8: its ring wraps, the
    P-Tuning v2 prefix of 4 in it; an mLSTM prompt of 3 chunks with four
    tasks' AoT rows), then 4 decode steps: the logits and every cache leaf
    (ring rows, conv inputs, RG-LRU and m/sLSTM states) after the prefill
    and after each step against the reference's. (AoT's decode on the
    hybrid stack: ``test_generate_matches_reference``.)"""
    cfg, jmodel, jparams, model, params = setup(variant)
    toks = tokens(cfg)
    jb, pb = bundles(variant, method)
    jlg, jcache, jpos = jax.jit(lambda t: jmodel.prefill(
        jparams, {"tokens": t}, jb, max_len=32))(jnp.asarray(toks[:, :12]))
    lg, cache, pos = model.prefill(params, torch.from_numpy(toks[:, :12]),
                                   pb, max_len=32)
    assert pos == int(jpos)
    np.testing.assert_allclose(np32(lg), np32(jlg), **TOL)
    assert_caches_close(cfg, cache, jcache)
    jdec = jax.jit(lambda t, p, c: jmodel.decode_step(jparams, t, p, c, jb))
    for t in range(12, 16):
        step = toks[:, t:t + 1]
        jlg, jcache = jdec(jnp.asarray(step), jnp.int32(pos + t - 12),
                           jcache)
        lg, cache = model.decode_step(params, torch.from_numpy(step),
                                      pos + t - 12, cache, pb)
        np.testing.assert_allclose(np32(lg), np32(jlg), **TOL)
        assert_caches_close(cfg, cache, jcache)


@pytest.mark.parametrize("variant", ["rgemma5", "xlstm2"])
def test_generate_matches_reference(variant):
    """``ServeEngine.generate``: 2 prompts of 10 with two fused tasks, 6
    greedy steps, tokens equal to the reference engine's."""
    cfg, jmodel, jparams, model, params = setup(variant)
    tasks = task_tables(variant, 4)[:2]
    jeng = JServeEngine(jmodel, jparams, JServeConfig(max_len=24),
                        fused_tasks=tasks)
    eng = ServeEngine(model, params, ServeConfig(max_len=24),
                      fused_tasks=port_tables(tasks))
    prompts = tokens(cfg, s=10, seed=8)
    tids = np.asarray([1, 0], np.int32)
    np.testing.assert_array_equal(eng.generate(prompts, 6, tids),
                                  np.asarray(jeng.generate(prompts, 6, tids)))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["rgemma", "xlstm2"])
def test_aot_fc_train_step_matches_reference(variant):
    """AoT fc (rank 4) under ``attn_impl="ref"``, through the plain
    recurrences with autograd: the loss within 1e-5 relative, every
    gradient leaf within 1e-4 of its largest |g| against ``jax.grad``,
    the trainable leaves after one AdamW step within 1e-5. AdamW's first
    step moves an element by about lr times the sign of its gradient, so
    an element whose reference gradient lies within that gradient
    tolerance of zero (its sign is not pinned by it) is held within 2 lr
    instead."""
    cfg, _, jparams, _, params = setup(variant)
    popt = JP.PEFTOptions(method="aot", aot=JA.AoTOptions(
        mode="fc", rank=4, dropout=0.0))
    rng = np.random.default_rng(0)
    pp = jax.device_get(jax.tree.map(lambda x: x + jnp.asarray(
        rng.normal(size=x.shape) * 0.05, x.dtype),
        JP.init(jax.random.PRNGKey(1), cfg, popt)))
    batch = LMStream(cfg.vocab_size, 8, 2, seed=0).next()
    jt = JS.TrainConfig(peft=popt, lr=1e-3, loss_chunk=8)
    bundle = bridge.peft_from_jax(pp, popt, device="cpu")
    pt = PS.TrainConfig(peft=bundle["opt"], lr=1e-3, loss_chunk=8)
    jmodel = JModel(setup(variant)[1].cfg, JOpts(attn_impl="ref", remat=False,
                                                 mlstm_chunk=4))
    model = Model(cfg, ModelOptions(attn_impl="ref", mlstm_chunk=4),
                  device="cpu")
    jtr, jfr = JS.split_train(jparams, pp, "aot")
    ptr, pfr = PS.split_train(params, bundle["params"], "aot")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jloss_fn = JS.make_loss_fn(jmodel, jt)
    jinit, jstep = JS.make_train_step(jmodel, jt)

    def reference(tr):      # the gradients and one step, one compile
        grad = jax.value_and_grad(lambda t: jloss_fn(t, jfr, jb, None),
                                  has_aux=True)(tr)
        return grad, jstep(jinit(tr), jfr, jb, None)[0]
    ((jloss, _), jg), js = jax.jit(reference)(jtr)
    with torch.enable_grad():
        ploss, _ = PS.make_loss_fn(model, pt)(ptr, pfr, pb, None)
        grads = torch.autograd.grad(ploss, T.leaves(ptr), allow_unused=True)
    ploss = ploss.detach()
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    pg = bridge.to_numpy(T.unflatten(ptr, list(grads))["peft"])
    flat_j = jax.tree.leaves(jax.device_get(jg)["peft"])
    flat_p = jax.tree.leaves(pg)
    assert len(flat_j) == len(flat_p)
    for a, b in zip(flat_j, flat_p):
        top = np.abs(a).max()
        assert top > 0
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * top)
    pinit, pstep = PS.make_train_step(model, pt)
    ps, _ = pstep(pinit(ptr), pfr, pb, None)
    for a, b, g in zip(jax.tree.leaves(jax.device_get(js["trainable"])),
                       jax.tree.leaves(bridge.to_numpy(ps["trainable"])),
                       flat_j):
        loose = np.abs(g) <= 1e-4 * np.abs(g).max()
        off = np.abs(b - a) - np.where(loose, 2e-3, 1e-5)
        assert off.max() <= 0, (a.shape, float(np.abs(b - a).max()))


# ---------------------------------------------------------------------------
# what refuses them, and the padded prefill
# ---------------------------------------------------------------------------

REASON = "fold bucket padding into their state"


@pytest.mark.parametrize("variant", ["rgemma5", "xlstm2"])
def test_paged_and_continuous_paths_refuse(variant):
    """The continuous scheduler (both layouts), the paged pool, the mixed
    step and paged decode refuse a recurrent stack with the reference's
    reason, as the reference's scheduler does."""
    cfg, jmodel, jparams, model, params = setup(variant)
    eng = ServeEngine(model, params, ServeConfig(max_len=24))
    jeng = JServeEngine(jmodel, jparams, JServeConfig(max_len=24))
    for layout in ("slots", "paged"):
        with pytest.raises(sched_mod.InvalidConfig, match=REASON):
            sched_mod.ContinuousScheduler(eng, sched_mod.SchedulerConfig(
                kv_layout=layout, num_slots=2))
        with pytest.raises(AssertionError, match=REASON):
            jsched.ContinuousScheduler(jeng, jsched.SchedulerConfig(
                kv_layout=layout, num_slots=2))
    with pytest.raises(NotImplementedError, match=REASON):
        model.paged_cache_specs(8, 4)
    with pytest.raises(AssertionError, match="attention-only"):
        jmodel.paged_cache_specs(8, 4)
    tok = torch.zeros(2, 1, dtype=torch.int32)
    bt = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match=REASON):
        model.mixed_step(params, tok, torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32), None,
                         block_tables=bt)
    with pytest.raises(NotImplementedError, match=REASON):
        model.decode_step(params, tok, torch.zeros(2, dtype=torch.long),
                          None, block_tables=bt)


@pytest.mark.parametrize("variant", ["rgemma", "xlstm2"])
def test_padded_prefill_folds_padding_as_the_reference(variant):
    """ROADMAP C11, the reference's behaviour copied: a prompt of 10 in a
    bucket of 16 with ``last_pos`` 9. The logits at position 9 equal the
    unpadded prefill's (causality), but the recurrent state has run over
    the 6 padding tokens: the port's cache equals the reference's padded
    one leaf for leaf, the recurrent state is off the unpadded prefill's,
    and so is the next decode step's logits row."""
    cfg, jmodel, jparams, model, params = setup(variant)
    toks = tokens(cfg, s=16)
    padded = toks.copy()
    padded[:, 10:] = 0
    jlg, jcache, _ = jax.jit(lambda t: jmodel.prefill(
        jparams, {"tokens": t}, max_len=32, last_pos=9))(jnp.asarray(padded))
    lg, cache, _ = model.prefill(params, torch.from_numpy(padded),
                                 max_len=32, last_pos=9)
    np.testing.assert_allclose(np32(lg), np32(jlg), **TOL)
    assert_caches_close(cfg, cache, jcache)
    lg0, clean, _ = model.prefill(params, torch.from_numpy(toks[:, :10]),
                                  max_len=32)
    np.testing.assert_allclose(np32(lg), np32(lg0), **TOL)
    layer = 0                              # an RG-LRU or mLSTM layer
    state = (cache["layers"][layer]["h"] if variant == "rgemma"
             else cache["layers"][layer]["state"][0])
    state0 = (clean["layers"][layer]["h"] if variant == "rgemma"
              else clean["layers"][layer]["state"][0])
    assert (state - state0).abs().max() > 1e-3
    step = torch.from_numpy(toks[:, 10:11])
    after, _ = model.decode_step(params, step, 10, cache)
    want, _ = model.decode_step(params, step, 10, clean)
    assert (after - want).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

BASE = ["--device", "cpu", "--reduced", "--demo", "--tasks", "2",
        "--requests", "2", "--prompt", "8", "--steps", "2", "--max-len", "24",
        "--quiet"]


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "xlstm-350m"])
def test_launcher_serves_static_batches_only(name):
    """``--static --arch`` serves one static batch; the streaming layouts
    refuse with the scheduler's error."""
    args = BASE + ["--arch", name]
    assert launcher.main(args + ["--static"]).shape == (2, 2)
    for layout in ("paged", "slots"):
        with pytest.raises(sched_mod.InvalidConfig, match=REASON):
            launcher.main(args + ["--layout", layout])


def test_lora_fusion_skips_recurrent_layers():
    """``fuse_lora_into`` changes W_q and W_v of attention layers only and
    leaves recurrent layers as they were (the same tensors); fused logits
    equal unfused ones."""
    cfg, _, _, model, params = setup("rgemma5")
    jb, pb = bundles("rgemma5", "lora")
    fused = peft_mod.fuse_lora_into(params, pb["params"], cfg, pb["opt"])
    for kind, a, b in zip(model.kinds, fused["layers"], params["layers"]):
        assert (a is b) == (kind != "attn")
    toks = torch.from_numpy(tokens(cfg))
    np.testing.assert_allclose(np32(model.logits(fused, toks)),
                               np32(model.logits(params, toks, pb)),
                               atol=1e-4, rtol=1e-4)


def test_lora_train_step_on_a_stack_without_attention():
    """LoRA on xLSTM reaches no layer, so no trainable leaf reaches the
    loss: the step runs with every gradient zero, as ``jax.grad`` gives,
    and leaves the LoRA parameters where they were."""
    cfg, _, _, _, params = setup("xlstm2")
    opt = peft_mod.PEFTOptions(method="lora", lora_rank=4)
    pp = peft_mod.init(cfg, opt, seed=1, device="cpu")
    model = Model(cfg, ModelOptions(attn_impl="ref", mlstm_chunk=4),
                  device="cpu")
    init, step = PS.make_train_step(model, PS.TrainConfig(peft=opt))
    tr, fr = PS.split_train(params, pp, "lora")
    batch = {k: torch.from_numpy(v) for k, v in
             LMStream(cfg.vocab_size, 8, 2, seed=0).next().items()}
    before = [x.detach().clone() for x in T.leaves(tr)]
    state, metrics = step(init(tr), fr, batch, None)
    assert float(metrics["grad_norm"]) == 0.0
    for a, b in zip(T.leaves(state["trainable"]), before):
        assert torch.equal(a.detach(), b)
