"""The two front-ends in the port against the JAX reference on their reduced
configs (``configs.reduced(..., repeats=2)``): paligemma-3b (stub SigLIP
patches (b, 4, 32) replacing the first 4 token embeddings, a bidirectional
prefix of 4, GeGLU, RMSNorm, MQA, tied embeddings scaled by sqrt(d)) and
hubert-xlarge (stub audio frames (b, s, 32), no token table, post-LN
LayerNorm, GELU MLP, learned positions, an untied head, full attention).

Weights: the reference's init (64 learned positions) with every leaf moved
by normals x 0.1, carried over by the bridge; PEFT parameters alike. Every
method each package runs there (hubert's AoT as a fused table indexed by
unit ids, ``aot_ids``), through ``forward``, ``logits`` and ``classify``
under the port's ``"kernel"`` (the wrappers' plain versions on the CPU),
``"chunked"`` and ``"ref"`` against the reference's ``"pallas"`` (its
kernels in interpret mode), ``"chunked"`` and ``"ref"``, within 2e-5 in
float32. Paligemma's prefill with patches and its decode steps against the
reference's (logits within 2e-5, greedy tokens equal), a prompt shorter
than the prefix (both packages' decode parts from their whole-sequence
logits there: ROADMAP's copied behaviour), the static batch. P-Tuning v1
on the kernel path (smollm, paligemma, hubert). The refusals in the
reference's words, one train step per arch, the launcher, and ROADMAP
C12: the reference's P-Tuning v1 decode is off its own logits, the port
refuses it. ROADMAP C17: the paged pool and paged decode on paligemma
under every impl against the reference's, and the paged static batch
(prefill, ``write_prefill``, paged decode) against the contiguous one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_util import np32
from repro import configs as jconfigs
from repro.core import aot as JA
from repro.core import peft as JP
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions as JOpts
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import step as JS
from repro_torch import bridge, configs
from repro_torch import tree as T
from repro_torch.core import peft as PP
from repro_torch.kernels import ops
from repro_torch.launch import train as launcher
from repro_torch.models import model as model_mod
from repro_torch.models.model import Model, ModelOptions
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.scheduler import ContinuousScheduler, InvalidConfig
from repro_torch.train import step as PS

from test_torch_prefill import kernel_checks  # noqa: F401 (a fixture)

PALI, HUBERT = "paligemma-3b", "hubert-xlarge"
TOL = dict(atol=2e-5, rtol=2e-5)
B, S, CLASSES, PROMPT, POS = 2, 12, 3, 3, 64
TASK_IDS = np.array([2, 0], np.int32)
IMPLS = {"kernel": "pallas", "chunked": "chunked", "ref": "ref"}
CHUNKS = dict(chunk_q=8, chunk_kv=4)      # the chunked scan runs
# every method each arch runs through the whole-sequence entry points on
# the kernels; the training paths add AoT's reparametrizations (hubert has
# no token ids for them) and full fine-tuning
KERNEL = ("none", "aot", "aot_multitask", "bitfit", "lora", "adapters",
          "ptv1", "ptv2")
TRAINING = {PALI: ("aot_fc", "aot_kron", "ft"), HUBERT: ("ft",)}
GRID = [(name, impl, case) for name in (PALI, HUBERT) for impl in IMPLS
        for case in KERNEL + (TRAINING[name] if impl != "kernel" else ())]


def _moved(tree, seed):
    """``tree`` (numpy leaves) with every leaf moved by normals x 0.1."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + rng.normal(
        size=np.shape(x)) * 0.1).astype(np.float32), tree)


def _cfgs(name):
    return (jconfigs.reduced(jconfigs.get(name), repeats=2),
            configs.reduced(configs.get(name), repeats=2))


_ARCHS = {}


def arch(name):
    """(reference config, its parameters (numpy), port config, port
    parameters carrying them), made once per arch."""
    if name not in _ARCHS:
        jcfg, cfg = _cfgs(name)
        jp = _moved(jax.device_get(JModel(jcfg, JOpts(
            max_learned_pos=POS)).init(jax.random.PRNGKey(0))), 1)
        _ARCHS[name] = (jcfg, jp, cfg,
                        bridge.params_from_jax(cfg, jp, device="cpu"))
    return _ARCHS[name]


def inputs(cfg, b=B, s=S, seed=3):
    """numpy inputs: tokens and patches (paligemma) or frames and unit ids
    (hubert)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"frames": rng.normal(size=(b, s, cfg.frontend_dim)).astype(
                    np.float32),
                "aot_ids": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                    np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "patches": rng.normal(size=(b, cfg.frontend_len,
                                        cfg.frontend_dim)).astype(np.float32)}


def port_inputs(batch, aot=True):
    """(tokens, the front-end keywords) of :meth:`Model.forward`."""
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    if not aot:
        t.pop("aot_ids", None)
    return t.pop("tokens", None), t


def tables(cfg, jp, n):
    """``n`` fused tables (L, V, d): the reference's ``random_fused`` of
    the token table, or seeded normals x 0.05 where there is none."""
    if "tok" in jp["embed"]:
        return [jax.device_get(JA.random_fused(cfg, jp["embed"]["tok"],
                                               seed=s)) for s in range(n)]
    rng = np.random.default_rng(7)
    return [{"table": (rng.normal(size=(cfg.num_layers, cfg.vocab_size,
                                        cfg.d_model)) * 0.05).astype(
                                            np.float32)} for _ in range(n)]


def jax_bundle(cfg, jp, case):
    """The reference's bundle for ``case``, with a ``CLASSES``-way head."""
    head = {"head": {"w": np.zeros((cfg.d_model, CLASSES), np.float32),
                     "b": np.zeros((CLASSES,), np.float32)}}
    if case in ("aot", "aot_multitask"):
        opt = JP.PEFTOptions(method="aot", num_classes=CLASSES,
                             aot=JA.AoTOptions(mode="fused"))
        tasks = tables(cfg, jp, 3 if case == "aot_multitask" else 1)
        aot = (jax.device_get(JA.stack_tasks(tasks))
               if case == "aot_multitask" else tasks[0])
        bundle = JP.make(dict(_moved(head, 5), aot=aot), opt)
        if case == "aot_multitask":
            bundle["task_ids"] = jnp.asarray(TASK_IDS)
        return bundle
    mode = case[4:] if case.startswith("aot_") else "fc"
    opt = JP.PEFTOptions(method=case.split("_")[0], num_classes=CLASSES,
                         prompt_len=PROMPT, lora_rank=4, adapter_rank=8,
                         aot=JA.AoTOptions(mode=mode, rank=4, dropout=0.0))
    return JP.make(_moved(jax.device_get(JP.init(jax.random.PRNGKey(1), cfg,
                                                 opt)), 5), opt)


def port_bundle(bundle):
    out = bridge.peft_from_jax(bundle["params"], bundle["opt"], device="cpu")
    if "task_ids" in bundle:
        out["task_ids"] = torch.from_numpy(TASK_IDS)
    return out


# ---------------------------------------------------------------------------
# configs, init, bridge
# ---------------------------------------------------------------------------

def test_registry_holds_the_references_configs():
    """The port's registry has the reference's twelve names, the two new
    configs copied field for field (and reduced alike); ``check_supported``
    accepts every one, and softcap, which none sets, too (ported)."""
    assert sorted(configs.REGISTRY) == sorted(jconfigs.REGISTRY)
    for name in (PALI, HUBERT):
        assert dataclasses.asdict(configs.get(name)) == dataclasses.asdict(
            jconfigs.get(name))
        jcfg, cfg = _cfgs(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for cfg in configs.REGISTRY.values():
        model_mod.check_supported(cfg)
    model_mod.check_supported(configs.get(PALI).replace(logit_softcap=30.0))


@pytest.mark.parametrize("name", [PALI, HUBERT])
def test_init_tree_and_bridge_round_trip(name):
    """The port's ``Model.init`` has the reference's tree and shapes
    (``frontend.proj``, no ``embed.tok`` for audio frames, ``max_pos``
    learned positions: 524416 rows from the full config's shapes); the
    reference's parameters cross both ways bitwise."""
    jcfg, jp, cfg, params = arch(name)
    mine = bridge.params_to_jax(cfg, Model(cfg, ModelOptions(
        max_learned_pos=POS), device="cpu").init(0))
    assert jax.tree.structure(mine) == jax.tree.structure(jp)
    assert [x.shape for x in jax.tree.leaves(mine)] == \
        [x.shape for x in jax.tree.leaves(jp)]
    assert params["frontend"]["proj"].shape == (cfg.frontend_dim,
                                                cfg.d_model)
    assert ("tok" in params["embed"]) == (name == PALI)
    back = bridge.params_to_jax(cfg, params)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    full = configs.get(name)
    if full.pos_type == "learned":
        assert Model(full, device="cpu").max_pos() == JModel(
            jconfigs.get(name)).max_pos() == 524416


# ---------------------------------------------------------------------------
# forward / logits / classify
# ---------------------------------------------------------------------------

def reference_entries(name, impl, case):
    """The reference's (forward, logits, classify) for one grid cell."""
    jcfg, jp, _, _ = arch(name)
    jb = jax_bundle(jcfg, jp, case)
    jmodel = JModel(jcfg, JOpts(attn_impl=IMPLS[impl], max_learned_pos=POS,
                                **CHUNKS))
    batch = {k: jnp.asarray(v) for k, v in inputs(jcfg).items()}
    if not case.startswith("aot"):
        batch.pop("aot_ids", None)
    h = jmodel.forward(jp, batch, None if case == "none" else jb)[0]
    # the reference's classify on this forward (its own runs forward with
    # the same bundle; "none"'s is the bare backbone's)
    pooled = h.mean(axis=1) if jcfg.is_encoder_only else h[:, -1]
    head = jb["params"]["head"]
    return (np32(h), np32(jmodel.unembed(jp, h)),
            np32(pooled @ head["w"] + head["b"]))


@pytest.mark.parametrize("name,impl,case", GRID)
def test_entries_match_reference(name, impl, case):
    """forward, logits and classify of one method under one impl against
    the reference's counterpart within 2e-5 in float32. On the kernels a
    bidirectional prefix (paligemma's, P-Tuning v1's prompt) takes one
    ``attention_chunked`` call per layer through ``ops.flash_attention``,
    and any other attention none."""
    jcfg, jp, cfg, params = arch(name)
    model = Model(cfg, ModelOptions(attn_impl=impl, max_learned_pos=POS,
                                    **CHUNKS), device="cpu")
    pb = port_bundle(jax_bundle(jcfg, jp, case))
    toks, kw = port_inputs(inputs(cfg), aot=case.startswith("aot"))
    plain = None if case == "none" else pb
    ops.reset_launches()
    got = (model.forward(params, toks, plain, **kw),
           model.logits(params, toks, plain, **kw),
           model.classify(params, toks, pb, **kw))
    prefix = cfg.prefix_lm_len or case == "ptv1"
    assert ops.chunked_calls() == (3 * cfg.num_layers
                                   if impl == "kernel" and prefix else 0)
    for g, w, what in zip(got, reference_entries(name, impl, case),
                          ("forward", "logits", "classify")):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(np32(g), w, **TOL, err_msg=what)


@pytest.mark.parametrize("name", ["smollm-360m", PALI, HUBERT])
def test_ptv1_on_the_kernels(name, kernel_checks):  # noqa: F811
    """P-Tuning v1 under ``attn_impl="kernel"`` against the reference's
    ``"pallas"`` (its wrapper sends the prompt's prefix to XLA): logits
    within 2e-5, every attention through ``attention_chunked`` (flash 0,
    chunked L per call), hubert's norms plain PyTorch, the RMSNorm stacks'
    input norms one ``rms_norm`` launch per layer."""
    if name == "smollm-360m":
        jcfg, cfg = _cfgs(name)
        jp = _moved(jax.device_get(JModel(jcfg).init(jax.random.PRNGKey(0))),
                    1)
        params = bridge.params_from_jax(cfg, jp, device="cpu")
    else:
        jcfg, jp, cfg, params = arch(name)
    jb = jax_bundle(jcfg, jp, "ptv1")
    batch = inputs(cfg)
    batch.pop("aot_ids", None)
    if name == "smollm-360m":
        batch.pop("patches")
    want = JModel(jcfg, JOpts(attn_impl="pallas", max_learned_pos=POS)
                  ).logits(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                           jb)[0]
    model = Model(cfg, ModelOptions(max_learned_pos=POS), device="cpu")
    toks, kw = port_inputs(batch)
    got = model.logits(params, toks, port_bundle(jb), **kw)
    np.testing.assert_allclose(np32(got), np32(want), **TOL)
    L = cfg.num_layers
    assert ops.chunked_calls() == L
    assert ops.launches() == dict(ops.launches(), flash_attention=0,
                                  rms_norm=0 if name == HUBERT else L)


def test_hubert_unit_aot_launches(kernel_checks):  # noqa: F811
    """Hubert without a prefix: flash in full mode once per layer, and the
    unit-AoT table through the plain-mode gather-add once per layer (post-
    LN: no fused norm), the multi-task table through its own."""
    jcfg, jp, cfg, params = arch(HUBERT)
    model = Model(cfg, ModelOptions(max_learned_pos=POS), device="cpu")
    toks, kw = port_inputs(inputs(cfg))
    L = cfg.num_layers
    for case, wrapper in (("aot", "aot_gather_add"),
                          ("aot_multitask", "aot_gather_add_multitask")):
        ops.reset_launches()
        model.logits(params, toks, port_bundle(jax_bundle(jcfg, jp, case)),
                     **kw)
        assert ops.launches() == dict(ops.launches(), flash_attention=L,
                                      **{wrapper: L})
        assert ops.chunked_calls() == 0


# ---------------------------------------------------------------------------
# paligemma: prefill with patches, decode, the static batch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pali_decode():
    """The reference's prefill of 8 tokens with the patches and 8
    teacher-forced decode steps, its whole-sequence logits and greedy
    tokens over 3-task AoT tables (kernels in interpret mode)."""
    jcfg, jp, cfg, params = arch(PALI)
    tasks = tables(jcfg, jp, 3)
    jb = jax_bundle(jcfg, jp, "aot_multitask")
    jmodel = JModel(jcfg, JOpts(attn_impl="pallas"))
    batch = {k: jnp.asarray(v) for k, v in inputs(jcfg, s=16).items()}
    full = np32(jmodel.logits(jp, batch, jb)[0])
    lg, cache, pos = jmodel.prefill(jp, dict(batch, tokens=batch["tokens"][
        :, :8]), jb, max_len=32)
    steps = [np32(lg[:, 0])]
    for t in range(8, 16):
        lg, cache = jmodel.decode_step(jp, batch["tokens"][:, t:t + 1],
                                       jnp.int32(t), cache, jb)
        steps.append(np32(lg[:, 0]))
    return tasks, jb, full, steps, int(pos)


def test_paligemma_prefill_and_decode_match_reference(
        pali_decode, kernel_checks):  # noqa: F811
    """The port's prefill with the patches (the prefix through
    ``attention_chunked``: flash 0, chunked L, one fused multi-task
    gather-add per layer) and decode steps (the decode kernel, L per step)
    against the reference's within 2e-5; both within 5e-4 of the
    whole-sequence logits, as the reference's smoke test holds its own."""
    _, jb, full, steps, jpos = pali_decode
    _, _, cfg, params = arch(PALI)
    model = Model(cfg, device="cpu")
    pb = port_bundle(jb)
    toks, kw = port_inputs(inputs(cfg, s=16))
    lg, cache, pos = model.prefill(params, toks[:, :8], pb, max_len=32, **kw)
    L = cfg.num_layers
    assert pos == jpos == 8
    assert ops.launches() == dict(ops.launches(), flash_attention=0,
                                  aot_gather_add_multitask=L)
    assert ops.chunked_calls() == L
    got = [np32(lg[:, 0])]
    ops.reset_launches()
    for t in range(8, 16):
        lg, cache = model.decode_step(params, toks[:, t:t + 1], t, cache, pb)
        got.append(np32(lg[:, 0]))
    assert ops.launches()["decode_attention"] == 8 * L
    assert ops.chunked_calls() == 0
    for i, (g, w) in enumerate(zip(got, steps)):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(g, full[:, 7 + i], atol=5e-4, rtol=0)
    np.testing.assert_allclose(np32(model.logits(params, toks, pb, **kw)),
                               full, **TOL)


def test_prompt_shorter_than_the_prefix_copies_the_reference():
    """A 3-token prompt without patches under a prefix of 4: the whole
    pass lets position 0-2 see position 3, the prefill (3 tokens) cannot,
    so both packages' decode at position 3 parts from their whole-sequence
    logits (by more than 1e-3); the port's decode equals the reference's
    within 2e-5 (ROADMAP: a copied behaviour)."""
    jcfg, jp, cfg, params = arch(PALI)
    toks = inputs(cfg, s=4)["tokens"]
    jmodel = JModel(jcfg, JOpts(attn_impl="pallas"))
    jfull = np32(jmodel.logits(jp, {"tokens": jnp.asarray(toks)})[0])
    _, jc, _ = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :3])},
                              max_len=8)
    jdec = np32(jmodel.decode_step(jp, jnp.asarray(toks[:, 3:]),
                                   jnp.int32(3), jc)[0][:, 0])
    model = Model(cfg, device="cpu")
    t = torch.from_numpy(toks)
    _, cache, _ = model.prefill(params, t[:, :3], max_len=8)
    dec = np32(model.decode_step(params, t[:, 3:], 3, cache)[0][:, 0])
    full = np32(model.logits(params, t))
    np.testing.assert_allclose(dec, jdec, **TOL)
    np.testing.assert_allclose(full, jfull, **TOL)
    assert np.abs(jdec - jfull[:, 3]).max() > 1e-3
    assert np.abs(dec - full[:, 3]).max() > 1e-3


def test_paligemma_static_batch_matches_reference(pali_decode):
    """``ServeEngine.generate`` (tokens only, as the reference's) over 3
    stacked tasks: greedy tokens equal to the reference engine's; the
    engine's model's ``prefill`` with the patches against the reference's
    ``_prefill_impl`` with ``extra`` within 2e-5."""
    tasks = pali_decode[0]
    jcfg, jp, cfg, params = arch(PALI)
    jeng = JServeEngine(JModel(jcfg, JOpts(attn_impl="pallas")), jp,
                        JServeConfig(max_len=24), fused_tasks=tasks)
    eng = ServeEngine(Model(cfg, device="cpu"), params,
                      ServeConfig(max_len=24),
                      fused_tasks=bridge.tables_from_jax(tasks,
                                                         device="cpu"))
    batch = inputs(cfg, s=10, seed=8)
    np.testing.assert_array_equal(
        eng.generate(batch["tokens"], 6, TASK_IDS),
        jeng.generate(batch["tokens"], 6, TASK_IDS))
    want = jeng._prefill_impl(jp, jnp.asarray(batch["tokens"]),
                              jnp.asarray(TASK_IDS),
                              {"patches": jnp.asarray(batch["patches"])})[0]
    toks, kw = port_inputs(batch)
    got = eng.model.prefill(eng.params, toks,
                            eng._peft(torch.from_numpy(TASK_IDS)),
                            max_len=eng.cache_len, **kw)[0]
    np.testing.assert_allclose(np32(got), np32(want), **TOL)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_refusals_in_the_references_words():
    """AoT's fc / kron on hubert (its unit-AoT fused table is allowed), the
    serving engine on hubert (so no scheduler reaches audio frames), the
    continuous scheduler and the mixed step on paligemma (the reference's
    own refusals of a bidirectional prefix), and an input that does not fit
    the front-end. The paged pool and paged decode, which the reference
    runs on the prefix-LM, serve it here too (ROADMAP C17): a decode step
    over the pool is the contiguous step's (within 2e-5; the reference's
    in ``test_c17_paged_decode_matches_reference``)."""
    _, jp, hcfg, _ = arch(HUBERT)
    for mode in ("fc", "kron"):
        with pytest.raises(ValueError, match="needs discrete input ids"):
            PP.init(hcfg, PP.PEFTOptions(method="aot", aot=PP.AoTOptions(
                mode=mode)), device="cpu")
        with pytest.raises(AssertionError, match="needs discrete input ids"):
            JP.init(jax.random.PRNGKey(0), _cfgs(HUBERT)[0], JP.PEFTOptions(
                method="aot", aot=JA.AoTOptions(mode=mode)))
    PP.init(hcfg, PP.PEFTOptions(method="aot", aot=PP.AoTOptions(
        mode="fused")), device="cpu")
    hubert = Model(hcfg, ModelOptions(max_learned_pos=POS), device="cpu")
    with pytest.raises(NotImplementedError, match="Model.forward"):
        ServeEngine(hubert, arch(HUBERT)[3])
    with pytest.raises(ValueError, match="no tokens"):
        hubert.forward(arch(HUBERT)[3], torch.zeros(1, 4, dtype=torch.long))

    _, _, cfg, params = arch(PALI)
    model = Model(cfg, device="cpu")
    for layout in ("paged", "slots"):
        with pytest.raises(InvalidConfig, match="bidirectional prefix"):
            from repro_torch.serve.scheduler import SchedulerConfig
            ContinuousScheduler(ServeEngine(model, params),
                                SchedulerConfig(kv_layout=layout))
    with pytest.raises(NotImplementedError,
                       match="mixed step relies on causal masking"):
        model.mixed_step(params, torch.zeros(2, 1, dtype=torch.long),
                         torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32), {},
                         block_tables=torch.zeros(1, 1, dtype=torch.int32))
    pool = model.init_paged_cache(4, 4)
    assert pool["k"].shape == (cfg.num_layers, 4, 4, cfg.num_kv_heads,
                               cfg.head_dim)
    step = lambda cache, bt=None: np32(model.decode_step(
        params, torch.ones(1, 1, dtype=torch.long),
        torch.zeros(1, dtype=torch.int32), cache, block_tables=bt)[0])
    np.testing.assert_allclose(
        step(pool, torch.tensor([[2]], dtype=torch.int32)),
        step(model.init_cache(1, 4)), **TOL)
    with pytest.raises(ValueError, match="patches"):
        model.forward(params, torch.zeros(1, 3, dtype=torch.long),
                      patches=torch.zeros(1, 4, cfg.frontend_dim))


# ---------------------------------------------------------------------------
# ROADMAP C17: the paged pool and paged decode on the prefix-LM
# ---------------------------------------------------------------------------

C17_TABLES = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
C17_STEPS = 8


def _c17_decode(model, params, toks, paged, jax_side=False):
    """ROADMAP C17's smallest input: ``C17_STEPS`` decode steps of two rows
    from position 0 (per-row ``pos``; the given tokens), over
    ``init_paged_cache(9, 4)`` with ``C17_TABLES`` when ``paged``, else a
    contiguous cache of 16 rows (the tables' capacity). Returns the
    logits (steps, b, V) as numpy."""
    b = toks.shape[0]
    arr = jnp.asarray if jax_side else torch.from_numpy
    cache = model.init_paged_cache(9, 4) if paged else model.init_cache(b, 16)
    bt = arr(C17_TABLES) if paged else None
    out = []
    for t in range(C17_STEPS):
        pos = arr(np.full((b,), t, np.int32))
        lg, cache = model.decode_step(params, arr(toks[:, t:t + 1]), pos,
                                      cache, block_tables=bt)
        out.append(np32(lg[:, 0]))
    return np.stack(out)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_c17_paged_decode_matches_reference(impl):
    """Reduced paligemma-3b (prefix 4, h 4, kvh 1, hd 16), the ``arch``
    weights: the port's paged decode on the kernels' plain versions and
    under "ref" (whose decode walk "chunked" shares) within 2e-5 of the
    reference's paged decode under "pallas" / "ref", and of the port's own
    contiguous decode; the reference's paged decode is its contiguous one
    within 2e-5 too (0.0 under "ref")."""
    jcfg, jp, cfg, params = arch(PALI)
    toks = np.random.default_rng(17).integers(
        0, cfg.vocab_size, (2, C17_STEPS)).astype(np.int32)
    jmodel = JModel(jcfg, JOpts(attn_impl=IMPLS[impl]))
    model = Model(cfg, ModelOptions(attn_impl=impl), device="cpu")
    want = _c17_decode(jmodel, jp, toks, True, jax_side=True)
    got = _c17_decode(model, params, toks, True)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _c17_decode(model, params, toks, False),
                               **TOL)
    np.testing.assert_allclose(
        _c17_decode(jmodel, jp, toks, False, jax_side=True), want, **TOL)


def test_paligemma_paged_static_batch_gives_contiguous_tokens(
        pali_decode, kernel_checks):  # noqa: F811
    """The static batch over the paged pool, through the port's entry
    points (``prefill`` with the patches, each row written into a
    ``PagedKVPool`` with ``write_prefill``, greedy ``decode_step(
    block_tables=)``, every kernel's argument checks passed): the contiguous
    batch's greedy tokens, logits within 2e-5, one paged decode per layer
    and step and no contiguous one, and the pool drains clean."""
    from repro_torch.serve.kv_pool import PagedKVPool
    tasks, jb = pali_decode[:2]
    _, _, cfg, params = arch(PALI)
    model, pb = Model(cfg, device="cpu"), port_bundle(jb)
    toks, kw = port_inputs(inputs(cfg, s=9, seed=11))
    b, s, steps, bs, L = toks.shape[0], toks.shape[1], 6, 4, cfg.num_layers
    max_len = 20                          # 5 pages of 4, the cache's rows

    def greedy(cache, pos, lg, bt=None):
        lgs, out = [np32(lg[:, -1])], []
        for i in range(steps):
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            out.append(tok)
            lg, cache = model.decode_step(
                params, tok, torch.full((b,), pos + i, dtype=torch.int32),
                cache, pb, block_tables=bt)
            lgs.append(np32(lg[:, -1]))
        return np.stack(lgs), torch.cat(out, 1).numpy()

    lg, cache, pos = model.prefill(params, toks, pb, max_len=max_len, **kw)
    pool = PagedKVPool(model, b, max_len, block_size=bs)
    for r in range(b):
        slot = pool.alloc(int(TASK_IDS[r]), pool.pages_needed(s + steps))
        pool.write_prefill(slot, {n: c[:, r:r + 1] for n, c in cache.items()},
                           s)
    bt = torch.as_tensor(pool.block_tables)
    ops.reset_launches()
    lg_p, tok_p = greedy(pool.cache, pos, lg, bt)
    assert ops.launches()["paged_decode_attention"] == L * steps
    assert ops.launches()["decode_attention"] == 0
    lg_c, tok_c = greedy(cache, pos, lg)
    np.testing.assert_array_equal(tok_p, tok_c)
    np.testing.assert_allclose(lg_p, lg_c, **TOL)
    for r in range(b):
        pool.free(r)
    assert pool.leak_report() == [] and pool.blocks_in_use() == 0


@pytest.fixture(scope="module")
def c12():
    """ROADMAP C12's smallest input: reduced smollm-360m, P-Tuning v1 with
    a prompt of 4 drawn at std 0.5, a 6-token prompt, one decode step, the
    reference under ``attn_impl="ref"``."""
    jcfg, cfg = _cfgs("smollm-360m")
    jp = jax.device_get(JModel(jcfg).init(jax.random.PRNGKey(0)))
    opt = JP.PEFTOptions(method="ptv1", prompt_len=4)
    rng = np.random.default_rng(0)
    pp = {"ptv1": {"prompt": (rng.normal(size=(4, jcfg.d_model)) * 0.5
                              ).astype(np.float32)}}
    toks = rng.integers(0, jcfg.vocab_size, (1, 7)).astype(np.int32)
    return jcfg, jp, cfg, JP.make(pp, opt), toks


def test_c12_reference_ptv1_decode_is_off_its_logits(c12):
    """The reference's ptv1 prefill returns pos = s (not s + p), so its
    next decode step overwrites a prompt row: its logits part from its own
    whole-sequence logits by more than 0.05; the prefill's last logits
    equal them."""
    jcfg, jp, _, jb, toks = c12
    jmodel = JModel(jcfg, JOpts(attn_impl="ref"))
    full = np32(jmodel.logits(jp, {"tokens": jnp.asarray(toks)}, jb)[0])
    lg, cache, pos = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :6])},
                                    jb, max_len=16)
    assert int(pos) == 6
    np.testing.assert_allclose(np32(lg[:, 0]), full[:, 5], **TOL)
    dec = np32(jmodel.decode_step(jp, jnp.asarray(toks[:, 6:]), pos, cache,
                                  jb)[0][:, 0])
    assert np.abs(dec - full[:, 6]).max() > 0.05


def test_c12_port_refuses_ptv1_in_serving(c12):
    """The port's ``prefill`` and ``decode_step`` refuse P-Tuning v1 (its
    whole-sequence entry points run it on every impl)."""
    _, jp, cfg, jb, toks = c12
    model = Model(cfg, device="cpu")
    params = bridge.params_from_jax(cfg, jp, device="cpu")
    pb = port_bundle(jb)
    t = torch.from_numpy(toks)
    with pytest.raises(NotImplementedError,
                       match="runs only through forward / logits / classify"):
        model.prefill(params, t[:, :6], pb, max_len=16)
    cache = model.init_cache(1, 16)
    with pytest.raises(NotImplementedError, match="ptv1"):
        model.decode_step(params, t[:, 6:], 6, cache, pb)
    assert model.logits(params, t, pb).shape == (1, 7, cfg.vocab_size)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,method", [(PALI, "aot"), (HUBERT, "lora")])
def test_train_step_matches_reference(name, method):
    """One train step under ``attn_impl="chunked"`` on both sides with the
    front-end's inputs in the batch (AoT fc on paligemma, LoRA on hubert):
    the loss within 1e-5 relative, the trained parameters after it within
    1e-5."""
    jcfg, jp, cfg, params = arch(name)
    opt = JP.PEFTOptions(method=method, lora_rank=4,
                         aot=JA.AoTOptions(mode="fc", rank=4, dropout=0.0))
    jpp = _moved(jax.device_get(JP.init(jax.random.PRNGKey(1), jcfg, opt)),
                 5)
    batch = inputs(cfg, s=16, seed=11)
    batch.pop("aot_ids", None)
    batch["labels"] = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (B, 16)).astype(np.int32)
    jmodel = JModel(jcfg, JOpts(attn_impl="chunked", max_learned_pos=POS,
                                remat=False, **CHUNKS))
    jt = JS.TrainConfig(peft=opt, lr=1e-3, loss_chunk=8)
    jinit, jstep = JS.make_train_step(jmodel, jt)
    jtr, jfr = JS.split_train(jp, jpp, method)
    jstate, jmet = jax.jit(jstep)(jinit(jtr), jfr, {
        k: jnp.asarray(v) for k, v in batch.items()}, None)
    model = Model(cfg, ModelOptions(attn_impl="chunked", max_learned_pos=POS,
                                    **CHUNKS), device="cpu")
    pb = port_bundle(JP.make(jpp, opt))
    pt = PS.TrainConfig(peft=pb["opt"], lr=1e-3, loss_chunk=8)
    pinit, pstep = PS.make_train_step(model, pt)
    ptr, pfr = PS.split_train({k: v for k, v in params.items()},
                              pb["params"], method)
    pstate, pmet = pstep(pinit(ptr), pfr, {
        k: torch.from_numpy(v) for k, v in batch.items()}, None)
    assert abs(float(pmet["loss"]) - float(jmet["loss"])) <= 1e-5 * abs(
        float(jmet["loss"]))
    got = bridge.to_numpy(pstate["trainable"]["peft"])
    want = jax.device_get(jstate["trainable"]["peft"])
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
    assert T.leaves(pfr)[0].requires_grad is False


@pytest.mark.parametrize("name", [PALI, HUBERT])
def test_launcher_trains_a_frontend(name, capsys, tmp_path):
    """``launch.train --arch`` with the stub inputs beside the stream: 3
    steps, finite losses, a resumed run bitwise the stream's."""
    argv = ["--device", "cpu", "--reduced", "--steps", "3", "--arch", name,
            "--method", "lora", "--seq", "16",
            "--batch", "2", "--ckpt-dir", str(tmp_path)]
    assert launcher.main(argv) == 0
    out = capsys.readouterr().out
    assert "'step': 2" in out and "nan" not in out
    stream = launcher.FrontEndStream(launcher.lm_stream(
        launcher.parser().parse_args(argv), 128), _cfgs(name)[1])
    a = stream.next()
    stream.restore({"step": 0, "seed": 0, "shard_id": 0, "num_shards": 1})
    b = stream.next()
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                          for k in a)
    assert ("frames" in a) == (name == HUBERT) and ("tokens" in a) == (
        name == PALI)
