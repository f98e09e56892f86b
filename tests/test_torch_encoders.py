"""The paper's encoder backbones, roberta-large and deberta-xl, in the port
against the JAX reference on their reduced configs (``configs.reduced(...,
repeats=2)``: 2 post-LN layers, d 64, 4 heads over 4 KV heads, learned
positions, LayerNorm, the GELU MLP, an untied head, full attention).

The reference's weights (its init, every leaf then moved by normals x 0.1
so that norms, biases and positions all matter) and its PEFT parameters
(drawn with ``repro.core.peft.init`` and moved alike; AoT's fused tables
from ``random_fused``) are carried over by the bridge. The kernel path
(``attn_impl="kernel"``: the wrappers' plain versions on the CPU) is held
against the reference's ``attn_impl="pallas"`` (its flash kernel in
interpret mode, full mode at g = 1), the training path (``"ref"``) against
the reference's ``"ref"``: ``forward``, ``logits`` and ``classify`` within
2e-5 in float32; in bfloat16 within 2x the reference's own bf16 error
(:func:`check_entries`). Also: the norms and the GELU MLP (within 2e-5 /
2e-2), the config copies, the init and the bridge's round trip, the
learned positions' reach, one kernel launch per layer, and the serving
entry points' refusal of an encoder."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_util import both, np32
from repro import configs as jconfigs
from repro.core import aot as JA
from repro.core import peft as JP
from repro.models import layers as JL
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions as JOpts
from repro_torch import bridge, configs
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import layers as PL
from repro_torch.models.model import Model, ModelOptions, check_servable
from repro_torch.serve.engine import ServeConfig, ServeEngine

ENCODERS = ("roberta-large", "deberta-xl")
TOL = {jnp.float32: dict(atol=2e-5, rtol=2e-5),
       jnp.bfloat16: dict(atol=2e-2, rtol=2e-2)}
BF16_FACTOR = 2.0       # as chip_smoke.py's phase 7c
B, S, CLASSES, PROMPT = 2, 12, 3, 3
TASK_IDS = np.array([2, 0], np.int32)          # the multi-task batch's
# the methods the kernels serve, then those only the training path runs
SERVED = ("none", "aot", "aot_multitask", "bitfit", "lora", "adapters",
          "ptv2")
TRAINED = ("aot_fc", "aot_kron", "ptv1", "ft")


def _jcfg(name):
    return jconfigs.reduced(jconfigs.get(name), repeats=2)


def _pcfg(name):
    return configs.reduced(configs.get(name), repeats=2)


def _moved(tree, seed):
    """``tree`` (numpy leaves) with every leaf moved by normals x 0.1."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + rng.normal(
        size=np.shape(x)) * 0.1).astype(np.float32), tree)


@pytest.fixture(scope="module", params=ENCODERS)
def enc(request):
    """(name, reference config, reference parameters as numpy, the port's
    config and parameters carrying them on the CPU)."""
    name = request.param
    cfg = _jcfg(name)
    jp = _moved(jax.device_get(JModel(cfg).init(jax.random.PRNGKey(0))), 1)
    pcfg = _pcfg(name)
    return name, cfg, jp, pcfg, bridge.params_from_jax(pcfg, jp,
                                                       device="cpu")


def jax_bundle(cfg, jp, case):
    """The reference's bundle for ``case`` (every method with a
    ``CLASSES``-way head, so that ``classify`` runs with it)."""
    head = {"head": {"w": np.zeros((cfg.d_model, CLASSES), np.float32),
                     "b": np.zeros((CLASSES,), np.float32)}}
    if case in ("aot", "aot_multitask"):
        opt = JP.PEFTOptions(method="aot", num_classes=CLASSES,
                             aot=JA.AoTOptions(mode="fused"))
        tasks = [JA.random_fused(cfg, jp["embed"]["tok"], seed=s)
                 for s in range(3 if case == "aot_multitask" else 1)]
        aot = (JA.stack_tasks(tasks) if case == "aot_multitask"
               else tasks[0])
        pp = dict(_moved(head, 5), aot=jax.device_get(aot))
    else:
        mode = case[4:] if case.startswith("aot_") else "fc"
        opt = JP.PEFTOptions(
            method=case.split("_")[0], num_classes=CLASSES,
            prompt_len=PROMPT, lora_rank=4, adapter_rank=8,
            aot=JA.AoTOptions(mode=mode, rank=4, dropout=0.0))
        pp = _moved(jax.device_get(JP.init(jax.random.PRNGKey(1), cfg,
                                           opt)), 5)
    bundle = JP.make(pp, opt)
    if case == "aot_multitask":
        bundle["task_ids"] = jnp.asarray(TASK_IDS)
    return bundle


def port_bundle(bundle):
    out = bridge.peft_from_jax(bundle["params"], bundle["opt"],
                               device="cpu")
    if "task_ids" in bundle:
        out["task_ids"] = torch.from_numpy(TASK_IDS)
    return out


def _tokens(cfg, s=S, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s))


def _entries(model, params, toks, peft):
    """forward (b, s, d), logits (b, s, V), classify (b, CLASSES)."""
    if peft is not None and peft["method"] == "none":
        plain = None                       # the bare backbone's forward
    else:
        plain = peft
    return (model.forward(params, toks, plain),
            model.logits(params, toks, plain),
            model.classify(params, toks, peft))


def _reference_entries(cfg, jp, jb, case, impl, dtype):
    jmodel = JModel(cfg, JOpts(attn_impl="pallas" if impl == "kernel"
                               else "ref", compute_dtype=dtype))
    jt = {"tokens": jnp.asarray(_tokens(cfg))}
    h = jmodel.forward(jp, jt, None if case == "none" else jb)[0]
    # the reference's logits are unembed(forward): one forward serves both
    return [np32(h), np32(jmodel.unembed(jp, h)),
            np32(jmodel.classify(jp, jt, jb)[0])]


def check_entries(enc, case, impl, dtype=jnp.float32):
    """forward / logits / classify of ``case`` through ``impl`` in
    ``dtype`` against the reference. float32: within 2e-5. bfloat16: the
    two frameworks round in other places (JAX's GELU and adds round each
    step to bf16), a few bf16 units at the logits' magnitude (~4), so each
    output is held against the reference's float32 output, no further
    from it than ``BF16_FACTOR`` x the reference's own bf16 output is."""
    name, cfg, jp, pcfg, params = enc
    jb = jax_bundle(cfg, jp, case)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    model = Model(pcfg, ModelOptions(attn_impl=impl, compute_dtype=tdt),
                  device="cpu")
    want = _reference_entries(cfg, jp, jb, case, impl, jnp.float32)
    got = _entries(model, params, torch.from_numpy(_tokens(cfg)),
                   port_bundle(jb))
    ref16 = (_reference_entries(cfg, jp, jb, case, impl, dtype)
             if dtype == jnp.bfloat16 else None)
    for i, what in enumerate(("forward", "logits", "classify")):
        assert got[i].dtype == tdt
        msg = f"{name} {case} {impl} {what}"
        if ref16 is None:
            np.testing.assert_allclose(np32(got[i]), want[i], **TOL[dtype],
                                       err_msg=msg)
        else:
            err = np.abs(np32(got[i]) - want[i]).max()
            assert err <= BF16_FACTOR * np.abs(ref16[i] - want[i]).max(), msg


# ---------------------------------------------------------------------------
# configs, layers, init, bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ENCODERS)
def test_configs_equal_reference(name):
    """The port's config copies equal the reference's field by field, at
    full size and reduced; Model constructs on both (no weights drawn) and
    sizes the learned positions as the reference does (640 rows at full
    size, 192 reduced)."""
    for reduce in (False, True):
        want = _jcfg(name) if reduce else jconfigs.get(name)
        mine = _pcfg(name) if reduce else configs.get(name)
        assert dataclasses.asdict(mine) == dataclasses.asdict(want)
        assert Model(mine, device="cpu").max_pos() == JModel(want).max_pos()
    assert Model(configs.get(name), device="cpu").max_pos() == 640
    assert Model(configs.get(name), ModelOptions(max_learned_pos=700),
                 device="cpu").max_pos() == 700


@pytest.mark.parametrize("kind,eps", [("layernorm", 1e-5),
                                      ("layernorm", 1e-7),
                                      ("nonparametric", 1e-5)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_norms_match_reference(rng, kind, eps, dtype):
    """LayerNorm (mean, biased variance, float32) at roberta's and
    deberta's eps, and the non-parametric norm; inputs with a large mean,
    where a one-pass variance would lose digits."""
    cfg = _pcfg("roberta-large").replace(norm_type=kind, norm_eps=eps)
    jcfg = _jcfg("roberta-large").replace(norm_type=kind, norm_eps=eps)
    xj, xt = both(rng.normal(size=(3, 5, cfg.d_model)) * 3.0 + 7.0, dtype)
    assert PL.norm_init(cfg, "cpu").keys() == JL.norm_init(jcfg).keys()
    pj, pt = {}, {}
    for k in JL.norm_init(jcfg):
        pj[k], pt[k] = both(rng.normal(size=cfg.d_model))
    got = PL.apply_norm(cfg, pt, xt)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(np32(got), np32(JL.apply_norm(jcfg, pj, xj)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gelu_mlp_matches_reference(rng, dtype):
    cfg, jcfg = _pcfg("roberta-large"), _jcfg("roberta-large")
    jp = _moved(jax.device_get(JL.mlp_init(jax.random.PRNGKey(0), jcfg)), 2)
    pt = {k: torch.from_numpy(v) for k, v in jp.items()}
    gen = torch.Generator().manual_seed(0)
    mine = PL.mlp_init(cfg, gen, "cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert not mine["b1"].any() and not mine["b2"].any()
    xj, xt = both(rng.normal(size=(2, 7, cfg.d_model)), dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    np.testing.assert_allclose(
        np32(PL.apply_mlp(cfg, pt, xt, tdt)),
        np32(JL.apply_mlp(jcfg, jp, xj, dtype)), **TOL[dtype])


@pytest.mark.parametrize("name", ENCODERS)
def test_init_has_the_reference_tree(name):
    """Model.init draws the reference's tree and shapes (learned positions
    (max_pos, d), the untied head (d, V), LayerNorm scale and bias, the
    GELU MLP); norm parameters stay float32 under a bf16 param dtype,
    through the bridge too."""
    cfg, pcfg = _jcfg(name), _pcfg(name)
    want = jax.eval_shape(JModel(cfg).init, jax.random.PRNGKey(0))
    model = Model(pcfg, ModelOptions(param_dtype=torch.bfloat16),
                  device="cpu")
    params = model.init(0)
    mine = bridge.params_to_jax(pcfg, params)
    assert jax.tree.structure(mine) == jax.tree.structure(want)
    assert [x.shape for x in jax.tree.leaves(mine)] == \
        [x.shape for x in jax.tree.leaves(want)]
    assert params["embed"]["pos"].shape == (192, pcfg.d_model)
    for lp in params["layers"]:
        for norm in ("ln1", "ln2"):
            assert {k: v.dtype for k, v in lp[norm].items()} == {
                "scale": torch.float32, "bias": torch.float32}
        assert lp["mlp"]["b1"].dtype == torch.bfloat16
    assert params["final_norm"]["bias"].dtype == torch.float32
    assert params["lm_head"]["w"].dtype == torch.bfloat16
    host = jax.device_get(JModel(cfg).init(jax.random.PRNGKey(0)))
    back = bridge.params_from_jax(pcfg, host, device="cpu",
                                  dtype=torch.bfloat16)
    assert back["layers"][1]["ln2"]["bias"].dtype == torch.float32
    assert back["final_norm"]["scale"].dtype == torch.float32
    assert back["embed"]["pos"].dtype == torch.bfloat16


def test_bridge_round_trips_bitwise(enc):
    """reference -> port -> reference and port -> reference -> port bit
    for bit, embed.pos, lm_head, LayerNorm biases and the GELU MLP
    included, leaves compared by path."""
    name, cfg, jp, pcfg, params = enc
    back = bridge.params_to_jax(pcfg, params)
    paths = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]:
        np.testing.assert_array_equal(paths.pop(path), a,
                                      err_msg=jax.tree_util.keystr(path))
    assert not paths
    mine = Model(pcfg, device="cpu").init(3)
    again = bridge.params_from_jax(pcfg, bridge.params_to_jax(pcfg, mine),
                                   device="cpu")
    assert again.keys() == mine.keys()
    for path, a in jax.tree_util.tree_flatten_with_path(mine)[0]:
        b = again
        for k in path:
            b = b[k.key if hasattr(k, "key") else k.idx]
        assert torch.equal(a, b), jax.tree_util.keystr(path)


# ---------------------------------------------------------------------------
# forward / logits / classify against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SERVED)
def test_kernel_path_matches_reference(enc, case):
    """The kernel path (plain versions on the CPU) against the reference's
    Pallas path in float32."""
    check_entries(enc, case, "kernel")


@pytest.mark.parametrize("case", SERVED + TRAINED)
def test_ref_path_matches_reference(enc, case):
    """The training path against the reference's ``attn_impl="ref"``."""
    check_entries(enc, case, "ref")


@pytest.mark.parametrize("case", ["none", "aot_multitask", "ptv2"])
def test_kernel_path_bf16_matches_reference(enc, case):
    """bf16 compute (float32 weights) against the reference's float32
    Pallas path, beside its bf16 one (:func:`check_entries`)."""
    check_entries(enc, case, "kernel", jnp.bfloat16)


def test_classify_pools_the_mean(enc):
    """An encoder's classify pools the mean over positions, a causal
    stack's the last position."""
    name, cfg, jp, pcfg, params = enc
    model = Model(pcfg, device="cpu")
    pb = port_bundle(jax_bundle(cfg, jp, "bitfit"))
    toks = torch.from_numpy(_tokens(cfg))
    h = model.forward(params, toks, pb)
    head = pb["params"]["head"]
    assert torch.equal(model.classify(params, toks, pb),
                       h.mean(1) @ head["w"] + head["b"])
    causal = Model(pcfg.replace(causal=True, is_encoder_only=False),
                   device="cpu")
    hc = causal.forward(params, toks, pb)
    assert torch.equal(causal.classify(params, toks, pb),
                       hc[:, -1] @ head["w"] + head["b"])


def test_encoder_attends_both_ways(enc):
    """Changing the last token moves every position's output (full
    attention), and the multi-task batch with every task id 0 gives the
    single-table call's outputs bitwise."""
    name, cfg, jp, pcfg, params = enc
    model = Model(pcfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg))
    other = toks.clone()
    other[:, -1] = (other[:, -1] + 1) % cfg.vocab_size
    a, b = model.forward(params, toks), model.forward(params, other)
    assert bool((a - b).abs().amax(-1).gt(0).all())
    multi = port_bundle(jax_bundle(cfg, jp, "aot_multitask"))
    multi["task_ids"] = torch.zeros(B, dtype=torch.int32)
    single = bridge.peft_from_jax(
        {"aot": {"table": multi["params"]["aot"]["table"][:, 0].numpy()}},
        jax_bundle(cfg, jp, "aot")["opt"], device="cpu")
    assert torch.equal(model.logits(params, toks, multi),
                       model.logits(params, toks, single))


def test_kernel_path_launches_once_per_layer(enc, monkeypatch):
    """Every layer of the kernel path launches one flash attention (full
    mode) and, with AoT, one plain gather-add (no norm: post-LN has no
    input norm to fuse) and no norm kernel; the wrappers forced onto their
    kernel branch, with the plain versions standing in for the kernels."""
    name, cfg, jp, pcfg, params = enc
    model = Model(pcfg, device="cpu")
    seen = []

    def flash(q, k, v, *, causal, window, q_offset):
        seen.append(("flash", causal, q_offset))
        return ops.flash_attention_plain(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset)

    def gather(h, table, ids, *, norm):
        seen.append(("gather", norm))
        return ops.aot_gather_add_plain(h, table, ids, norm=norm)

    def gather_multi(h, tables, task_ids, ids, *, norm):
        seen.append(("multi", norm))
        return ops.aot_gather_add_multitask_plain(h, tables, task_ids, ids,
                                                  norm=norm)
    monkeypatch.setattr(ops, "_on_cpu", lambda *xs: False)
    monkeypatch.setattr(ops, "flash_attention_kernel", flash)
    monkeypatch.setattr(ops, "aot_gather_add_kernel", gather)
    monkeypatch.setattr(ops, "aot_gather_add_multitask_kernel", gather_multi)
    monkeypatch.setattr(ops, "rms_norm_kernel", None)
    toks = torch.from_numpy(_tokens(cfg))
    L = pcfg.num_layers
    for case, want in (("aot", [("gather", None)]),
                       ("aot_multitask", [("multi", None)]),
                       ("ptv2", []), ("none", [])):
        seen.clear()
        ops.reset_launches()
        pb = port_bundle(jax_bundle(cfg, jp, case))
        with torch.no_grad():
            model.logits(params, toks, None if case == "none" else pb)
        q_off = PROMPT if case == "ptv2" else 0
        assert seen == (want + [("flash", False, q_off)]) * L, case
        counts = ops.launches()
        assert counts["flash_attention"] == L and counts["rms_norm"] == 0
        assert counts["aot_gather_add"] == (L if case == "aot" else 0)
        assert counts["aot_gather_add_multitask"] == (
            L if case == "aot_multitask" else 0)
    ops.reset_launches()


# ---------------------------------------------------------------------------
# positions, refusals
# ---------------------------------------------------------------------------

def test_learned_positions_reach(enc):
    """P-Tuning v1's prompt and the tokens share the learned positions:
    up to max_pos positions run, one more raises instead of reading past
    ``embed.pos`` (640 rows, as the full configs have them)."""
    name, cfg, jp, pcfg, _ = enc
    model = Model(pcfg, ModelOptions(attn_impl="ref", max_learned_pos=640),
                  device="cpu")
    params = model.init(0)
    assert params["embed"]["pos"].shape[0] == 640
    opt = JP.PEFTOptions(method="ptv1", prompt_len=20)
    pb = bridge.peft_from_jax(jax.device_get(JP.init(
        jax.random.PRNGKey(1), cfg, opt)), opt, device="cpu")
    rng = np.random.default_rng(0)
    ok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 620)))
    assert model.forward(params, ok, pb).shape == (1, 620, pcfg.d_model)
    far = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 621)))
    with pytest.raises(ValueError, match="641 positions"):
        model.forward(params, far, pb)
    with pytest.raises(ValueError, match="641 positions"):
        model.forward(params, torch.zeros(1, 641, dtype=torch.long))


def test_serving_entry_points_refuse_an_encoder(enc):
    """prefill, decode_step, mixed_step, ServeEngine and the serving
    launcher raise NotImplementedError for an encoder; the smollm serving
    path is unchanged."""
    name, cfg, jp, pcfg, params = enc
    model = Model(pcfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg))
    msg = "causal stacks"
    with pytest.raises(NotImplementedError, match=msg):
        check_servable(pcfg)
    with pytest.raises(NotImplementedError, match=msg):
        model.prefill(params, toks, max_len=32)
    with pytest.raises(NotImplementedError, match=msg):
        model.decode_step(params, toks[:, :1], 3, model.init_cache(B, 32))
    pool = model.init_paged_cache(4, 8)
    with pytest.raises(NotImplementedError, match=msg):
        model.mixed_step(params, toks[:1, :2].T, torch.zeros(2).int(),
                         torch.arange(2).int(), pool,
                         block_tables=torch.ones(1, 2).int())
    with pytest.raises(NotImplementedError, match=msg):
        ServeEngine(model, params, ServeConfig(max_len=32))
    with pytest.raises(NotImplementedError, match=msg):
        serve_launcher.main(["--arch", name, "--reduced", "--device", "cpu",
                             "--demo", "--tasks", "2", "--requests", "2",
                             "--quiet"])
    check_servable(configs.get("smollm-360m"))
