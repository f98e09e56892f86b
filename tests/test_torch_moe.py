"""The port's mixture-of-experts layer and model pieces against the JAX
reference, on the reduced configs of ``moe_util``: ``moe.apply_moe``
against the reference's ``apply_moe_gspmd`` (output, aux values, routing,
gradients), drop-free (the reduced default capacity factor 4.0) and with
drops (1.25, 0.25), and with padding rows placed before live rows (ROADMAP
C9: they claim capacity first and displace live assignments, in both
packages alike); ``rms_head_norm``; the configs and ``check_supported``;
the init tree, the bridge both ways (llama4's (dense, MoE) unit, R = 2),
a checkpoint in the reference's grouped layout; an AoT fc train step with
the MoE aux losses. ``test_torch_moe_logits.py`` holds the whole model's
logits, ``test_torch_moe_serve.py`` the serving paths.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_util import (B, LLAMA, NAMES, QWEN, TOL, assert_close, cfgs, setup,
                      tokens)
from moe_util import one_torch_thread  # noqa: F401 (autouse fixture)
from port_util import both, np32
from repro import configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import aot as JA
from repro.core import peft as JP
from repro.data.pipeline import LMStream
from repro.models import layers as JL
from repro.models import moe as jmoe
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions as JOpts
from repro.train import step as JS
from repro_torch import bridge, configs
from repro_torch import tree as T
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models import layers as L
from repro_torch.models import model as model_mod
from repro_torch.models import moe
from repro_torch.models.model import Model, ModelOptions
from repro_torch.train import step as PS


# ---------------------------------------------------------------------------
# configs and the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_config_copies_equal_reference(name):
    """The port's config files and ``reduced`` (repeats 1, 2 and 4) keep
    every field of the reference's; both full configs pass
    ``check_supported`` and ``check_servable``."""
    assert dataclasses.asdict(configs.get(name)) == dataclasses.asdict(
        jconfigs.get(name))
    for r in (1, 2, 4):
        assert dataclasses.asdict(configs.reduced(
            configs.get(name), repeats=r)) == dataclasses.asdict(
                jconfigs.reduced(jconfigs.get(name), repeats=r))
    assert configs.get(name) in configs.MOE
    model_mod.check_servable(configs.get(name))
    Model(configs.get(name), device="cpu")


@pytest.mark.parametrize("change", [
    dict(qk_norm=True),
    dict(moe=jconfigs.get(QWEN).moe)], ids=["qk_norm", "moe"])
def test_check_supported_accepts(change):
    """The two cases the refusal test in ``test_torch_decoders.py`` held
    until the MoE slice: q/k norm and a MoE config are accepted now
    (softcap, front-ends, a bidirectional prefix and non-attention blocks
    are still refused there)."""
    cfg = configs.reduced(configs.get("smollm-360m")).replace(**change)
    model_mod.check_supported(cfg)
    model_mod.check_servable(cfg)


# ---------------------------------------------------------------------------
# rms_head_norm and apply_moe against the reference's functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_rms_head_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    xj, xt = both(rng.normal(size=(2, 5, 4, 16)) * 3, dtype)
    scale = (1 + rng.normal(size=16) * 0.1).astype(np.float32)
    want = JL.rms_head_norm(jnp.asarray(scale), xj)
    got = L.rms_head_norm(torch.from_numpy(scale), xt)
    assert got.dtype == xt.dtype
    assert_close(got, want, dtype)


def moe_inputs(name, T, seed=0, factor=None, dtype=jnp.float32):
    """(reference cfg, port cfg, reference params, port params, x (1, T,
    d) both sides) of the last layer's MoE (a MoE layer in both configs),
    x normals about a shared direction (so the router's load is uneven,
    as on real activations, and factor 1.25 drops)."""
    _, _, jparams, _, _ = setup(name)
    jcfg, pcfg = cfgs(name, factor)
    group = jparams["groups"][0]
    p32 = jax.tree.map(lambda a: np.asarray(a[-1]),
                       group[f"b{len(group) - 1}"]["moe"])
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), p32)
    pp = jax.tree.map(lambda a: torch.from_numpy(np32(a).copy()).to(tdt),
                      jp)
    jp["router"] = jnp.asarray(p32["router"])
    pp["router"] = torch.from_numpy(p32["router"].copy())
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, T, pcfg.d_model)) + 1.5 * rng.normal(
        size=pcfg.d_model)
    xj, xt = both(x, dtype)
    return jcfg, pcfg, jp, pp, xj, xt


def ref_routes(jcfg, jp, xj):
    """The reference's top-k experts (T, k) of the flat tokens."""
    logits = xj.reshape(-1, xj.shape[-1]).astype(jnp.float32) @ jp["router"]
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1),
                                    jcfg.moe.top_k)[1])


def check_moe(jcfg, pcfg, jp, pp, xj, xt, dtype):
    want, jaux = jmoe.apply_moe_gspmd(jcfg, jp, xj, dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    routes = []
    got, aux = moe.apply_moe(pcfg, pp, xt, tdt, record=routes)
    assert got.dtype == tdt and got.shape == xt.shape
    assert_close(got, want, dtype)
    np.testing.assert_array_equal(routes[0]["top_e"].numpy(),
                                  ref_routes(jcfg, jp, xj))
    for k in ("moe_lb_loss", "moe_z_loss", "moe_dropped_frac"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    return got, aux, routes[0]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,factor", [
    (QWEN, None), (QWEN, 1.25), (QWEN, 0.25), (LLAMA, None), (LLAMA, 0.25)],
    ids=["qwen-dropfree", "qwen-1.25", "qwen-0.25", "llama-dropfree",
         "llama-0.25"])
def test_apply_moe_matches_reference(name, factor, dtype):
    """64 tokens through one MoE layer: the output within the tolerance,
    the top-k experts equal and the three aux values within 1e-5. The
    reduced default factor 4.0 drops nothing; 0.25 (and for qwen 1.25)
    drops assignments, and their outputs match too."""
    args = moe_inputs(name, 64, factor=factor, dtype=dtype)
    _, aux, route = check_moe(*args, dtype)
    dropped = float(aux["moe_dropped_frac"])
    if factor is None:
        assert dropped == 0.0 and bool(route["keep"].all())
    elif factor == 0.25:
        assert dropped > 0.2
    else:
        assert dropped > 0.0


def test_padding_before_live_rows_displaces_them():
    """ROADMAP C9: at factor 1.25, 24 rows of one padding vector placed
    before 40 live rows claim capacity first. The output (displaced live
    rows included) equals the reference's; the same padding placed after
    the live rows changes no live row; placed before, it changes some."""
    jcfg, pcfg, jp, pp, _, _ = moe_inputs(QWEN, 1, factor=1.25)
    rng = np.random.default_rng(3)
    live = rng.normal(size=(40, pcfg.d_model))
    pad = np.repeat(rng.normal(size=(1, pcfg.d_model)), 24, axis=0)
    outs, drops = {}, {}
    for where, rows in (("alone", live), ("after", np.vstack([live, pad])),
                        ("before", np.vstack([pad, live]))):
        xj, xt = both(rows[None])
        got, _, route = check_moe(jcfg, pcfg, jp, pp, xj, xt, jnp.float32)
        live_rows = slice(24, 64) if where == "before" else slice(0, 40)
        outs[where] = got[0, live_rows]
        drops[where] = int((~route["keep"][live_rows]).sum())
    # placed after, the padding displaces nothing: the live rows drop no
    # more than alone (a larger T only widens the buckets)
    assert drops["after"] <= drops["alone"] == 0
    np.testing.assert_allclose(np32(outs["after"]), np32(outs["alone"]),
                               **TOL)
    moved = (outs["before"] - outs["after"]).abs().amax(-1) > 1e-4
    assert drops["before"] > 0 and int(moved.sum()) > 0


def smallest_displacement(pcfg, pp, seeds=range(50)):
    """The smallest (padding rows, live rows) found, by total tokens then
    padding rows, where the padding placed before the live rows changes a
    live row's output against the same padding placed after them (equal
    T, so equal capacity): (pad, live, seed, x with the padding first).
    The search starts at C + 1 tokens: a token's k experts are distinct,
    so an expert holds at most T assignments, and nothing drops while T
    <= C (C is at least 8)."""
    d = pcfg.d_model
    for total in range(moe._capacity(1, pcfg) + 1, 17):
        for n_pad in range(1, total):
            for seed in seeds:
                rng = np.random.default_rng(seed)
                live = rng.normal(size=(total - n_pad, d))
                pad = np.repeat(rng.normal(size=(1, d)), n_pad, axis=0)
                first = torch.from_numpy(np.vstack([pad, live])[None]).float()
                last = torch.from_numpy(np.vstack([live, pad])[None]).float()
                a, _ = moe.apply_moe(pcfg, pp, first, torch.float32)
                b, _ = moe.apply_moe(pcfg, pp, last, torch.float32)
                if (a[0, n_pad:] - b[0, :total - n_pad]).abs().max() > 1e-4:
                    return n_pad, total - n_pad, seed, first
    return None


def test_smallest_displacing_input():
    """ROADMAP C9's smallest case: on reduced qwen3-moe (4 experts, top-2)
    at factor 1.25, C = 8 up to T = 24 and each token's 2 experts are
    distinct, so a live token is displaced only behind 8 earlier tokens
    that chose its expert: T >= 9. The search finds T = 9: one padding
    row, then 8 live tokens that all share an expert with it, the last of
    them dropped; the reference gives the same output there."""
    jcfg, pcfg, jp, pp, _, _ = moe_inputs(QWEN, 1, factor=1.25)
    n_pad, n_live, seed, first = smallest_displacement(pcfg, pp)
    assert (n_pad, n_live) == (1, 8), (n_pad, n_live, seed)
    assert moe._capacity(n_pad + n_live, pcfg) == 8
    xj, xt = both(first.numpy())
    _, _, route = check_moe(jcfg, pcfg, jp, pp, xj, xt, jnp.float32)
    assert not bool(route["keep"][n_pad:].all())


@pytest.mark.parametrize("name,factor", [(QWEN, None), (QWEN, 0.25),
                                         (LLAMA, None)],
                         ids=["qwen-dropfree", "qwen-0.25", "llama"])
def test_apply_moe_gradients_match_reference(name, factor):
    """Gradients of sum(out * R) + lb + z with respect to the router,
    every expert leaf (the shared expert's too) and x, against
    ``jax.grad``, each within 1e-4 of its leaf's largest |g|. R is a fixed
    normal x 1e-2, so that the output term (|out| ~ 100 at these widths)
    weighs about what the aux terms do: at top-1 the renormalised weight
    p / p has zero derivative, and its float32 residue (~1e-7 / p times
    the output term's gradient) must stay below the tolerance."""
    jcfg, pcfg, jp, pp, xj, xt = moe_inputs(name, 48, seed=1, factor=factor)
    R = (np.random.default_rng(2).normal(size=xt.shape) * 1e-2).astype(
        np.float32)

    def jloss(p, x):
        out, aux = jmoe.apply_moe_gspmd(jcfg, p, x, jnp.float32)
        return (jnp.sum(out * R) + aux["moe_lb_loss"] + aux["moe_z_loss"])
    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, xj)
    leaves = [t.clone().requires_grad_(True) for t in T.leaves(pp)]
    tree = T.unflatten(pp, leaves)
    x = xt.clone().requires_grad_(True)
    with torch.enable_grad():
        out, aux = moe.apply_moe(pcfg, tree, x, torch.float32)
        loss = (out * torch.from_numpy(R)).sum() + aux["moe_lb_loss"] + \
            aux["moe_z_loss"]
        grads = torch.autograd.grad(loss, leaves + [x])
    got = T.unflatten(pp, list(grads[:-1]))
    for path in (("router",), ("wg",), ("wu",), ("wd",)) + (
            (("shared", "wg"), ("shared", "wd")) if "shared" in pp else ()):
        a, b = jg, got
        for k in path:
            a, b = a[k], b[k]
        top = float(np.abs(np.asarray(a)).max())
        assert top > 0, path
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4 * top, err_msg=str(path))
    top = float(np.abs(np.asarray(jgx)).max())
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-4 * top)


def test_capacity_matches_reference():
    for name in NAMES:
        for factor in (None, 1.25, 0.25, 128.0):
            jcfg, pcfg = cfgs(name, factor)
            for t in (1, 3, 8, 10, 40, 64, 263, 8192):
                assert moe._capacity(t, pcfg) == jmoe._capacity(t, jcfg)
    full = configs.get(QWEN)
    assert moe._capacity(8, full) == 8 and moe._capacity(263, full) == 24


# ---------------------------------------------------------------------------
# init, the bridge, a checkpoint in the reference's layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_init_tree_matches_reference(name):
    """``Model.init`` gives the reference's tree (shapes and dtypes, the
    MoE layers where ``moe_layer_mask`` puts them, llama4's shared
    expert); in bf16 the router and the q/k norms stay float32; the
    expert weights have the reference's std 1/sqrt(E) (ROADMAP C10)."""
    cfg, jmodel, jparams, model, _ = setup(name)
    mine = bridge.params_to_jax(cfg, model.init(0))
    shapes = lambda t: jax.tree.map(lambda x: (x.shape, str(x.dtype)), t)
    assert shapes(mine) == shapes(jparams)
    assert jax.tree.structure(mine) == jax.tree.structure(jparams)
    bf = Model(cfg, ModelOptions(param_dtype=torch.bfloat16),
               device="cpu").init(0)
    for i, lp in enumerate(bf["layers"]):
        assert ("moe" in lp) == cfg.moe_layer_mask()[i]
        assert ("mlp" in lp) != ("moe" in lp)
        if "moe" in lp:
            assert lp["moe"]["router"].dtype == torch.float32
            assert lp["moe"]["wg"].dtype == torch.bfloat16
        if cfg.qk_norm:
            assert lp["attn"]["q_norm"].dtype == torch.float32
    # 16 experts at d 64: std 0.88 / sqrt(16) (a normal truncated at 2
    # std keeps 0.88 of it), not 0.88 / sqrt(64)
    big = cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=16))
    w = Model(big, device="cpu").init(0)["layers"][-1]["moe"]["wg"]
    assert abs(float(w.std()) - 0.88 / 4) < 0.01


@pytest.mark.parametrize("name", NAMES)
def test_bridge_round_trip(name):
    """params_from_jax then params_to_jax gives the reference's tree back
    bitwise; layer ``start + r * U + u`` of the port is repeat r, unit
    position u of the reference (llama4: U = 2, R = 2); under a bf16 cast
    the router and the q/k norms stay float32."""
    cfg, _, jparams, _, params = setup(name)
    back = bridge.params_to_jax(cfg, params)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    group = jparams["groups"][0]
    U = len(group)
    assert U == (2 if name == LLAMA else 1)
    for i, lp in enumerate(params["layers"]):
        r, u = divmod(i, U)
        want = group[f"b{u}"]["attn"]["wq"][r]
        np.testing.assert_array_equal(lp["attn"]["wq"].numpy(), want)
        assert ("moe" in lp) == cfg.moe_layer_mask()[i]
    bf = bridge.params_from_jax(cfg, jparams, device="cpu",
                                dtype=torch.bfloat16)
    lp = bf["layers"][-1]
    assert lp["moe"]["router"].dtype == torch.float32
    assert lp["moe"]["wu"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        lp["moe"]["router"].numpy(),
        group[f"b{U - 1}"]["moe"]["router"][-1])


def test_cache_from_jax_groups_interleaved_layers():
    """The reference's contiguous cache of llama4 (two groups' worth of
    ``b0`` / ``b1`` leaves (R, ...)) lands in global layer order."""
    cfg, jmodel, jparams, model, params = setup(LLAMA)
    toks = tokens(cfg, s=6)
    _, jcache, _ = jax.jit(lambda t: jmodel.prefill(
        jparams, {"tokens": t}, max_len=8))(jnp.asarray(toks))
    _, cache, _ = model.prefill(params, torch.from_numpy(toks), max_len=8)
    want = bridge.cache_from_jax(cfg, jax.device_get(jcache), device="cpu")
    for n in ("k", "v"):
        assert want[n].shape == cache[n].shape == (4, B, 8, 1, 16)
        np.testing.assert_allclose(np32(cache[n]), np32(want[n]), **TOL)


def test_checkpoint_of_interleaved_backbone_has_reference_manifest(tmp_path):
    """Reduced llama4's backbone written by the port's manager in the
    reference's grouped layout (``bridge.params_to_jax``) and the
    reference's parameters written by its own: ``manifest.json`` byte for
    byte, every array equal; restored into the port's layers bitwise."""
    cfg, _, jparams, _, params = setup(LLAMA)
    JManager(str(tmp_path / "ref"), async_save=False).save(3, jparams)
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        3, bridge.params_to_jax(cfg, params))
    read = lambda side: open(os.path.join(
        tmp_path, side, "step_0000000003", "manifest.json")).read()
    assert read("port") == read("ref")
    assert json.loads(read("port"))["structure"] == str(
        jax.tree.structure(jparams))
    def arrays(side):
        with np.load(os.path.join(tmp_path, side, "step_0000000003",
                                  "arrays.npz")) as z:
            return {k: z[k] for k in z.files}
    ref, port = arrays("ref"), arrays("port")
    assert sorted(ref) == sorted(port)
    for k, v in ref.items():
        np.testing.assert_array_equal(port[k], v)
    got, _ = JManager(str(tmp_path / "port")).restore(jparams)
    back = bridge.params_from_jax(cfg, jax.device_get(got), device="cpu")
    for a, b in zip(T.leaves(back), T.leaves(params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# training: one AoT fc step with the MoE aux losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_aot_fc_train_step_matches_reference(name):
    """Loss (with the weighted ``moe_lb`` / ``moe_z`` terms) within 1e-5
    relative, the metrics ``moe_lb`` / ``moe_drop``, every gradient leaf
    within 1e-4 of its largest |g| against ``jax.grad``, and the
    parameters and AdamW moments after 3 steps (lr 1e-3) within 1e-5."""
    cfg, _, jparams, _, params = setup(name)
    popt = JP.PEFTOptions(method="aot", aot=JA.AoTOptions(
        mode="fc", rank=4, dropout=0.0))
    rng = np.random.default_rng(0)
    pp = jax.device_get(jax.tree.map(lambda x: x + jnp.asarray(
        rng.normal(size=x.shape) * 0.05, x.dtype),
        JP.init(jax.random.PRNGKey(1), cfg, popt)))
    stream = LMStream(cfg.vocab_size, 32, 4, seed=0)
    batches = [stream.next() for _ in range(3)]
    jt = JS.TrainConfig(peft=popt, lr=1e-3, loss_chunk=8)
    bundle = bridge.peft_from_jax(pp, popt, device="cpu")
    pt = PS.TrainConfig(peft=bundle["opt"], lr=1e-3, loss_chunk=8)
    assert (pt.moe_lb_weight, pt.moe_z_weight) == (jt.moe_lb_weight,
                                                   jt.moe_z_weight)
    jmodel = JModel(cfg, JOpts(attn_impl="ref", remat=False))
    model = Model(cfg, ModelOptions(attn_impl="ref"), device="cpu")
    jtr, jfr = JS.split_train(jparams, pp, "aot")
    ptr, pfr = PS.split_train(params, bundle["params"], "aot")
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    pb = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    jloss_fn = JS.make_loss_fn(jmodel, jt)
    with torch.enable_grad():
        ploss, pm = PS.make_loss_fn(model, pt)(ptr, pfr, pb, None)
        grads = torch.autograd.grad(ploss, T.leaves(ptr), allow_unused=True)
    ploss = ploss.detach()
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda t: jloss_fn(t, jfr, jb, None), has_aux=True))(jtr)
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(pm["total_loss"].detach()) > float(pm["loss"])  # aux added
    for k in ("moe_lb", "moe_drop", "loss"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
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
    js, ps = jinit(jtr), pinit(ptr)
    jstep = jax.jit(jstep)
    for batch in batches:
        js, _ = jstep(js, jfr, {k: jnp.asarray(v) for k, v in batch.items()},
                      None)
        ps, _ = pstep(ps, pfr, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, None)
    for part in ("trainable", "opt"):
        ja = jax.tree.leaves(jax.device_get(js[part]))
        pa = T.sorted_leaves(ps[part])
        assert len(ja) == len(pa)
        for a, b in zip(ja, pa):
            b = b.detach().float().numpy() if torch.is_tensor(b) else b
            np.testing.assert_allclose(np.asarray(b, np.float32),
                                       np.asarray(a, np.float32), rtol=0,
                                       atol=1e-5)
