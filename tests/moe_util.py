"""Shared helpers of the mixture-of-experts tests (``test_torch_moe*.py``):
the reduced configs of qwen3-moe-30b-a3b (``reduced(repeats=2)``: 2 MoE
layers, 4 experts top-2, q/k norm) and llama4-maverick-400b-a17b
(``reduced(repeats=4)``: R = 2 repeats of the (dense, MoE) unit, top-1
with a shared expert), the reference's weights carried into the port by
the bridge, the PEFT bundles of both sides, and the tolerances: 2e-5 in
float32 (absolute and relative); in bfloat16 2e-2 of the output's largest
magnitude (:func:`assert_bf16_close`: the experts' outputs reach |y| ~ 100
at the reduced widths, where one bf16 ulp is 0.5, so an elementwise 2e-2
would fail every element near zero on a rounding order).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_util import jax_peft, jax_tasks, np32, port_tables, port_tasks_peft
from repro import configs as jconfigs
from repro.core import aot as JA
from repro.core import peft as JP
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions as JOpts
from repro_torch import bridge, configs
from repro_torch.models.model import Model, ModelOptions

QWEN, LLAMA = "qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b"
NAMES = [QWEN, LLAMA]
REPEATS = {QWEN: 2, LLAMA: 4}
TOL = dict(atol=2e-5, rtol=2e-5)
BF16 = 2e-2
METHODS = ["none", "aot", "aot4", "bitfit", "lora", "adapters", "ptv2"]
B, S = 2, 20


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The module's torch work on one thread (restored after it): the
    tier-1 run puts six pytest workers on the machine's cores, and torch's
    default of a thread per core in each worker oversubscribes them (a CPU
    training loop of small ops ran about 25x slower that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(name, factor=None):
    """The reference's and the port's reduced config of ``name``, with the
    MoE's capacity factor set to ``factor`` when given."""
    out = []
    for mod in (jconfigs, configs):
        cfg = mod.reduced(mod.get(name), repeats=REPEATS[name])
        if factor is not None:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=factor))
        out.append(cfg)
    return out


@functools.lru_cache(maxsize=None)
def setup(name, factor=None):
    """(port cfg, reference model, reference params, port model, port
    params): the reference's init (q/k norm scales redrawn as 1 + seeded
    normals x 0.1, so a missing or misplaced norm shows), carried into the
    port by the bridge."""
    jcfg, cfg = cfgs(name, factor)
    jmodel = JModel(jcfg, JOpts(attn_impl="pallas"))
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    if jcfg.qk_norm:
        rng = np.random.default_rng(11)
        attn = jparams["groups"][0]["b0"]["attn"]
        for n in ("q_norm", "k_norm"):
            attn[n] = (1 + rng.normal(size=attn[n].shape) * 0.1).astype(
                np.float32)
    model = Model(cfg, ModelOptions(), device="cpu")
    params = bridge.params_from_jax(cfg, jparams, device="cpu")
    return cfg, jmodel, jparams, model, params


def assert_bf16_close(got, want):
    """max |got - want| within BF16 times max(1, max |want|)."""
    got, want = np32(got), np32(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= BF16 * scale, (err, scale)


def assert_close(got, want, dtype):
    if dtype == jnp.float32:
        np.testing.assert_allclose(np32(got), np32(want), **TOL)
    else:
        assert_bf16_close(got, want)


def tokens(cfg, b=B, s=S, seed=5):
    rr = np.random.default_rng(seed)
    return rr.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def bundles(cfg, jparams, method, classify=False):
    """(reference bundle, port bundle) for ``method``; ``aot4``: four
    stacked fused tasks with per-row task ids. ``classify`` adds a seeded
    classification head to both."""
    if method == "none":
        jb = JP.make({}, JP.PEFTOptions(method="none"))
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
