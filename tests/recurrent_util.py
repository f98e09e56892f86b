"""Shared set-up of the recurrent-backbone tests (recurrentgemma-9b's
RG-LRU hybrid and xlstm-350m's mLSTM / sLSTM stack): reduced configs of
both packages, one set of weights on both sides (the port's ``Model.init``
carried into the reference's grouped layout by the bridge: the reference's
own init of the 8-block xLSTM takes about 10 s on the CPU, the port's a
fraction of one), fused task tables likewise, PEFT bundles on both sides,
and the comparison of caches leaf by leaf.

Variants: ``rgemma`` (reduced recurrentgemma: one (rglru, rglru, attn)
unit, window 16), ``rgemma5`` (that unit and the (rglru, rglru) remainder,
which ``reduced`` drops, window 8: both groups of ``layer_plan`` and a ring
that wraps), ``xlstm`` (reduced xlstm: seven mLSTM blocks and one sLSTM,
d 64, four heads) and ``xlstm2`` (that config cut to one mLSTM and one
sLSTM block: the reference's compile time grows with the blocks, so the
cases that compile most take it, and the 8-block stack keeps the
prefill / decode comparison, the init tree, the bridge and a
checkpoint). The reference runs with ``attn_impl="pallas"`` (its
kernels in interpret mode), mLSTM chunks of 4; the port with its kernels'
plain versions.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from port_util import jax_peft, port_tables, port_tasks_peft
from repro import configs as jconfigs
from repro.core import aot as JA
from repro.core import peft as JP
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions as JOpts
from repro_torch import bridge, configs
from repro_torch.core import aot as aot_mod
from repro_torch.models.model import Model, ModelOptions

CHUNK = 4           # mLSTM's chunk on both sides
B = 2
TOL = dict(atol=2e-5, rtol=2e-5)


VARIANTS = {
    "rgemma": ("recurrentgemma-9b", {}),
    "rgemma5": ("recurrentgemma-9b", dict(
        num_layers=5, pattern_remainder=("rglru", "rglru"),
        sliding_window=8)),
    "xlstm": ("xlstm-350m", {}),
    "xlstm2": ("xlstm-350m", dict(num_layers=2,
                                  pattern_unit=("mlstm", "slstm"))),
}


def cfgs(variant):
    """(reference config, port config) of ``variant``."""
    name, change = VARIANTS[variant]
    return tuple(mod.reduced(mod.get(name)).replace(**change)
                 for mod in (jconfigs, configs))


@functools.lru_cache(maxsize=None)
def setup(variant):
    """(port cfg, reference model, reference params (numpy, the grouped
    layout), port model, port params): the port's init, seed 0, on both
    sides."""
    jcfg, cfg = cfgs(variant)
    jmodel = JModel(jcfg, JOpts(attn_impl="pallas", mlstm_chunk=CHUNK))
    model = Model(cfg, ModelOptions(mlstm_chunk=CHUNK), device="cpu")
    params = model.init(0)
    return cfg, jmodel, bridge.params_to_jax(cfg, params), model, params


@functools.lru_cache(maxsize=None)
def task_tables(variant, n):
    """``n`` fused task tables (the port's ``random_fused``, seeds 0..n-1)
    as the reference's list of ``{"table": (L, V, d)}`` numpy trees."""
    cfg, _, _, _, params = setup(variant)
    return [{"table": aot_mod.random_fused(
        cfg, params["embed"]["tok"], seed=t)["table"].numpy()}
        for t in range(n)]


def tokens(cfg, b=B, s=16, seed=5):
    rr = np.random.default_rng(seed)
    return rr.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def bundles(variant, method, classify=False):
    """(reference bundle, port bundle) of ``method`` with seeded non-zero
    parameters (so a hook applied where it must not be shows); ``aot4``:
    four stacked fused tasks, task ids 0, 1 by row; ``classify`` adds a
    seeded classification head."""
    cfg = setup(variant)[0]
    pb = None
    if method == "none":
        jb = JP.make({}, JP.PEFTOptions(method="none"))
    elif method in ("aot", "aot4"):
        tasks = task_tables(variant, 4)[:1 if method == "aot" else 4]
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
        shapes = jax.eval_shape(lambda k: JP.init(k, cfg, opt),
                                jax.random.PRNGKey(1))
        rng = np.random.default_rng(3)
        jb = JP.make(jax.tree.map(lambda x: (rng.normal(size=x.shape) * 0.1)
                                  .astype(x.dtype), shapes), opt)
    jb = dict(jb, params=jax.device_get(dict(jb["params"])))
    if classify:
        rng = np.random.default_rng(9)
        jb["params"]["head"] = {
            "w": (rng.normal(size=(cfg.d_model, 3)) * 0.1).astype(np.float32),
            "b": (rng.normal(size=3) * 0.1).astype(np.float32)}
    if pb is None:
        return jb, bridge.peft_from_jax(jb["params"], jb["opt"],
                                        device="cpu")
    if classify:
        pb = dict(pb, params=dict(pb["params"], head={
            k: torch.from_numpy(v) for k, v in jb["params"]["head"].items()}))
    return jb, pb


def cache_leaves(cfg, cache):
    """The port's cache as the reference's grouped layout's leaves, in
    jax's order (numpy, float32)."""
    return jax.tree.leaves(bridge.cache_to_jax(cfg, cache))


def assert_caches_close(cfg, port_cache, jcache, exact=False):
    """Every leaf of the port's cache against the reference's (the same
    tree once regrouped), the stabilizers' -1e30 included: bitwise when
    ``exact``, else within 2e-5 relative and 2e-5 times the leaf's largest
    magnitude (at least 1) absolute. A state sums many terms (the mLSTM
    matrix memory adds a chunk's outer products to what it holds, and grows
    past 2), so its float32 rounding scales with its size."""
    want = jax.tree.leaves(jax.device_get(jcache))
    got = cache_leaves(cfg, port_cache)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b, np.float32)
        if exact:
            np.testing.assert_array_equal(a, b)
            continue
        top = max(1.0, float(np.abs(np.where(b > -1e29, b, 0.0)).max()))
        np.testing.assert_allclose(a, b, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * top)
