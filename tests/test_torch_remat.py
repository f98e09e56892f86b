"""Layer rematerialization (``ModelOptions.remat``) in the port: the loss
and every trainable gradient bitwise the same with remat on and off under
each policy (none, ``"dots"``, the names ``("attn_mix", "moe_out")``),
within 2e-5 of the reference's ``jax.grad``; fewer ops run again in the
backward under a saving policy than under none; AoT's dropout replayed in
the recompute; forward outputs under ``no_grad`` unchanged. Reduced
smollm-360m and qwen3-moe-30b-a3b in float32, ``attn_impl="ref"``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.core import aot as JA
from repro.core import peft as JP
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions as JOpts
from repro.train import step as JS
from repro_torch import bridge, configs
from repro_torch import tree as T
from repro_torch.models.model import Model, ModelOptions, layer_units
from repro_torch.train import step as PS

ARCHS = {"smollm-360m": 2, "qwen3-moe-30b-a3b": 2}
POLICIES = {"none": dict(), "dots": dict(remat_policy_name="dots"),
            "names": dict(remat_save_names=("attn_mix", "moe_out"))}
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def setup(arch, dropout=0.0):
    """Both sides' reduced config, the reference's weights carried into the
    port, AoT fc parameters (rank 4) moved off their init, a batch."""
    jcfg = jconfigs.reduced(jconfigs.get(arch), repeats=ARCHS[arch])
    cfg = configs.reduced(configs.get(arch), repeats=ARCHS[arch])
    jmodel = JModel(jcfg, JOpts(attn_impl="ref", remat=False))
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    popt = JP.PEFTOptions(method="aot", aot=JA.AoTOptions(
        mode="fc", rank=4, dropout=dropout))
    rng = np.random.default_rng(0)
    pp = jax.device_get(jax.tree.map(
        lambda x: x + jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype),
        JP.init(jax.random.PRNGKey(1), jcfg, popt)))
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": tokens[:, :-1].astype(np.int32),
             "labels": tokens[:, 1:].astype(np.int32)}
    return jcfg, cfg, jmodel, jparams, popt, pp, batch


def port_loss_grads(arch, remat, policy, dropout=0.0, count=False):
    """The port's loss and trainable gradients (and the number of ops the
    backward ran, with ``count``)."""
    _, cfg, _, jparams, popt, pp, batch = setup(arch, dropout)
    model = Model(cfg, ModelOptions(attn_impl="ref", remat=remat,
                                    **POLICIES[policy]), device="cpu")
    params = bridge.params_from_jax(cfg, jparams, device="cpu")
    bundle = bridge.peft_from_jax(pp, popt, device="cpu")
    tcfg = PS.TrainConfig(peft=bundle["opt"], loss_chunk=8)
    trainable, frozen = PS.split_train(params, bundle["params"], "aot")
    pb = {k: torch.from_numpy(v) for k, v in batch.items()}
    rng = torch.Generator().manual_seed(7) if dropout else None
    with torch.enable_grad():
        loss, _ = PS.make_loss_fn(model, tcfg)(trainable, frozen, pb, rng)
        with OpCount() as ops:
            grads = torch.autograd.grad(loss, T.leaves(trainable))
    out = (loss.detach(), [g.detach() for g in grads])
    return out + (ops.n,) if count else out


class OpCount(TorchDispatchMode):
    """The number of aten ops run while active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_units_are_the_reference_groups():
    """The remat units cover every layer once, in the reference's groups
    (recurrentgemma's remainder; llama4's (dense, MoE) pairs)."""
    for name in configs.REGISTRY:
        cfg = configs.get(name)
        units = layer_units(cfg)
        assert [i for lo, hi in units for i in range(lo, hi)] == list(
            range(cfg.num_layers)), name
    assert layer_units(configs.get("recurrentgemma-9b"))[-1] == (36, 38)
    assert {hi - lo for lo, hi in layer_units(
        configs.get("llama4-maverick-400b-a17b"))} == {2}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_bitwise_and_against_reference(arch):
    """Loss and gradients bitwise with remat on (each policy) and off; the
    same within 2e-5 of the reference's loss and jax.grad."""
    base_loss, base_grads = port_loss_grads(arch, False, "none")
    for policy in POLICIES:
        loss, grads = port_loss_grads(arch, True, policy)
        assert torch.equal(loss, base_loss), policy
        for a, b in zip(grads, base_grads):
            assert torch.equal(a, b), policy
    jcfg, cfg, jmodel, jparams, popt, pp, batch = setup(arch)
    tcfg = JS.TrainConfig(peft=popt, loss_chunk=8)
    trainable, frozen = JS.split_train(jparams, pp, "aot")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = JS.make_loss_fn(jmodel, tcfg)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda t: fn(t, frozen, jb, None), has_aux=True))(trainable)
    assert abs(float(base_loss) - float(jloss)) <= 2e-5 * max(
        1.0, abs(float(jloss)))
    want = jax.tree.leaves(jax.device_get(jg))
    got = jax.tree.leaves(bridge.to_numpy({"peft": T.unflatten(
        {"peft": bridge.peft_from_jax(pp, popt, device="cpu")["params"]},
        base_grads)["peft"]}))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-5 * max(
            1.0, float(np.abs(a).max())))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_saving_policies_recompute_less(arch):
    """The backward runs fewer ops under "dots" and under the names than
    under no policy (a saved op is not run again), and more with remat
    on than off."""
    n = {p: port_loss_grads(arch, True, p, count=True)[2] for p in POLICIES}
    off = port_loss_grads(arch, False, "none", count=True)[2]
    assert n["dots"] < n["none"] and n["names"] < n["none"], n
    assert off < n["none"], (off, n)


def test_dropout_replayed_in_the_recompute():
    """AoT's dropout (fc, p = 0.1, the step's generator): remat on gives
    the loss and gradients of remat off bit for bit."""
    a = port_loss_grads("smollm-360m", False, "none", dropout=0.1)
    b = port_loss_grads("smollm-360m", True, "none", dropout=0.1)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_no_grad_forward_unchanged(arch):
    """Under no_grad, remat changes nothing: the same logits bitwise and
    the same ops."""
    _, cfg, _, jparams, popt, pp, batch = setup(arch)
    params = bridge.params_from_jax(cfg, jparams, device="cpu")
    tokens = torch.from_numpy(batch["tokens"])
    outs = []
    for remat in (True, False):
        model = Model(cfg, dataclasses.replace(
            ModelOptions(attn_impl="ref"), remat=remat), device="cpu")
        with torch.no_grad(), OpCount() as ops:
            outs.append((model.logits(params, tokens), ops.n))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]
