"""The mixture-of-experts decoders' whole-sequence entry points against
the JAX reference (the reduced configs of ``moe_util``; the reference with
``attn_impl="pallas"``, its kernels in interpret mode): ``logits`` /
``classify`` for every served PEFT method with the summed aux values and
every layer's routing in float32, and the logits in bfloat16, where a
token whose route is a near tie may go another way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_util import (B, METHODS, NAMES, S, TOL, assert_bf16_close, bundles,
                      cfgs, setup, tokens)
from moe_util import one_torch_thread  # noqa: F401 (autouse fixture)
from port_util import np32
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions as JOpts
from repro_torch import bridge
from repro_torch.models.model import Model, ModelOptions


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", NAMES)
def test_logits_and_classify_match_reference(name, method):
    """Logits, their argmax, the summed aux values (``forward_aux``
    against the reference's ``forward``) and every layer's routing, then
    ``classify``."""
    cfg, jmodel, jparams, model, params = setup(name)
    toks = tokens(cfg)
    jb, pb = bundles(cfg, jparams, method, classify=True)
    want, jaux = jax.jit(lambda t: jmodel.logits(jparams, {"tokens": t},
                                                 jb))(jnp.asarray(toks))
    with model.record_routes() as routes:
        got = model.logits(params, torch.from_numpy(toks), pb)
    np.testing.assert_allclose(np32(got), np32(want), **TOL)
    assert torch.equal(got.argmax(-1), torch.from_numpy(
        np.array(jnp.argmax(want, -1))).long())
    assert len(routes) == sum(cfg.moe_layer_mask())
    _, aux = model.forward_aux(params, torch.from_numpy(toks), pb)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    want_c = jax.jit(lambda t: jmodel.classify(jparams, {"tokens": t},
                                               jb)[0])(jnp.asarray(toks))
    got_c = model.classify(params, torch.from_numpy(toks), pb)
    np.testing.assert_allclose(np32(got_c), np32(want_c), **TOL)


NEAR_TIE = 1e-2     # router probabilities this close are a near tie


def reference_routes(monkeypatch):
    """Record the reference's router probabilities (T, E) per MoE call
    (run it unjitted, with no scan or remat, so the values are
    concrete)."""
    from repro.models import model as jmodel_mod
    probs, orig = [], jmodel_mod.moe_mod.apply_moe

    def wrapped(c, p, x, dt):
        logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ \
            p["router"].astype(jnp.float32)
        probs.append(np.asarray(jax.nn.softmax(logits, -1)))
        return orig(c, p, x, dt)
    monkeypatch.setattr(jmodel_mod.moe_mod, "apply_moe", wrapped)
    return probs


def routing_flips(ref_probs, routes, k):
    """Per token, whether its expert set differs between the reference's
    probabilities and the port's recorded routes in any layer, and whether
    each such token is a near tie there (the k-th and (k+1)-th
    probabilities within NEAR_TIE): (flipped (T,) bool, all near ties)."""
    flipped, ties = None, True
    for pr, r in zip(ref_probs, routes):
        want = np.sort(np.argsort(-pr, -1, kind="stable")[:, :k], -1)
        diff = (want != np.sort(r["top_e"].numpy(), -1)).any(-1)
        top = -np.sort(-pr, -1)
        ties &= bool((top[diff, k - 1] - top[diff, k] < NEAR_TIE).all())
        flipped = diff if flipped is None else flipped | diff
    return flipped, ties


@pytest.mark.parametrize("name", NAMES)
def test_logits_bf16_match_reference(name, monkeypatch):
    """bf16 weights and activations on both sides (the bridge keeps the
    router and the q/k norms float32, as the reference's init holds
    them): a token whose expert set differs from the reference's in some
    layer must be a near tie there (bf16 rounding upstream of the router
    moves such routes: llama4's layer 0 has one at 0.3853 / 0.3834), at
    most one token per batch row does, and every other token's logits are
    within 2e-2 of the reference's bf16 forward."""
    cfg, _, jparams, _, _ = setup(name)
    jcfg, _ = cfgs(name)
    toks = tokens(cfg)
    bf = jnp.bfloat16
    probs = reference_routes(monkeypatch)
    jm = JModel(jcfg, JOpts(attn_impl="pallas", compute_dtype=bf,
                            param_dtype=bf, remat=False, scan_layers=False))
    keep32 = ("ln1", "ln2", "final_norm", "q_norm", "k_norm", "router")
    jp16 = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(x) if any(
            getattr(k, "key", None) in keep32 for k in path)
        else jnp.asarray(x, bf), jparams)
    want = jm.logits(jp16, {"tokens": jnp.asarray(toks)})[0]
    model = Model(cfg, ModelOptions(torch.bfloat16, torch.bfloat16),
                  device="cpu")
    params = bridge.params_from_jax(cfg, jparams, device="cpu",
                                    dtype=torch.bfloat16)
    with model.record_routes() as routes:
        got = model.logits(params, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    flipped, ties = routing_flips(probs, routes, cfg.moe.top_k)
    assert ties and flipped.reshape(B, S).sum(1).max() <= 1, flipped
    keep = ~flipped.reshape(B, S)
    assert_bf16_close(np32(got)[keep], np32(want)[keep])
