"""The port's optimizer (``repro_torch.optim``) against the reference's
``repro.optim``: schedules within 1e-7, global norm and clipping within
1e-6 relative, AdamW's parameters and moments after 1 and 5 updates, with
and without decay (and a decay mask), within 1e-6."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import schedules as jsched
from repro_torch import bridge
from repro_torch.optim import schedules as psched

# the packages export the function ``adamw`` under the module's name
jadamw = importlib.import_module("repro.optim.adamw")
padamw = importlib.import_module("repro_torch.optim.adamw")

SCHEDULES = {
    "constant": lambda m: m.constant(3e-3),
    "warmup": lambda m: m.linear_warmup(5e-3, 7),
    "cosine": lambda m: m.cosine(1e-3, 50),
    "cosine_warmup": lambda m: m.cosine(8e-3, 40, warmup_steps=5,
                                        final_frac=0.2),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match(name):
    j, p = SCHEDULES[name](jsched), SCHEDULES[name](psched)
    for step in (0, 1, 3, 5, 7, 20, 40, 50, 60):
        assert abs(float(j(jnp.asarray(step))) - p(step)) <= 1e-7, step


def _tree(rng, scale=1.0):
    return {"a": rng.normal(size=(5, 3)).astype(np.float32) * scale,
            "b": [rng.normal(size=(4,)).astype(np.float32) * scale,
                  {"c": rng.normal(size=(2, 2, 3)).astype(np.float32)
                   * scale}]}


def _torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_global_norm_and_clip_match(max_norm):
    g = _tree(np.random.default_rng(0))
    jn = float(jadamw.global_norm(jax.tree.map(jnp.asarray, g)))
    pn = float(padamw.global_norm(_torch(g)))
    assert abs(jn - pn) <= 1e-6 * jn
    jc, _ = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    pc, pg = padamw.clip_by_global_norm(_torch(g), max_norm)
    assert abs(float(pg) - jn) <= 1e-6 * jn
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(bridge.to_numpy(pc))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=0)
    assert float(padamw.global_norm({})) == 0.0


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("decay", ["none", "decay", "mask"])
def test_adamw_matches_reference(steps, decay):
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [_tree(rng, 0.3) for _ in range(steps)]
    kw = dict(weight_decay=0.0 if decay == "none" else 0.05)
    if decay == "mask":
        kw["mask"] = {"a": True, "b": [False, {"c": True}]}
    lr = jsched.linear_warmup(1e-2, 3)
    ji, ju = jadamw.adamw(lr, **kw)
    pi, pu = padamw.adamw(psched.linear_warmup(1e-2, 3), **kw)
    jp = jax.tree.map(jnp.asarray, params)
    pp = _torch(params)
    js, ps = ji(jp), pi(pp)
    for g in grads:
        jp, js = ju(jax.tree.map(jnp.asarray, g), js, jp)
        pp, ps = pu(_torch(g), ps, pp)
    assert ps.step == int(js.step) == steps
    for want, got in ((jp, pp), (js.mu, ps.mu), (js.nu, ps.nu)):
        for a, b in zip(jax.tree.leaves(want),
                        jax.tree.leaves(bridge.to_numpy(got))):
            np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-6)


def test_adamw_leaves_its_inputs_as_they_were():
    rng = np.random.default_rng(2)
    pp, g = _torch(_tree(rng)), _torch(_tree(rng))
    keep = jax.tree.map(lambda x: x.clone(), pp)
    init, update = padamw.adamw(1e-2, weight_decay=0.1)
    new, state = update(g, init(pp), pp)
    for a, b, c in zip(jax.tree.leaves(keep), jax.tree.leaves(pp),
                       jax.tree.leaves(new)):
        assert torch.equal(a, b) and not torch.equal(b, c)
        assert not c.requires_grad
