"""The port's serving layers against the JAX reference's, on the same
numpy inputs, within 2e-5 (float32)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_util import both, np32
from repro import configs as jax_configs
from repro.models import layers as JL
from repro_torch import configs
from repro_torch.models import layers as PL

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def cfg():
    return configs.reduced(configs.get("smollm-360m"), repeats=2)


def test_port_configs_equal_reference():
    """The port's stdlib config copies give the reference's values."""
    for reduce in (False, True):
        want = jax_configs.get("smollm-360m")
        mine = configs.get("smollm-360m")
        if reduce:
            want = jax_configs.reduced(want, repeats=2)
            mine = configs.reduced(mine, repeats=2)
        assert dataclasses.asdict(mine) == dataclasses.asdict(want)


def _pair(rng, *shape, scale=1.0):
    return both(rng.normal(size=shape) * scale)


def test_apply_norm(rng, cfg):
    xj, xt = _pair(rng, 3, 5, cfg.d_model, scale=3.0)
    sj, st = _pair(rng, cfg.d_model)
    np.testing.assert_allclose(np32(PL.apply_norm(cfg, {"scale": st}, xt)),
                               np32(JL.apply_norm(cfg, {"scale": sj}, xj)),
                               **TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope(rng, cfg, per_row):
    b, s, h, hd = 3, 6, cfg.num_heads, cfg.head_dim
    np.testing.assert_allclose(np32(PL.rope_freqs(hd, cfg.rope_theta)),
                               np32(JL.rope_freqs(hd, cfg.rope_theta)), **TOL)
    xj, xt = _pair(rng, b, s, h, hd)
    pos = (rng.integers(0, 64, (b, s)) if per_row else np.arange(s) + 17)
    pj, pt = both(pos.astype(np.int32))
    np.testing.assert_allclose(np32(PL.apply_rope(xt, pt, cfg.rope_theta)),
                               np32(JL.apply_rope(xj, pj, cfg.rope_theta)),
                               **TOL)


def test_swiglu_mlp(rng, cfg):
    d, f = cfg.d_model, cfg.d_ff
    xj, xt = _pair(rng, 2, 5, d)
    pj, pt = {}, {}
    for name, shape in (("wg", (d, f)), ("wu", (d, f)), ("wd", (f, d))):
        pj[name], pt[name] = _pair(rng, *shape, scale=d ** -0.5)
    np.testing.assert_allclose(
        np32(PL.apply_mlp(cfg, pt, xt, torch.float32)),
        np32(JL.apply_mlp(cfg, pj, xj, jnp.float32)), **TOL)


def test_attention_projections(rng, cfg):
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pj, pt = {}, {}
    for name, shape in (("wq", (d, h * hd)), ("wk", (d, kvh * hd)),
                        ("wv", (d, kvh * hd)), ("wo", (h * hd, d))):
        pj[name], pt[name] = _pair(rng, *shape, scale=d ** -0.5)
    xj, xt = _pair(rng, 4, 1, d)
    posj, post = both(np.asarray([[3], [0], [9], [31]], np.int32))
    got = PL.attn_project_qkv(cfg, pt, xt, post, torch.float32)
    want = JL.attn_project_qkv(cfg, pj, xj, posj, jnp.float32)
    for g, w, name in zip(got, want, "qkv"):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(np32(g), np32(w), **TOL, err_msg=name)
    oj, ot = _pair(rng, 4, 1, h, hd)
    np.testing.assert_allclose(
        np32(PL.attn_output(cfg, pt, ot, torch.float32)),
        np32(JL.attn_output(cfg, pj, oj, jnp.float32)), **TOL)
