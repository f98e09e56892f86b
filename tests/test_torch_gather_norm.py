"""The gather-add fused with the block's input RMSNorm, and the norm alone,
by their plain versions on the CPU, against the JAX reference.

With ``norm=(scale, eps)`` each gather-add wrapper returns ``(h_out, x)``:
h_out is the gather-add's sum, x its RMSNorm. The plain pair must be
bitwise the plain gather-add followed by ``layers.apply_norm`` (the
arithmetic the port ran before the fusion); against the reference's
``h + rows_fused(...)`` and ``apply_norm``, h_out is bitwise and x within
2e-5 (float32) or 2e-2 (bfloat16): the reference's XLA reduction sums in
another order. ``ops.rms_norm`` is the same norm with no table. The CUDA
kernel is held to these plain versions on the card by chip_smoke.py; here
its entry points' argument checks are held, and the model's use of the
fused launch (one per layer, no separate ln1 norm).
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_util import (both, jax_tasks, np32, port_lm, port_tables,
                       port_tasks_peft)
from repro.core import aot as jax_aot
from repro.models import layers as JL
from repro_torch.core import peft as port_peft
from repro_torch.kernels import aot_bias, ops
from repro_torch.models import layers as PL

DTYPES = [jnp.float32, jnp.bfloat16]
TOL = {jnp.float32: 2e-5, jnp.bfloat16: 2e-2}
EPS = 1e-6
NORM_CFG = SimpleNamespace(norm_type="rmsnorm", norm_eps=EPS)
WIDTHS = [64, 960]          # tiny_lm's d_model and smollm-360m's
# in-range ids, ids that wrap once, then ids outside [-V, V) (the single
# table gives NaN rows there, the multi-task one clamps)
V = 50
IDS = [5, 0, 49, 17, -1, -50, 50, 77, -51]
TASKS = [0, 2, 1, 0, 3, -1, -9, 2, 1]
NAN_ROWS = [False] * 6 + [True] * 3


def _inputs(rng, d, h_dtype, table_dtype, n_tasks=3):
    hj, ht = both(rng.normal(size=(len(IDS), d)), h_dtype)
    tj, tt = both(rng.normal(size=(n_tasks, V, d)) * 0.1, table_dtype)
    sj, st = both(1 + 0.1 * rng.normal(size=d), jnp.float32)
    kj, kt = both(np.asarray(TASKS, np.int32))
    ij, it = both(np.asarray(IDS, np.int32))
    return (hj, ht), (tj, tt), (sj, st), (kj, kt), (ij, it)


def _norm_as_before(x, scale):
    """The port's ln1 before the fusion, written out: float32 statistics,
    ``x * rsqrt(mean(x^2) + eps) * scale``, back in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + EPS) * scale).to(x.dtype)


def _assert_bitwise(a, b):
    np.testing.assert_array_equal(np32(a), np32(b))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("h_dtype", DTYPES)
@pytest.mark.parametrize("table_dtype", DTYPES)
def test_multitask_norm_plain_is_gather_add_then_apply_norm(rng, d, h_dtype,
                                                           table_dtype):
    (hj, ht), (tj, tt), (sj, st), (kj, kt), (ij, it) = _inputs(
        rng, d, h_dtype, table_dtype)
    h_out, x = ops.aot_gather_add_multitask(ht, tt, kt, it, norm=(st, EPS))
    assert h_out.dtype == x.dtype == ht.dtype
    assert h_out.shape == x.shape == ht.shape
    before = ops.aot_gather_add_multitask(ht, tt, kt, it)
    _assert_bitwise(h_out, before)
    _assert_bitwise(x, PL.apply_norm(NORM_CFG, {"scale": st}, before))
    _assert_bitwise(x, _norm_as_before(before, st))
    # the reference: its gather bitwise, its norm within the tolerance
    ref = hj + jax_aot.rows_fused_multitask(tj, kj, ij[:, None],
                                            h_dtype)[:, 0]
    _assert_bitwise(h_out, ref)
    tol = TOL[h_dtype]
    np.testing.assert_allclose(
        np32(x), np32(JL.apply_norm(NORM_CFG, {"scale": sj}, ref)),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("h_dtype", DTYPES)
@pytest.mark.parametrize("table_dtype", DTYPES)
def test_single_table_norm_plain_is_gather_add_then_apply_norm(
        rng, d, h_dtype, table_dtype):
    """Ids outside [-V, V) give NaN rows in h_out, and so in x."""
    (hj, ht), (tj, tt), (sj, st), _, (ij, it) = _inputs(rng, d, h_dtype,
                                                        table_dtype)
    table_j, table_t = tj[1], tt[1]
    h_out, x = ops.aot_gather_add(ht, table_t, it, norm=(st, EPS))
    before = ops.aot_gather_add(ht, table_t, it)
    _assert_bitwise(h_out, before)
    _assert_bitwise(x, PL.apply_norm(NORM_CFG, {"scale": st}, before))
    _assert_bitwise(x, _norm_as_before(before, st))
    ref = hj + jax_aot.rows_fused({"table": table_j}, ij, h_dtype)
    _assert_bitwise(h_out, ref)
    assert np.isnan(np32(x)).all(axis=1).tolist() == NAN_ROWS
    assert not np.isnan(np32(x)[:6]).any()
    tol = TOL[h_dtype]
    np.testing.assert_allclose(
        np32(x), np32(JL.apply_norm(NORM_CFG, {"scale": sj}, ref)),
        atol=tol, rtol=tol)
    # (b, s, d) in, (b, s, d) out
    h3, x3 = ops.aot_gather_add(ht[None], table_t, it[None], norm=(st, EPS))
    _assert_bitwise(h3[0], h_out)
    _assert_bitwise(x3[0], x)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_plain_is_apply_norm(rng, d, dtype):
    """The norm alone (no table) on h of shape (T, d) and (b, s, d)."""
    hj, ht = both(rng.normal(size=(2, 7, d)) * 3, dtype)
    sj, st = both(1 + 0.1 * rng.normal(size=d), jnp.float32)
    x = ops.rms_norm(ht, st, EPS)
    assert x.dtype == ht.dtype and x.shape == ht.shape
    _assert_bitwise(x, PL.apply_norm(NORM_CFG, {"scale": st}, ht))
    _assert_bitwise(x, _norm_as_before(ht, st))
    _assert_bitwise(ops.rms_norm(ht.reshape(14, d), st, EPS).view(2, 7, d),
                    x)
    tol = TOL[dtype]
    np.testing.assert_allclose(
        np32(x), np32(JL.apply_norm(NORM_CFG, {"scale": sj}, hj)),
        atol=tol, rtol=tol)


def test_same_rows_give_the_same_pair_in_both_gather_modes(rng):
    """One task's table through the single-table wrapper and the stacked
    tables through the multi-task one, on the same in-range rows."""
    (_, ht), (_, tt), (_, st), _, _ = _inputs(rng, 64, jnp.bfloat16,
                                              jnp.bfloat16)
    ids = torch.as_tensor(rng.integers(0, V, len(IDS)), dtype=torch.int32)
    single = ops.aot_gather_add(ht, tt[2], ids, norm=(st, EPS))
    multi = ops.aot_gather_add_multitask(
        ht, tt, torch.full_like(ids, 2), ids, norm=(st, EPS))
    for a, b in zip(single, multi):
        _assert_bitwise(a, b)


# ---------------------------------------------------------------------------
# what the CUDA entry points refuse before any launch
# ---------------------------------------------------------------------------

def _i32(n):
    return torch.zeros(n, dtype=torch.int32)


def _call(kind, h, scale):
    norm = (scale, EPS)
    if kind == "multitask":
        return aot_bias.aot_gather_add_multitask_kernel(
            h, torch.zeros(2, 4, 8), _i32(h.shape[0]), _i32(h.shape[0]),
            norm=norm)
    if kind == "single":
        return aot_bias.aot_gather_add_kernel(h, torch.zeros(4, 8),
                                              _i32(h.shape[0]), norm=norm)
    return aot_bias.rms_norm_kernel(h, scale, EPS)


_H, _SCALE = torch.zeros(3, 8), torch.zeros(8)
NORM_BAD = {
    "cpu": ((_H, _SCALE), ValueError, "CUDA tensors"),
    "scale_shape": ((_H, torch.zeros(6)), ValueError, r"scale \(6,\)"),
    "scale_2d": ((_H, torch.zeros(1, 8)), ValueError, "scale"),
    "scale_dtype": ((_H, _SCALE.bfloat16()), TypeError, "float32 scale"),
    "strided_scale": ((_H, torch.zeros(16)[::2]), ValueError,
                      "scale must be contiguous"),
    "strided_h": ((torch.zeros(8, 3).T, _SCALE), ValueError,
                  "h must be contiguous"),
    "half_h": ((_H.half(), _SCALE), TypeError, "float32 or bfloat16"),
}


@pytest.mark.parametrize("kind", ["multitask", "single", "rms_norm"])
@pytest.mark.parametrize("case", sorted(NORM_BAD))
def test_norm_kernels_refuse_bad_arguments(kind, case):
    (h, scale), err, match = NORM_BAD[case]
    with pytest.raises(err, match=match):
        _call(kind, h, scale)


def test_rms_norm_kernel_refuses_a_3d_h():
    with pytest.raises(ValueError, match="shapes disagree"):
        aot_bias.rms_norm_kernel(torch.zeros(1, 3, 8), _SCALE, EPS)


# ---------------------------------------------------------------------------
# the model: one launch per layer for AoT's rows and the input norm
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port(tiny_lm):
    cfg, _, jparams = tiny_lm
    model, params = port_lm(tiny_lm)
    return cfg, model, params, port_tables(jax_tasks(cfg, jparams, 2))


def _counting(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append((name, "norm" in kw))
        return fn(*a, **kw)
    monkeypatch.setattr(module, name, counted)


def _tick(cfg, model, params, peft):
    """One mixed tick of 3 tokens (two decode rows, a dead token) over a
    zeroed pool."""
    pool = {n: torch.zeros(cfg.num_layers, 9, 4, cfg.num_kv_heads,
                           cfg.head_dim) for n in ("k", "v")}
    bt = torch.arange(1, 9, dtype=torch.int32).view(2, 4)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)
    return model.mixed_step(params, i32([[3], [7], [0]]), i32([0, 1, 0]),
                            i32([5, 2, -1]), pool, peft, block_tables=bt,
                            logit_idx=i32([0, 1]))


@pytest.mark.parametrize("method", ["multitask", "single", "none"])
def test_ln1_takes_one_launch_per_layer(port, monkeypatch, method):
    """AoT's rows and the block's input norm come from one fused gather-add
    per layer (the multi-task tick, and one task's tables through prefill);
    without AoT the input norm is ``ops.rms_norm``; ``apply_norm`` is left
    with ln2 and the final norm."""
    cfg, model, params, tables = port
    L = cfg.num_layers
    calls = []
    for name in ("aot_gather_add", "aot_gather_add_multitask", "rms_norm"):
        _counting(monkeypatch, ops, name, calls)
    _counting(monkeypatch, PL, "apply_norm", calls)
    if method == "single":
        opt = port_peft.PEFTOptions(method="aot",
                                    aot=port_peft.AoTOptions(mode="fused"))
        peft = port_peft.make({"aot": {"table": tables["table"][:, 0]
                                       .contiguous()}}, opt)
        toks = torch.tensor([[3, 9, 1, 4]], dtype=torch.int32)
        model.prefill(params, toks, peft, max_len=8)
        want = [("aot_gather_add", True)] * L
    else:
        peft = (port_tasks_peft(tables, torch.tensor([1, 0, 0],
                                                     dtype=torch.int32))
                if method == "multitask" else None)
        _tick(cfg, model, params, peft)
        want = ([("aot_gather_add_multitask", True)] * L
                if method == "multitask" else [("rms_norm", False)] * L)
    fused = [c for c in calls if c[0] != "apply_norm"]
    assert fused == want
    assert calls.count(("apply_norm", False)) == L + 1    # ln2s, final
