"""The port's kernels, by their plain versions, against the JAX reference.

On the CPU each wrapper runs its kernel's plain PyTorch version; these tests
hold that version to the reference's Pallas kernel (interpret mode, as the
reference's own tests run it) and to its XLA and oracle paths, with the
reference's tolerances (tests/test_kernels.py): exact for the gather-add,
2e-5 (float32) and 2e-2 (bfloat16) for attention. The CUDA kernels are held
to the same plain versions on the card by chip_smoke.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_util import both, np32
from repro.core import aot as jax_aot
from repro.kernels import ref as jax_ref
from repro.kernels.aot_bias import (aot_gather_add_kernel,
                                    aot_gather_add_multitask_kernel)
from repro.kernels.decode_attention import (ragged_paged_attention_kernel,
                                            round_kv_len as jax_round_kv_len)
from repro.models.layers import (ragged_paged_attention_decode as
                                 jax_ragged_decode)
from repro_torch.core import aot as port_aot
from repro_torch.kernels import ops
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels.aot_bias import aot_gather_add_kernel as \
    port_single_kernel
from repro_torch.kernels.aot_bias import aot_gather_add_multitask_kernel as \
    port_gather_kernel
from repro_torch.kernels.decode_attention import (
    ragged_paged_attention_kernel as port_ragged_kernel, round_kv_len)
from repro_torch.models.layers import ragged_paged_attention_decode

from test_ragged_attention import COMPOSITIONS, _tables_for

DTYPES = [jnp.float32, jnp.bfloat16]
# the reference's three attention paths, each compiled once per shape
PALLAS = jax.jit(functools.partial(ragged_paged_attention_kernel,
                                   interpret=True))
ORACLE = jax.jit(jax_ref.ragged_paged_attention_ref)
XLA = jax.jit(jax_ragged_decode)


# ---------------------------------------------------------------------------
# multi-task gather-add (the paper's Eq. 1)
# ---------------------------------------------------------------------------

# in-range pairs first, then out-of-range ones: too large, negative (wraps
# once), too negative (clamps after the wrap)
TASKS = [0, 2, 1, 0, 3, -1, -9, 2]
IDS = [5, 0, 49, 17, 60, -1, -3, -200]


@pytest.mark.parametrize("h_dtype", DTYPES)
@pytest.mark.parametrize("table_dtype", DTYPES)
def test_gather_add_plain_bitwise_matches_reference(rng, h_dtype,
                                                    table_dtype):
    T, n_tasks, V, d = len(IDS), 3, 50, 32
    hj, ht = both(rng.normal(size=(T, d)), h_dtype)
    tj, tt = both(rng.normal(size=(n_tasks, V, d)) * 0.1, table_dtype)
    kj, kt = both(np.asarray(TASKS, np.int32))
    ij, it = both(np.asarray(IDS, np.int32))
    out = ops.aot_gather_add_multitask(ht, tt, kt, it)
    assert out.dtype == ht.dtype and out.shape == (T, d)
    pallas = aot_gather_add_multitask_kernel(hj, tj, kj, ij, interpret=True)
    xla = hj + jax_aot.rows_fused_multitask(tj, kj, ij[:, None], h_dtype)[:, 0]
    np.testing.assert_array_equal(np32(out), np32(pallas))
    np.testing.assert_array_equal(np32(out), np32(xla))
    # the oracle (in-range ids only) and the port's own gather
    n_ok = 4
    oracle = port_ref.aot_gather_add_multitask_ref(ht[:n_ok], tt, kt[:n_ok],
                                                   it[:n_ok])
    np.testing.assert_array_equal(np32(out[:n_ok]), np32(oracle))
    rows = port_aot.rows_fused_multitask(tt, kt, it[:, None], ht.dtype)
    np.testing.assert_array_equal(np32(ht + rows[:, 0]), np32(out))


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


# what the CUDA entry points refuse before any launch; valid arguments on
# the CPU are refused too (the kernel never runs anything on the CPU)
GATHER_BAD = {
    "cpu": ((torch.zeros(2, 8), torch.zeros(1, 4, 8), _i32(2), _i32(2)),
            ValueError, "CUDA tensors"),
    "half": ((torch.zeros(2, 8, dtype=torch.half), torch.zeros(1, 4, 8),
              _i32(2), _i32(2)), TypeError, "float32 or bfloat16"),
    "int64_ids": ((torch.zeros(2, 8), torch.zeros(1, 4, 8), _i32(2),
                   torch.zeros(2, dtype=torch.long)), TypeError, "int32"),
    "width": ((torch.zeros(2, 8), torch.zeros(1, 4, 6), _i32(2), _i32(2)),
              ValueError, "shapes disagree"),
    "strided": ((torch.zeros(8, 2).T, torch.zeros(1, 4, 8), _i32(2),
                 _i32(2)), ValueError, "contiguous"),
}


@pytest.mark.parametrize("case", sorted(GATHER_BAD))
def test_gather_add_kernel_refuses_bad_arguments(case):
    args, err, match = GATHER_BAD[case]
    with pytest.raises(err, match=match):
        port_gather_kernel(*args)


# ---------------------------------------------------------------------------
# single-table gather-add (one task's fused AoT tables)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,V,d", [(16, 50, 32), (7, 13, 8), (64, 100, 128),
                                   (128, 1000, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_single_gather_add_plain_bitwise_matches_pallas_kernel(rng, T, V, d,
                                                               dtype):
    """In-range ids at the reference's own kernel-test shapes, as (T, d)
    and as (1, T, d)."""
    hj, ht = both(rng.normal(size=(T, d)), dtype)
    tj, tt = both(rng.normal(size=(V, d)), dtype)
    ij, it = both(rng.integers(0, V, (T,)).astype(np.int32))
    out = ops.aot_gather_add(ht, tt, it)
    assert out.dtype == ht.dtype and out.shape == (T, d)
    pallas = aot_gather_add_kernel(hj, tj, ij, interpret=True)
    np.testing.assert_array_equal(np32(out), np32(pallas))
    batched = ops.aot_gather_add(ht[None], tt, it[None])
    np.testing.assert_array_equal(np32(batched[0]), np32(out))
    np.testing.assert_array_equal(
        np32(out), np32(port_ref.aot_gather_add_ref(ht, tt, it)))


# jnp.take's rule: in range; -1 and -V wrap once; V, V + 27, -V - 1 and
# -200 are still out of range after the wrap and give NaN rows
TAKE_IDS = [5, 0, 49, -1, -50, 50, 77, -51, -200]
NAN_ROWS = [False] * 5 + [True] * 4


@pytest.mark.parametrize("h_dtype", DTYPES)
@pytest.mark.parametrize("table_dtype", DTYPES)
def test_single_gather_add_plain_follows_rows_fused(rng, h_dtype,
                                                    table_dtype):
    """Out-of-range ids: the plain version equals the reference model's
    ``h + rows_fused(...)`` bitwise, NaN rows in the same places."""
    T, V, d = len(TAKE_IDS), 50, 16
    hj, ht = both(rng.normal(size=(T, d)), h_dtype)
    tj, tt = both(rng.normal(size=(V, d)) * 0.1, table_dtype)
    ij, it = both(np.asarray(TAKE_IDS, np.int32))
    out = ops.aot_gather_add(ht, tt, it)
    assert out.dtype == ht.dtype
    want = hj + jax_aot.rows_fused({"table": tj}, ij, h_dtype)
    np.testing.assert_array_equal(np32(out), np32(want))
    assert np.isnan(np32(out)).all(axis=1).tolist() == NAN_ROWS
    assert not np.isnan(np32(out)).any(axis=1)[:5].any()
    rows = port_aot.rows_fused({"table": tt}, it, ht.dtype)
    np.testing.assert_array_equal(
        np32(rows), np32(jax_aot.rows_fused({"table": tj}, ij, h_dtype)))


SINGLE_BAD = {
    "cpu": ((torch.zeros(2, 8), torch.zeros(4, 8), _i32(2)), ValueError,
            "CUDA tensors"),
    "half": ((torch.zeros(2, 8), torch.zeros(4, 8, dtype=torch.half),
              _i32(2)), TypeError, "float32 or bfloat16"),
    "int64_ids": ((torch.zeros(2, 8), torch.zeros(4, 8),
                   torch.zeros(2, dtype=torch.long)), TypeError, "int32"),
    "stacked_tables": ((torch.zeros(2, 8), torch.zeros(1, 4, 8), _i32(2)),
                       ValueError, r"\(V, d\)"),
    "ids_length": ((torch.zeros(2, 8), torch.zeros(4, 8), _i32(3)),
                   ValueError, "shapes disagree"),
    "strided_table": ((torch.zeros(2, 8), torch.zeros(8, 4).T, _i32(2)),
                      ValueError, "contiguous"),
}


@pytest.mark.parametrize("case", sorted(SINGLE_BAD))
def test_single_gather_add_kernel_refuses_bad_arguments(case):
    args, err, match = SINGLE_BAD[case]
    with pytest.raises(err, match=match):
        port_single_kernel(*args)


# ---------------------------------------------------------------------------
# ragged paged attention
# ---------------------------------------------------------------------------

def _ragged_inputs(rng, comp_rows, comp_pos, dtype, ns, h, kvh, hd, bs, nb):
    T = len(comp_rows)
    q = both(rng.normal(size=(T, h, hd)), dtype)
    kp = both(rng.normal(size=(nb, bs, kvh, hd)), dtype)
    vp = both(rng.normal(size=(nb, bs, kvh, hd)), dtype)
    depths = np.zeros(ns, np.int64)
    for r, p in zip(comp_rows, comp_pos):
        depths[r] = max(depths[r], p + 1)
    bt = np.asarray(_tables_for(rng, ns, bs, nb, depths))
    idx = [both(np.asarray(a, np.int32))
           for a in (bt, comp_rows, comp_pos)]
    return q, kp, vp, idx


CASES = {name: (rows, pos, dict(ns=4, h=4, kvh=2, hd=16, bs=8, nb=40))
         for name, (rows, pos) in COMPOSITIONS.items()}
# smollm's grouping: 15 query heads over 5 KV heads (g = 3), hd 64, bs 16
CASES["smollm_g3_hd64"] = ([0, 1, 1, 1, 2, 0], [40, 14, 15, 16, 3, -1],
                           dict(ns=3, h=15, kvh=5, hd=64, bs=16, nb=12))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_attention_plain_matches_reference(rng, case, dtype):
    rows, pos, shape = CASES[case]
    (qj, qt), (kj, kt), (vj, vt), idx = _ragged_inputs(rng, rows, pos, dtype,
                                                      **shape)
    (btj, btt), (rj, rt), (pj, pt) = idx
    out = ops.ragged_paged_attention(qt, kt, vt, btt, rt, pt)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    f32 = lambda x: x.astype(jnp.float32)
    oracle = ORACLE(f32(qj), f32(kj), f32(vj), btj, rj, pj)
    pallas = PALLAS(qj, kj, vj, btj, rj, pj)
    tol = 2e-5 if dtype == jnp.float32 else 2e-2
    for want, what in ((oracle, "oracle"), (pallas, "Pallas kernel")):
        np.testing.assert_allclose(np32(out), np32(want), atol=tol, rtol=tol,
                                   err_msg=f"{case}: plain vs {what}")
    dead = np.asarray(pos) < 0
    assert np.all(np32(out)[dead] == 0), "dead tokens must give zeros"
    # the port's oracle, and the reference's XLA path in its layout
    f32t = lambda x: x.float()
    np.testing.assert_allclose(
        np32(port_ref.ragged_paged_attention_ref(f32t(qt), f32t(kt), f32t(vt),
                                                 btt, rt, pt)),
        np32(oracle), atol=2e-5, rtol=2e-5)
    if dtype == jnp.float32:
        xla = XLA(qj[:, None], kj, vj, btj, rj, pj)
        mine = ragged_paged_attention_decode(qt[:, None], kt, vt, btt, rt, pt)
        np.testing.assert_allclose(np32(mine), np32(xla), atol=2e-5,
                                   rtol=2e-5)


_Q, _PAGES = torch.zeros(1, 2, 8), torch.zeros(3, 4, 1, 8)
RAGGED_BAD = {
    "cpu": ((_Q, _PAGES, _PAGES, _i32(1, 2), _i32(1), _i32(1)),
            ValueError, "CUDA tensors"),
    "mixed_types": ((_Q, _PAGES.bfloat16(), _PAGES, _i32(1, 2), _i32(1),
                     _i32(1)), TypeError, "must match"),
    "head_dim": ((torch.zeros(1, 2, 6), _PAGES, _PAGES, _i32(1, 2), _i32(1),
                  _i32(1)), ValueError, "disagree"),
    "hd_over_128": ((torch.zeros(1, 1, 136), torch.zeros(3, 4, 1, 136),
                     torch.zeros(3, 4, 1, 136), _i32(1, 2), _i32(1),
                     _i32(1)), ValueError, "unsupported"),
    "heads_not_grouped": ((torch.zeros(1, 3, 8), torch.zeros(3, 4, 2, 8),
                           torch.zeros(3, 4, 2, 8), _i32(1, 2), _i32(1),
                           _i32(1)), ValueError, "unsupported"),
    "pos_length": ((_Q, _PAGES, _PAGES, _i32(1, 2), _i32(1), _i32(2)),
                   ValueError, r"\(T,\)"),
    "group_over_8": ((torch.zeros(1, 9, 8), _PAGES, _PAGES, _i32(1, 2),
                      _i32(1), _i32(1)), ValueError, "unsupported"),
}


@pytest.mark.parametrize("case", sorted(RAGGED_BAD))
def test_ragged_kernel_refuses_bad_arguments(case):
    args, err, match = RAGGED_BAD[case]
    with pytest.raises(err, match=match):
        port_ragged_kernel(*args)


@pytest.mark.parametrize("n,block_k", [(1, 256), (256, 256), (257, 256),
                                       (1000, 256), (48, 16), (50, 16)])
def test_round_kv_len_matches_reference(n, block_k):
    assert round_kv_len(n, block_k) == jax_round_kv_len(n, block_k)


# positional arguments of each wrapper, which the stubbed kernels ignore
# (the single-table gather-add reads h's rank first)
WRAPPER_ARGS = {"aot_gather_add": (torch.zeros(3, 2), None, None),
                "aot_gather_add_multitask": (None,) * 4,
                "ragged_paged_attention": (None,) * 6,
                "flash_attention": (None,) * 3,
                "decode_attention": (None,) * 4,
                "paged_decode_attention": (None,) * 5}


@pytest.mark.parametrize("name", sorted(WRAPPER_ARGS))
def test_wrapper_counts_only_calls_that_launch(monkeypatch, name):
    """A kernel function returns an empty output without launching; its
    wrapper then counts nothing. Every other call on the card counts one."""
    wrapper = getattr(ops, name)
    monkeypatch.setattr(ops, "_on_cpu", lambda *xs: False)
    ops.reset_launches()
    try:
        for rows in (0, 3, 0):
            monkeypatch.setattr(
                ops, f"{name}_kernel",
                lambda *a, rows=rows, **kw: torch.zeros(rows, 2))
            wrapper(*WRAPPER_ARGS[name])
        assert wrapper.launches == 1
    finally:
        ops.reset_launches()
