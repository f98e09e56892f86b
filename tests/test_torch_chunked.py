"""The port's blockwise ``attention_chunked`` (``kernels/flash_attention.py``,
re-exported by ``models/layers.py``) against
the reference's, and the kernel path's route for a bidirectional prefix.

Every mask of the reference's own chunked test (``tests/test_attention.py``
``MASKS``) but softcap, which the port does not port, plus queries from an
offset over a prefix that covers them (P-Tuning v2 on paligemma), at chunk
sizes that take both regimes: one masked block (a kv range of at most two
chunks) and the online-softmax scan. Float32 within 2e-5 of the
reference's ``attention_chunked`` and of the port's ``attention_ref``;
bfloat16 within 2e-2 of the reference's bf16. Gradients (q, k, v) against
``torch.autograd`` of ``attention_ref`` within 2e-5 x max(1, |g|), each
scan step under ``torch.utils.checkpoint``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_util import both, np32
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as PF
from repro_torch.kernels import ops
from repro_torch.models import layers as PL

TOL = {jnp.float32: dict(atol=2e-5, rtol=2e-5),
       jnp.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# tests/test_attention.py's MASKS less softcap, then an offset under a
# prefix (queries at 5.., a prefix of 12 over 5 + 64 keys)
MASKS = [dict(causal=True), dict(causal=False), dict(causal=True, window=17),
         dict(causal=True, prefix_len=10), dict(causal=False, window=9),
         dict(causal=True, window=5, prefix_len=3),
         dict(causal=True, prefix_len=12, q_offset=5)]
# (chunk_q, chunk_kv): the reference test's three; (16, 8) scans in every
# mask (a q chunk's kv range past two chunks), (64, 64) is one block
CHUNKS = [(16, 8), (64, 64), (7, 5)]


def _inputs(seed, kw, dtype=jnp.float32, b=2, sq=64, h=4, kvh=2, hd=16):
    rng = np.random.default_rng(seed)
    skv = sq + kw.get("q_offset", 0)
    return (both(rng.normal(size=(b, sq, h, hd)), dtype),
            both(rng.normal(size=(b, skv, kvh, hd)), dtype),
            both(rng.normal(size=(b, skv, kvh, hd)), dtype))


def _jax_chunked(q, k, v, **kw):
    """The reference's ``attention_chunked``, jitted per static keyword set
    (one compile instead of its loop's eager dispatches)."""
    return _jitted(tuple(sorted(kw.items())))(q, k, v)


@functools.lru_cache(maxsize=None)
def _jitted(kw):
    return jax.jit(functools.partial(JL.attention_chunked, **dict(kw)))


@pytest.fixture
def scans(monkeypatch):
    """Counts ``_online_chunk_scan`` calls (the second regime)."""
    calls = []
    real = PF._online_chunk_scan

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(PF, "_online_chunk_scan", counted)
    return calls


@pytest.mark.parametrize("kw", MASKS, ids=[str(m) for m in MASKS])
def test_chunked_matches_reference(kw, scans):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(0, kw)
    oracle = PL.attention_ref(qt, kt, vt, **kw)
    np.testing.assert_allclose(np32(oracle), np32(JL.attention_ref(
        qj, kj, vj, **kw)), **TOL[jnp.float32])
    regimes = []
    for cq, ck in CHUNKS:
        before = len(scans)
        got = PL.attention_chunked(qt, kt, vt, chunk_q=cq, chunk_kv=ck, **kw)
        want = _jax_chunked(qj, kj, vj, chunk_q=cq, chunk_kv=ck, **kw)
        assert got.shape == qt.shape and got.dtype == qt.dtype
        np.testing.assert_allclose(np32(got), np32(want), **TOL[jnp.float32],
                                   err_msg=f"chunks {cq}, {ck}")
        np.testing.assert_allclose(np32(got), np32(oracle),
                                   **TOL[jnp.float32])
        regimes.append(len(scans) > before)
    assert regimes[:2] == [True, False]


@pytest.mark.parametrize("kw", [MASKS[3], MASKS[5], MASKS[6]],
                         ids=["prefix", "window_prefix", "offset_prefix"])
def test_chunked_bf16_matches_reference(kw):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(1, kw, jnp.bfloat16)
    for cq, ck in ((16, 8), (64, 64)):
        got = PL.attention_chunked(qt, kt, vt, chunk_q=cq, chunk_kv=ck, **kw)
        want = _jax_chunked(qj, kj, vj, chunk_q=cq, chunk_kv=ck, **kw)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(np32(got), np32(want),
                                   **TOL[jnp.bfloat16])


@pytest.mark.parametrize("kw", MASKS, ids=[str(m) for m in MASKS])
def test_chunked_gradients_match_attention_ref(kw, monkeypatch):
    """d/d(q, k, v) of a fixed projection of the output, through the scan
    with every step checkpointed, against autograd of ``attention_ref``."""
    remat = []
    real = PF.checkpoint
    monkeypatch.setattr(PF, "checkpoint",
                        lambda *a, **k: remat.append(1) or real(*a, **k))
    (_, q), (_, k), (_, v) = _inputs(2, kw)
    w = torch.from_numpy(np.random.default_rng(3).normal(
        size=q.shape).astype(np.float32))

    def grads(fn):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        (fn(*xs, **kw) * w).sum().backward()
        return [x.grad for x in xs]

    want = grads(PL.attention_ref)
    got = grads(lambda *a, **k: PL.attention_chunked(*a, chunk_q=16,
                                                     chunk_kv=8, **k))
    assert remat, "the scan's steps ran without checkpointing"
    for g, gw, name in zip(got, want, "qkv"):
        scale = max(1.0, float(gw.abs().max()))
        np.testing.assert_allclose(g.numpy(), gw.numpy(), atol=2e-5 * scale,
                                   rtol=0, err_msg=name)


def test_no_grad_runs_no_checkpoint(monkeypatch):
    monkeypatch.setattr(PF, "checkpoint", lambda *a, **k: pytest.fail(
        "checkpoint outside autograd"))
    (_, q), (_, k), (_, v) = _inputs(4, MASKS[3])
    PL.attention_chunked(q, k, v, causal=True, prefix_len=10, chunk_q=16,
                         chunk_kv=8)


def test_flash_wrapper_sends_prefix_len_to_chunked():
    """``ops.flash_attention`` with ``prefix_len`` is ``attention_chunked``
    at the reference's default chunks (its wrapper's XLA route), counted by
    ``ops.chunked_calls`` and never as a launch; ``reset_launches`` zeroes
    the count."""
    kw = dict(causal=True, prefix_len=12, q_offset=5)
    (_, q), (_, k), (_, v) = _inputs(5, kw)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)
    assert torch.equal(got, PL.attention_chunked(q, k, v, **kw))
    assert ops.chunked_calls() == 1
    assert set(ops.launches().values()) == {0}
    ops.reset_launches()
    assert ops.chunked_calls() == 0
