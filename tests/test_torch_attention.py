"""The port's prefill and decode attention, by their plain versions, against
the JAX reference.

On the CPU each wrapper in ``kernels.ops`` runs its kernel's plain PyTorch
version; these tests hold that version to the reference's Pallas kernel in
interpret mode (as the reference's own tests run it), within 2e-5 in
float32 and 2e-2 in bfloat16 (``tests/test_kernels.py``): flash attention
(causal, full and sliding window; sq equal to skv or not; GQA; queries
from an offset, against the reference's XLA path, which takes that) and the
contiguous and paged decode kernels (scalar and per-row lengths, lengths
of 0, lengths that straddle pages; paged also at paligemma-3b's hd 256,
g 8). The port's oracles and its XLA-path
layers are held to the reference's. The CUDA kernels are held to the same
plain versions on the card by chip_smoke.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_util import both, np32
from repro.kernels import ref as jax_ref
from repro.kernels.decode_attention import (decode_attention_kernel,
                                            paged_decode_attention_kernel)
from repro.kernels.flash_attention import flash_attention_kernel
from repro.models import layers as jax_layers
from repro_torch.kernels import ops
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels.decode_attention import (
    decode_attention_kernel as port_decode_kernel,
    paged_decode_attention_kernel as port_paged_kernel,
    ragged_paged_attention_kernel as port_ragged_kernel)
from repro_torch.kernels.flash_attention import \
    flash_attention_kernel as port_flash_kernel
from repro_torch.models import layers as port_layers

DTYPES = [jnp.float32, jnp.bfloat16]
TOL = {jnp.float32: 2e-5, jnp.bfloat16: 2e-2}


def _close(got, want, dtype, what):
    tol = TOL[dtype]
    np.testing.assert_allclose(np32(got), np32(want), atol=tol, rtol=tol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# flash attention (prefill)
# ---------------------------------------------------------------------------

# name -> (b, sq, skv, h, kvh, hd, causal, window); small tiles (8) so the
# Pallas kernel walks several of them and pads the ragged ends
FLASH = {
    "causal": (2, 13, 13, 4, 2, 16, True, 0),
    "full_sq_lt_skv": (1, 9, 21, 4, 2, 16, False, 0),
    "window": (2, 19, 19, 4, 2, 16, True, 5),
    "causal_sq_lt_skv": (1, 7, 20, 4, 1, 16, True, 0),
    "causal_sq_gt_skv": (1, 20, 7, 4, 4, 16, True, 0),
    "smollm_g3_hd64": (1, 11, 11, 15, 5, 64, True, 0),
}


@functools.lru_cache(maxsize=None)
def _pallas_flash(causal, window):
    return jax.jit(functools.partial(flash_attention_kernel, causal=causal,
                                     window=window, block_q=8, block_k=8,
                                     interpret=True))


def _flash_inputs(rng, b, sq, skv, h, kvh, hd, dtype):
    return [both(rng.normal(size=shape), dtype)
            for shape in ((b, sq, h, hd), (b, skv, kvh, hd),
                          (b, skv, kvh, hd))]


@pytest.mark.parametrize("case", sorted(FLASH))
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_plain_matches_pallas_kernel(rng, case, dtype):
    b, sq, skv, h, kvh, hd, causal, window = FLASH[case]
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(rng, b, sq, skv, h, kvh, hd,
                                                 dtype)
    out = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    pallas = _pallas_flash(causal, window)(qj, kj, vj)
    _close(out, pallas, dtype, f"{case}: plain vs Pallas kernel")
    f32 = lambda x: x.astype(jnp.float32)
    oracle = jax_ref.flash_attention_ref(f32(qj), f32(kj), f32(vj),
                                         causal=causal, window=window)
    _close(out, oracle, dtype, f"{case}: plain vs oracle")
    # the port's oracle follows the reference's op for op
    mine = port_ref.flash_attention_ref(qt.float(), kt.float(), vt.float(),
                                        causal=causal, window=window)
    np.testing.assert_allclose(np32(mine), np32(oracle), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("case", ["causal", "window", "full_sq_lt_skv"])
def test_attention_ref_matches_reference_layer(rng, case):
    b, sq, skv, h, kvh, hd, causal, window = FLASH[case]
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(rng, b, sq, skv, h, kvh, hd,
                                                 jnp.float32)
    want = jax_layers.attention_ref(qj, kj, vj, causal=causal, window=window)
    got = port_layers.attention_ref(qt, kt, vt, causal=causal, window=window)
    np.testing.assert_allclose(np32(got), np32(want), atol=2e-5, rtol=2e-5)


def test_flash_wrapper_refuses_what_the_reference_sends_to_xla(rng):
    """The kernel takes neither softcap nor prefix_len, which go to XLA in
    the reference: the port sends both, as the reference, to the plain
    ``layers.attention_chunked`` (no launch; counted by
    ``ops.chunked_calls``); q_offset (P-Tuning v2's prefill) is ported."""
    (_, qt), (_, kt), (_, vt) = _flash_inputs(rng, 1, 4, 4, 2, 1, 8,
                                              jnp.float32)
    ops.reset_launches()
    out = ops.flash_attention(qt, kt, vt, causal=True, prefix_len=2)
    assert torch.equal(out, port_layers.attention_chunked(
        qt, kt, vt, causal=True, prefix_len=2))
    out = ops.flash_attention(qt, kt, vt, causal=True, softcap=30.0)
    assert torch.equal(out, port_layers.attention_chunked(
        qt, kt, vt, causal=True, softcap=30.0))
    assert ops.chunked_calls() == 2


# name -> (b, sq, q_offset, h, kvh, hd, window): queries at positions
# q_offset.. over skv = q_offset + sq keys, P-Tuning v2's prefill (its
# prefix before the prompt's keys)
FLASH_OFFSET = {
    "prefix4": (2, 9, 4, 4, 2, 16, 0),
    "prefix5_window6": (1, 13, 5, 4, 2, 16, 6),
    "prefix20_smollm_g3_hd64": (1, 11, 20, 15, 5, 64, 0),
}


@pytest.mark.parametrize("case", sorted(FLASH_OFFSET))
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_plain_with_q_offset_matches_reference(rng, case, dtype):
    """The reference sends q_offset to its XLA paths (``kernels.ops``):
    the plain version against ``attention_chunked`` (small chunks, so the
    kv walk and its bounds are exercised) and ``attention_ref``."""
    b, sq, off, h, kvh, hd, window = FLASH_OFFSET[case]
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(rng, b, sq, sq + off, h,
                                                 kvh, hd, dtype)
    out = ops.flash_attention(qt, kt, vt, causal=True, window=window,
                              q_offset=off)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    f32 = lambda x: x.astype(jnp.float32)
    kw = dict(causal=True, window=window, q_offset=off)
    chunked = jax_layers.attention_chunked(f32(qj), f32(kj), f32(vj),
                                           chunk_q=4, chunk_kv=4, **kw)
    oracle = jax_layers.attention_ref(f32(qj), f32(kj), f32(vj), **kw)
    _close(out, chunked, dtype, f"{case}: plain vs attention_chunked")
    _close(out, oracle, dtype, f"{case}: plain vs attention_ref")
    mine = port_layers.attention_ref(qt.float(), kt.float(), vt.float(),
                                     **kw)
    np.testing.assert_allclose(np32(mine), np32(oracle), atol=2e-5,
                               rtol=2e-5)


# ---------------------------------------------------------------------------
# contiguous and paged decode
# ---------------------------------------------------------------------------

# name -> (h, kvh, hd, S, cur_len: an int or one per row)
DECODE = {
    "scalar": (4, 2, 16, 20, 13),
    "per_row_with_zero": (4, 2, 16, 20, [0, 1, 20, 9]),
    "smollm_g3_hd64": (15, 5, 64, 24, [24, 0, 17]),
}


@functools.lru_cache(maxsize=None)
def _pallas_decode():
    return jax.jit(functools.partial(decode_attention_kernel, block_k=8,
                                     interpret=True))


@pytest.mark.parametrize("case", sorted(DECODE))
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_plain_matches_pallas_kernel(rng, case, dtype):
    h, kvh, hd, S, cur = DECODE[case]
    b = 4 if isinstance(cur, int) else len(cur)
    (qj, qt), (kj, kt), (vj, vt) = [
        both(rng.normal(size=shape), dtype)
        for shape in ((b, h, hd), (b, S, kvh, hd), (b, S, kvh, hd))]
    lens = np.asarray(cur, np.int32)
    out = ops.decode_attention(qt, kt, vt, cur if isinstance(cur, int)
                               else torch.from_numpy(lens))
    assert out.dtype == qt.dtype and out.shape == qt.shape
    pallas = _pallas_decode()(qj, kj, vj, jnp.asarray(lens))
    _close(out, pallas, dtype, f"{case}: plain vs Pallas kernel")
    empty = np.broadcast_to(lens, (b,)) <= 0
    assert np.all(np32(out)[empty] == 0), "cur_len 0 must give zeros"
    if np.any(~empty):          # the oracle, where a row sees something
        f32 = lambda x: x.astype(jnp.float32)
        oracle = jax_ref.decode_attention_ref(f32(qj), f32(kj), f32(vj),
                                              jnp.asarray(lens))
        _close(np32(out)[~empty], np32(oracle)[~empty], dtype,
               f"{case}: plain vs oracle")


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("cur", [13, [3, 20, 1, 9]])
def test_attention_decode_matches_reference_layer(rng, window, cur):
    b, h, kvh, hd, S = 4, 4, 2, 16, 20
    (qj, qt), (kj, kt), (vj, vt) = [
        both(rng.normal(size=shape))
        for shape in ((b, 1, h, hd), (b, S, kvh, hd), (b, S, kvh, hd))]
    lens = np.asarray(cur, np.int32)
    want = jax_layers.attention_decode(qj, kj, vj, jnp.asarray(lens),
                                       window=window)
    got = port_layers.attention_decode(qt, kt, vt, torch.from_numpy(lens),
                                       window=window)
    np.testing.assert_allclose(np32(got), np32(want), atol=2e-5, rtol=2e-5)


# scrambled pages: row 0 empty, row 1 straddles a page edge, row 2 deep
PAGED = {"h": 4, "kvh": 2, "hd": 16, "bs": 4, "nb": 24,
         "cur_len": [0, 6, 17, 20]}
# paligemma-3b's MQA (h 8, kvh 1, hd 256: g 8), the paged walk's widest
PALI_PAGED = {"h": 8, "kvh": 1, "hd": 256, "bs": 4, "nb": 24,
              "cur_len": [0, 6, 17, 20]}


def _paged_inputs(rng, dtype, h, kvh, hd, bs, nb, cur_len):
    b, npages = len(cur_len), 5
    q = both(rng.normal(size=(b, h, hd)), dtype)
    kp = both(rng.normal(size=(nb, bs, kvh, hd)), dtype)
    vp = both(rng.normal(size=(nb, bs, kvh, hd)), dtype)
    bt = rng.permutation(np.arange(1, nb))[:b * npages].reshape(b, npages)
    return q, kp, vp, both(bt.astype(np.int32)), both(
        np.asarray(cur_len, np.int32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_plain_matches_pallas_kernel(rng, dtype):
    _paged_against_reference(rng, dtype, PAGED)


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_plain_at_paligemma_heads_matches_pallas_kernel(
        rng, dtype):
    """The paged walk at its widest (hd 256, g 8: paligemma-3b's paged
    decode), small pages spanned by every length but 0."""
    _paged_against_reference(rng, dtype, PALI_PAGED)


def _paged_against_reference(rng, dtype, shapes):
    """The plain paged decode (through ``ops`` on the CPU) against the
    Pallas kernel in interpret mode and its oracle, the port's oracle
    against the reference's, and the XLA-path layers."""
    (qj, qt), (kj, kt), (vj, vt), (btj, btt), (lj, lt) = _paged_inputs(
        rng, dtype, **shapes)
    out = ops.paged_decode_attention(qt, kt, vt, btt, lt)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    pallas = paged_decode_attention_kernel(qj, kj, vj, btj, lj,
                                           interpret=True)
    _close(out, pallas, dtype, "plain vs Pallas kernel")
    assert np.all(np32(out)[0] == 0), "cur_len 0 must give zeros"
    f32 = lambda x: x.astype(jnp.float32)
    oracle = jax_ref.paged_decode_attention_ref(f32(qj), f32(kj), f32(vj),
                                                btj, lj)
    _close(np32(out)[1:], np32(oracle)[1:], dtype, "plain vs oracle")
    mine = port_ref.paged_decode_attention_ref(qt.float(), kt.float(),
                                               vt.float(), btt, lt)
    np.testing.assert_allclose(np32(mine), np32(oracle), atol=2e-5,
                               rtol=2e-5)
    xla = jax_layers.paged_attention_decode(qj[:, None], kj, vj, btj, lj)
    layer = port_layers.paged_attention_decode(qt[:, None], kt, vt, btt, lt)
    np.testing.assert_allclose(np32(layer), np32(xla), atol=TOL[dtype],
                               rtol=TOL[dtype])


# ---------------------------------------------------------------------------
# what the CUDA entry points refuse before any launch (valid arguments on
# the CPU are refused too: a kernel never runs anything on the CPU)
# ---------------------------------------------------------------------------

def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


_Q4, _K4 = torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 1, 8)
_Q3, _C4 = torch.zeros(2, 2, 8), torch.zeros(2, 5, 1, 8)
BAD = {
    "flash_cpu": (port_flash_kernel, (_Q4, _K4, _K4), ValueError,
                  "CUDA tensors"),
    "flash_mixed_types": (port_flash_kernel, (_Q4, _K4.bfloat16(), _K4),
                          TypeError, "must match"),
    "flash_heads": (port_flash_kernel, (torch.zeros(1, 4, 3, 8),
                                        torch.zeros(1, 4, 2, 8),
                                        torch.zeros(1, 4, 2, 8)),
                    ValueError, "unsupported"),
    "flash_negative_q_offset": (functools.partial(port_flash_kernel,
                                                  q_offset=-1),
                                (_Q4, _K4, _K4), ValueError, ">= 0"),
    "flash_channel_stride": (port_flash_kernel,
                             (torch.zeros(1, 4, 8, 2).transpose(2, 3), _K4,
                              _K4), ValueError, "channel stride"),
    "decode_cpu": (port_decode_kernel, (_Q3, _C4, _C4, 3), ValueError,
                   "CUDA tensors"),
    "decode_half": (port_decode_kernel, (_Q3.half(), _C4, _C4, 3), TypeError,
                    "float32 or bfloat16"),
    "decode_group_over_8": (port_decode_kernel,
                            (torch.zeros(2, 17, 8), _C4, _C4, 3), ValueError,
                            "unsupported"),
    "decode_hd_over_256": (port_decode_kernel,
                           (torch.zeros(2, 2, 264), torch.zeros(2, 5, 1, 264),
                            torch.zeros(2, 5, 1, 264), 3), ValueError,
                           "unsupported"),
    "paged_group_over_8": (port_paged_kernel,
                           (torch.zeros(2, 9, 8), _C4, _C4, _i32(2, 3),
                            _i32(2)), ValueError, "unsupported"),
    "paged_hd_over_256": (port_paged_kernel,
                          (torch.zeros(2, 1, 264), torch.zeros(2, 5, 1, 264),
                           torch.zeros(2, 5, 1, 264), _i32(2, 3), _i32(2)),
                          ValueError, "unsupported"),
    # hd 256 at g 8 passes every check but the device's (the wide walk)
    "paged_hd_256_cpu": (port_paged_kernel,
                         (torch.zeros(2, 8, 256), torch.zeros(2, 5, 1, 256),
                          torch.zeros(2, 5, 1, 256), _i32(2, 3), _i32(2)),
                         ValueError, "CUDA tensors"),
    # the ragged walk keeps its own limit: hd 256 is refused there
    "ragged_hd_over_128": (port_ragged_kernel,
                           (torch.zeros(1, 8, 256), torch.zeros(3, 4, 1, 256),
                            torch.zeros(3, 4, 1, 256), _i32(1, 2), _i32(1),
                            _i32(1)), ValueError, "unsupported"),
    "flash_hd_over_256": (port_flash_kernel,
                          (torch.zeros(1, 4, 2, 264), torch.zeros(1, 4, 1, 264),
                           torch.zeros(1, 4, 1, 264)), ValueError,
                          "unsupported"),
    "paged_cpu": (port_paged_kernel, (_Q3, _C4, _C4, _i32(2, 3), _i32(2)),
                  ValueError, "CUDA tensors"),
    "paged_int64_lengths": (port_paged_kernel,
                            (_Q3, _C4, _C4, _i32(2, 3),
                             torch.zeros(2, dtype=torch.long)),
                            TypeError, "int32"),
    "paged_table_rows": (port_paged_kernel,
                         (_Q3, _C4, _C4, _i32(3, 3), _i32(2)), ValueError,
                         r"\(b, npages"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_kernels_refuse_bad_arguments(case):
    fn, args, err, match = BAD[case]
    with pytest.raises(err, match=match):
        fn(*args)
