"""The ctypes bindings of the port's CUDA kernels against their C entry
points, and the pure-Python helpers that size and pick a kernel's build.

Every ``extern "C"`` function in ``src/repro_torch/kernels/csrc/*.cu`` is
parsed from the source and its parameter list held to the ``argtypes`` its
wrapper declares (``c_void_p`` for each pointer and the stream,
``c_int64`` for each ``int64_t``, ``c_int`` for each ``int``, ``c_float``
for each ``float``): a mismatch would pass the wrong bits with no error.
Nothing is built and no GPU is needed.
"""
import ctypes
import re

import pytest
import torch

from repro_torch.kernels import aot_bias, decode_attention, flash_attention
from repro_torch.kernels._build import CSRC

# C entry point -> the argtypes its wrapper declares
DECLARED = {
    "aot_gather_add": aot_bias._ARGTYPES["aot_gather_add"],
    "aot_gather_add_multitask": aot_bias._ARGTYPES[
        "aot_gather_add_multitask"],
    "aot_gather_add_norm": aot_bias._ARGTYPES["aot_gather_add_norm"],
    "aot_gather_add_multitask_norm": aot_bias._ARGTYPES[
        "aot_gather_add_multitask_norm"],
    "rms_norm": aot_bias._ARGTYPES["rms_norm"],
    "flash_attention": flash_attention._ARGTYPES,
    "decode_attention": decode_attention._ARGTYPES["decode_attention"],
    "paged_decode_attention": decode_attention._ARGTYPES[
        "paged_decode_attention"],
    "ragged_paged_attention": decode_attention._ARGTYPES[
        "ragged_paged_attention"],
}

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def _ctype(param: str):
    """The ctypes type that carries one C parameter declaration."""
    decl = " ".join(param.split())
    if "*" in decl:
        return ctypes.c_void_p
    kind = decl.rsplit(" ", 1)[0].replace("const ", "")
    return {"int64_t": ctypes.c_int64, "int": ctypes.c_int,
            "float": ctypes.c_float}[kind]


def _entry_points():
    """{name: [ctypes type of each parameter]} of every C entry point."""
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in _ENTRY.findall(src.read_text()):
            found[name] = [_ctype(p) for p in params.split(",")]
    return found


def test_every_entry_point_has_a_binding():
    assert sorted(_entry_points()) == sorted(DECLARED)


@pytest.mark.parametrize("name", sorted(DECLARED))
def test_binding_matches_c_signature(name):
    want = _entry_points()[name]
    got = DECLARED[name]
    assert len(got) == len(want), (name, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is w, f"{name} parameter {i}: argtypes {g.__name__}, C " \
                       f"{w.__name__}"


@pytest.mark.parametrize("param, want", [
    ("const void* q", ctypes.c_void_p), ("void* stream", ctypes.c_void_p),
    ("int64_t q_sb", ctypes.c_int64), ("int hd", ctypes.c_int),
    ("float scale", ctypes.c_float), ("const void *\n  k", ctypes.c_void_p)])
def test_parameter_parser(param, want):
    assert _ctype(param) is want


# ---------------------------------------------------------------------------
# the contiguous decode kernel's cluster split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S, want", [(0, 1), (1, 1), (256, 1), (257, 2),
                                     (300, 2), (1000, 4), (1024, 4),
                                     (2048, 8), (8192, 8)])
def test_decode_split_size(S, want):
    assert decode_attention.decode_split(S) == want


@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 129, 500, 1000, 1024,
                               4099])
def test_decode_split_blocks_cover_the_cache(S):
    """Block r of the cluster walks [r c, (r + 1) c), c = ceil(S / split)
    (as the C launcher computes it): the blocks cover positions 0 .. S - 1
    once each."""
    split = decode_attention.decode_split(S)
    assert 1 <= split <= decode_attention.MAX_SPLIT
    c = -(-S // split)
    seen = [0] * S
    for r in range(split):
        for p in range(r * c, min((r + 1) * c, S)):
            seen[p] += 1
    assert seen == [1] * S


# ---------------------------------------------------------------------------
# the flash kernel's build: 16-byte copies only where every row allows them
# ---------------------------------------------------------------------------

def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def _shifted(*shape):
    """A contiguous bf16 tensor one element past a 16-byte boundary."""
    n = 1
    for d in shape:
        n *= d
    return _bf16(n + 1)[1:].view(*shape)


VEC_CASES = {
    "contiguous_hd64": ((_bf16(2, 9, 6, 64), _bf16(2, 9, 2, 64)), 64, 1),
    "contiguous_hd128": ((_bf16(1, 5, 4, 128), _bf16(1, 5, 4, 128)), 128,
                         1),
    "hd60": ((_bf16(2, 9, 6, 60), _bf16(2, 9, 2, 60)), 60, 0),
    "strided_q": ((_bf16(2, 9, 6, 128)[..., :64], _bf16(2, 9, 2, 64)), 64,
                  1),
    "odd_head_stride": ((_bf16(2, 9, 6, 65)[..., :64], _bf16(2, 9, 2, 64)),
                        64, 0),
    "misaligned_k": ((_bf16(2, 9, 6, 64), _shifted(2, 9, 2, 64)), 64, 0),
    "one_row_odd_batch_stride": ((_bf16(9, 6, 64).view(1, 9, 6, 64)
                                  .as_strided((1, 9, 6, 64),
                                              (3, 384, 64, 1)),
                                  _bf16(1, 9, 2, 64)), 64, 1),
    "broadcast_k_batch": ((_bf16(2, 9, 6, 64),
                           _bf16(1, 9, 2, 64).expand(2, 9, 2, 64)), 64, 0),
}


@pytest.mark.parametrize("case", sorted(VEC_CASES))
def test_flash_vec_build_choice(case):
    xs, hd, want = VEC_CASES[case]
    assert flash_attention._vec(hd, *xs) == want



# ---------------------------------------------------------------------------
# the flash kernel's wgmma build: query rows a block by grid size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b, sq, h, hd, sms, want", [
    (16, 512, 15, 64, 132, 128),     # smollm's static prefill: 960 tiles
    (1, 512, 15, 64, 132, 64),       # one prompt: 60 tiles of 128 rows
    (8, 384, 16, 64, 132, 128),      # the encoders' batch
    (8, 512, 16, 80, 132, 128),      # hubert's frames
    (1, 6144, 32, 80, 132, 128),     # danube's long prompt
    (16, 512, 32, 128, 132, 128),    # qwen3-moe's static prefill
    (4, 3072, 16, 256, 132, 64),     # hd 256: one warpgroup a block
    (1, 128, 132, 64, 132, 128),     # exactly one 128-row tile an SM
    (1, 128, 131, 64, 132, 64),      # one short
    (1, 129, 66, 64, 132, 128),      # two tiles a head
    (2, 127, 15, 64, 132, 64),
])
def test_flash_tile_rows(b, sq, h, hd, sms, want):
    assert flash_attention.tile_rows(b, sq, h, hd, sms) == want


@pytest.mark.parametrize("bf16, vec, rows, want", [
    (True, 1, 128, "wgmma_m128"), (True, 1, 64, "wgmma_m64"),
    (True, 0, 64, "mma"), (False, 0, 64, "simt")])
def test_flash_build_name(bf16, vec, rows, want):
    assert flash_attention.build_name(bf16, vec, rows) == want
