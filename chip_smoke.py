#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py        # from the root of a checkout

Phases, each printing one line of results; any failure exits non-zero:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every CUDA source under src/repro_torch/kernels/csrc compiled by
   nvcc for sm_90a, one nvcc each, in parallel;
3. parity: each kernel's public wrapper against its plain PyTorch version
   on the card at smollm-360m's shapes (gather-add bitwise; attention
   within 2e-5 in float32 and 2e-2 in bfloat16), for both the
   16-byte-load and the one-element-load build where a kernel has both:
   ragged paged attention; flash attention (causal, full, window; sq = skv
   in {1, 37, 512}, sq != skv, hd 60, a strided q); contiguous decode
   (scalar and per-row lengths with 0, 1 and ragged depths, S = 1024);
   paged decode (length 0, lengths that straddle pages, depth 1024);
4. kernel times at the serving paths' shapes (device time from
   torch.profiler), beside the plain version's, one PyTorch library call's
   where there is one, and the least time the card could take (bytes at
   3.35 TB/s, operations at the published peak);
5. the paged main path: full-width 32-layer smollm-360m in bfloat16 with 4
   fused tasks serving a Poisson stream through the launcher's own code
   (repro_torch.launch.serve, chunked prefill), greedy, then 4 requests
   sampled at temperature 0.8 / top-p 0.9;
5b. the same greedy stream admitted whole: --layout slots (flash prefill,
   contiguous decode) and --layout paged --prefill-chunk 0 (flash prefill,
   ragged ticks);
5c. the static batch (ServeEngine.generate, the paper's Fig. 3 setting):
   16 prompts of 512 tokens with mixed tasks, 64 new tokens; the same
   prompts as per-task batches; the mixed batch over a paged pool
   (Model.decode_step(block_tables=)). Generated tokens/s of each;
   in 5-5c every request must finish, every pool must drain clean, and
   each kernel must launch exactly 32 times per call that runs it (counts
   zeroed just before each run);
6. cross-checks at full width with 2 layers: one mixed tick, and a prefill
   plus three decode steps, through the kernels and through the plain
   versions (bf16 tolerance, same greedy tokens); paged against contiguous
   decode steps from one prefill (same tokens); preempt-and-recompute
   parity is reported.

The last two lines are a JSON line of per-kernel numbers (``launches``:
the count on the path each kernel serves; ``launches_by_path``: every
path's) and ``{"ok": true, "device": {...}}``. Details go to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_TENSOR_FLOPS = 989e12         # dense bf16 tensor-core peak
FP32_FLOPS = 67e12                 # float32 outside the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
H, KVH, HD, BS = 15, 5, 64, 16     # smollm-360m attention, page size
SLOTS, MAX_LEN = 8, 1024
NPAGES = MAX_LEN // BS
NUM_BLOCKS = SLOTS * NPAGES + 1
DEV = "cuda"
ROTATE = 32                        # layers of inputs a timing cycles through
KERNEL_SOURCES = sorted(p.stem for p in (
    ROOT / "src" / "repro_torch" / "kernels" / "csrc").glob("*.cu"))


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def wall_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean wall time per call of fn(i) run back to back, between two CUDA
    events: host launch overhead included."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device time of fn(i), summed over every CUDA kernel it launches
    (torch.profiler, CUPTI); raises when the profiler records no kernel.
    Unlike wall_ms, host time between launches does not count."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us += getattr(e, "self_device_time_total", 0.0) or 0.0
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no CUDA kernel time")
    return us / iters / 1e3


# ---------------------------------------------------------------------------
# inputs at the serving tick's shapes
# ---------------------------------------------------------------------------

def packings():
    """(token_rows, token_pos) packings over 8 slots of up to 1024 tokens."""
    decode_pos = [0, 16, 99, 254, 255, 510, 776, 1022]
    out = {"decode_only": (list(range(SLOTS)), decode_pos)}
    rows, pos = [0] * 256, list(range(256))                  # a fresh prompt
    rows += list(range(1, SLOTS))
    pos += decode_pos[1:]
    out["chunk256_decode"] = (rows, pos)
    rows, pos = [1] * 100 + [2] * 60 + [3] * 96, \
        list(range(300, 400)) + list(range(60)) + list(range(500, 596))
    rows += [0, 4, 5, 6]
    pos += [15, 16, 31, 1023]
    n_dead = SLOTS - 1 + 256 - len(rows)
    out["chunks_decode_dead"] = (rows + [0] * n_dead, pos + [-1] * n_dead)
    rows = [2] * 33 + [0, 1, 3, 4]
    pos = list(range(8, 41)) + [15, 16, 31, 32]             # across pages
    out["straddle_pages"] = (rows, pos)
    rows = [5] * 256 + [6, 7]
    pos = list(range(768, 1024)) + [1023, 1000]             # depth 1024
    out["deep_1024"] = (rows, pos)
    return out


def misaligned(x):
    """A contiguous copy of x whose data starts one element past a 16-byte
    boundary, so that the kernels take their one-element (not 16-byte)
    loads."""
    y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    y = y.view(x.shape).copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    return y


def ragged_inputs(gen, rows, pos, dtype, layers=1, hd=HD):
    dev, T = DEV, len(rows)
    q = torch.randn(T, H, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(layers, NUM_BLOCKS, BS, KVH, hd, generator=gen,
                    device=dev).to(dtype)
    v = torch.randn(layers, NUM_BLOCKS, BS, KVH, hd, generator=gen,
                    device=dev).to(dtype)
    perm = torch.randperm(NUM_BLOCKS - 1, generator=gen, device=dev) + 1
    bt = perm.view(SLOTS, NPAGES).to(torch.int32)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return q, k, v, bt, i32(rows), i32(pos)


def ragged_bound(rows, pos, dtype):
    """Least time for one call: each input byte read once (per slot, the
    kv positions its deepest token needs), each output byte written once;
    operations 4 * hd per (query head, visible kv position)."""
    es = torch.finfo(dtype).bits // 8
    T = len(rows)
    depth = {}
    for r, p in zip(rows, pos):
        if p >= 0:
            depth[r] = max(depth.get(r, 0), p + 1)
    kv = sum(depth.values()) * KVH * HD * es * 2
    nbytes = 2 * T * H * HD * es + kv + 2 * T * 4 + SLOTS * NPAGES * 4
    flops = sum(p + 1 for p in pos if p >= 0) * H * HD * 4
    return bound(nbytes, flops, dtype)


def bound(nbytes, flops, dtype):
    """(least ms, "bytes" or "operations") for one call."""
    peak = BF16_TENSOR_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def gather_inputs(gen, T, h_dtype, tables, sets=1):
    dev = DEV
    n_tasks, V, d = tables.shape
    h = torch.randn(T, d, generator=gen, device=dev).to(h_dtype)
    tasks = [torch.randint(0, n_tasks, (T,), generator=gen, device=dev,
                           dtype=torch.int32) for _ in range(sets)]
    ids = [torch.randint(0, V, (T,), generator=gen, device=dev,
                         dtype=torch.int32) for _ in range(sets)]
    # a few out-of-range indices: the kernel clamps as the XLA gather does
    tasks[0][:3] = torch.tensor([n_tasks, -1, -9], dtype=torch.int32)
    ids[0][:3] = torch.tensor([V + 5, -1, -V - 7], dtype=torch.int32)
    return h, tasks, ids


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(names):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build(names)
    sec = time.perf_counter() - t0
    regs = []
    for name, out in logs.items():
        used = [ln.split("ptxas info    :")[-1].strip()
                for ln in out.splitlines() if "Used" in ln]
        regs.append(f"{name}:{len(used)} kernels, "
                    + "; ".join(sorted(set(used))[:2]))
    log("2 build", seconds=f"{sec:.1f}", arch="sm_90a",
        sources=",".join(f"{n}.cu" for n in names), ptxas="|".join(regs))
    return sec, logs


def phase_parity(gen, report):
    """Each kernel through its public wrapper (kernels.ops) against its
    plain version. Both kernels have a 16-byte-load build and a
    one-element-load build, picked by width and alignment; the "scalar"
    cases (a width not a multiple of 8, or data one element off a 16-byte
    boundary) hold the second against the plain version too."""
    from repro_torch.kernels import aot_bias, decode_attention, ops
    cases = {"vec": 0, "scalar": 0}

    def check_gather(h, tables, task, ids, what):
        out = ops.aot_gather_add_multitask(h, tables, task, ids)
        plain = aot_bias.aot_gather_add_multitask_plain(h, tables, task, ids)
        torch.cuda.synchronize()
        if not torch.equal(out, plain):
            raise AssertionError(
                f"gather-add {what} h={h.dtype} table={tables.dtype} "
                f"T={h.shape[0]} not bitwise equal: max err "
                f"{(out.float() - plain.float()).abs().max().item()}")

    for t_dtype in (torch.bfloat16, torch.float32):
        tables = (torch.randn(4, 49152, 960, generator=gen, device=DEV)
                  * 0.03).to(t_dtype)
        odd = (torch.randn(4, 4096, 962, generator=gen, device=DEV)
               * 0.03).to(t_dtype)                     # d % 8 != 0
        for h_dtype in (torch.bfloat16, torch.float32):
            for T in (8, 263):
                h, tasks, ids = gather_inputs(gen, T, h_dtype, tables)
                check_gather(h, tables, tasks[0], ids[0], "vec")
                cases["vec"] += 1
            check_gather(misaligned(h), tables, tasks[0], ids[0],
                         "scalar/misaligned h")
            h, tasks, ids = gather_inputs(gen, 263, h_dtype, odd)
            check_gather(h, odd, tasks[0], ids[0], "scalar/d 962")
            cases["scalar"] += 2
        del tables, odd
    log("3 parity", kernel="aot_gather_add_multitask",
        cases=f"{cases['vec']} vec + {cases['scalar']} scalar",
        result="bitwise equal", tables="4x49152x960 (vec, misaligned h), "
        "4x4096x962 (d%8!=0)", types="{f32,bf16}^2", T="8,263")

    def check_ragged(rows, pos, dtype, hd, shift):
        q, k, v, bt, r, p = ragged_inputs(gen, rows, pos, dtype, hd=hd)
        k, v = k[0], v[0]
        if shift:
            k, v = misaligned(k), misaligned(v)
        out = ops.ragged_paged_attention(q, k, v, bt, r, p)
        plain = decode_attention.ragged_paged_attention_plain(q, k, v, bt,
                                                              r, p)
        torch.cuda.synchronize()
        err = (out.float() - plain.float()).abs().max().item()
        tol = TOL[dtype]
        ok = torch.allclose(out.float(), plain.float(), atol=tol, rtol=tol)
        dead = torch.tensor(pos, device=DEV) < 0
        return err, ok and bool((out[dead] == 0).all())

    variants = {"vec": (HD, False), "vec_hd128": (128, False),
                "scalar_hd60": (60, False), "scalar_misaligned": (HD, True)}
    for variant, (hd, shift) in variants.items():
        rcases = []
        for name, (rows, pos) in packings().items():
            for dtype in (torch.float32, torch.bfloat16):
                err, ok = check_ragged(rows, pos, dtype, hd, shift)
                rcases.append(f"{name}/{str(dtype)[6:]}:{err:.2e}")
                report["parity"][f"ragged/{variant}/{name}/{dtype}"] = err
                if not ok:
                    raise AssertionError(
                        f"ragged attention {variant} {name} {dtype}: max "
                        f"abs err {err} over tol {TOL[dtype]}")
        log("3 parity", kernel="ragged_paged_attention", variant=variant,
            shapes=f"h15 kvh5 hd{hd} bs16 depth<=1024",
            max_abs_err=",".join(rcases))
    parity_flash(gen, report)
    parity_decode(gen, report)


def check_close(what, out, plain, dtype, report, zero_rows=None):
    """Hold a kernel's output to its plain version's at TOL[dtype]; rows
    flagged in ``zero_rows`` must be exact zeros. Returns the max abs
    error."""
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    report["parity"][what] = err
    tol = TOL[dtype]
    ok = torch.allclose(out.float(), plain.float(), atol=tol, rtol=tol)
    if zero_rows is not None:
        ok = ok and bool((out[zero_rows] == 0).all())
    if not ok:
        raise AssertionError(f"{what}: max abs err {err} over tol {tol} "
                             "(or a row that must be zero is not)")
    return err


# flash parity cases: name -> (b, sq, skv, hd, causal, window, strided,
# heads); smollm's heads (15 over 5) unless a case names others
FLASH_CASES = {
    "causal_1": (2, 1, 1, HD, True, 0, False),
    "causal_37": (2, 37, 37, HD, True, 0, False),
    "causal_512": (2, 512, 512, HD, True, 0, False),
    "full_37": (2, 37, 37, HD, False, 0, False),
    "full_512": (1, 512, 512, HD, False, 0, False),
    "window64_512": (2, 512, 512, HD, True, 64, False),
    "causal_sq37_skv100": (2, 37, 100, HD, True, 0, False),
    "causal_sq100_skv37": (2, 100, 37, HD, True, 0, False),
    "full_sq37_skv100": (2, 37, 100, HD, False, 0, False),
    "causal_hd60": (2, 37, 37, 60, True, 0, False),
    "causal_strided_q": (2, 100, 100, HD, True, 0, True),
    "causal_hd128": (2, 100, 100, 128, True, 0, False),    # 4 channels/lane
    "window16_g8": (2, 100, 100, HD, True, 16, False, (8, 1)),
}


def flash_inputs(gen, b, sq, skv, hd, dtype, strided=False,
                 heads=(H, KVH)):
    """q (b, sq, h, hd), k and v (b, skv, kvh, hd); ``strided`` gives q as
    a view with wider head and sequence strides (the kernel reads
    strides)."""
    h, kvh = heads
    rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                     device=DEV).to(dtype)
    q = rnd(b, sq, h, 2 * hd)[..., :hd] if strided else rnd(b, sq, h, hd)
    return q, rnd(b, skv, kvh, hd), rnd(b, skv, kvh, hd)


def parity_flash(gen, report):
    from repro_torch.kernels import flash_attention, ops
    cases = []
    for name, (b, sq, skv, hd, causal, window, *shape) in \
            FLASH_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(gen, b, sq, skv, hd, dtype, *shape)
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
            plain = flash_attention.flash_attention_plain(
                q, k, v, causal=causal, window=window)
            err = check_close(f"flash/{name}/{dtype}", out, plain, dtype,
                              report)
            cases.append(f"{name}/{str(dtype)[6:]}:{err:.2e}")
    log("3 parity", kernel="flash_attention",
        shapes="h15 kvh5 hd64|60|128, h8 kvh1 hd64",
        max_abs_err=",".join(cases))


DECODE_LENS = [0, 1, 33, 255, 256, 577, 1000, 1024]   # per row, S = 1024
PAGED_LENS = [0, 1, 15, 16, 17, 300, 1000, 1024]      # 8 slots, pages of 16


def decode_inputs(gen, lens, dtype, hd=HD, layers=1, S=MAX_LEN,
                  heads=(H, KVH)):
    b, (h, kvh) = len(lens), heads
    rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                     device=DEV).to(dtype)
    q = rnd(b, h, hd)
    k, v = rnd(layers, b, S, kvh, hd), rnd(layers, b, S, kvh, hd)
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=DEV)


def parity_decode(gen, report):
    """The contiguous and the paged decode kernel, each through its 16-byte
    load build (hd 64 or 128, aligned) and its one-element build (hd 60, or
    data one element off a 16-byte boundary), at smollm's heads and at the
    kernels' most query heads per KV head (8)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    smollm = (H, KVH)
    variants = {"vec": (HD, False, smollm),
                "scalar_hd60": (60, False, smollm),
                "scalar_misaligned": (HD, True, smollm),
                "vec_hd128": (128, False, smollm),
                "vec_g8": (HD, False, (8, 1))}
    for variant, (hd, shift, heads) in variants.items():
        cases = []
        kvh = heads[1]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, lens = decode_inputs(gen, DECODE_LENS, dtype, hd,
                                          heads=heads)
            k, v = k[0], v[0]
            if shift:
                k, v = misaligned(k), misaligned(v)
            for cur in ("per_row", 577, 0):
                arg = lens if cur == "per_row" else cur
                out = ops.decode_attention(q, k, v, arg)
                plain = da.decode_attention_plain(q, k, v, arg)
                zero = (lens <= 0) if cur == "per_row" else None
                if cur == 0:
                    zero = torch.ones(len(lens), dtype=torch.bool, device=DEV)
                err = check_close(f"decode/{variant}/{cur}/{dtype}", out,
                                  plain, dtype, report, zero)
                cases.append(f"decode/{cur}/{str(dtype)[6:]}:{err:.2e}")
            # paged: scrambled pages of 16 over 8 slots of 1024 tokens
            qp = q
            kp = torch.randn(NUM_BLOCKS, BS, kvh, hd, generator=gen,
                             device=DEV).to(dtype)
            vp = torch.randn(NUM_BLOCKS, BS, kvh, hd, generator=gen,
                             device=DEV).to(dtype)
            if shift:
                kp, vp = misaligned(kp), misaligned(vp)
            perm = torch.randperm(NUM_BLOCKS - 1, generator=gen,
                                  device=DEV) + 1
            bt = perm.view(SLOTS, NPAGES).to(torch.int32)
            plens = torch.tensor(PAGED_LENS, dtype=torch.int32, device=DEV)
            out = ops.paged_decode_attention(qp, kp, vp, bt, plens)
            plain = da.paged_decode_attention_plain(qp, kp, vp, bt, plens)
            err = check_close(f"paged_decode/{variant}/{dtype}", out, plain,
                              dtype, report, plens <= 0)
            cases.append(f"paged/{str(dtype)[6:]}:{err:.2e}")
        log("3 parity", kernel="decode_attention+paged_decode_attention",
            variant=variant,
            shapes=f"b8 h{heads[0]} kvh{kvh} hd{hd} S1024 bs16",
            max_abs_err=",".join(cases))


def timed(kern, plain, iters, plain_iters, tol):
    """A kernel's wrapper and its plain version on the same inputs: device
    time per call (``ms``, profiler), wall time per call back to back
    (``wall_ms``, CUDA events, host launch overhead included) and their max
    abs difference, which must be within tol (0: bitwise equal)."""
    res = dict(ms=device_ms(kern, iters),
               plain_ms=device_ms(plain, plain_iters),
               wall_ms=wall_ms(kern, iters),
               plain_wall_ms=wall_ms(plain, plain_iters))
    a, b = kern(0).float(), plain(0).float()
    res["err"] = (a - b).abs().max().item()
    ok = (torch.equal(a, b) if tol == 0
          else torch.allclose(a, b, atol=tol, rtol=tol))
    if not ok:
        raise AssertionError(f"timed kernel disagrees with its plain "
                             f"version: max abs err {res['err']}, tol {tol}")
    return res


def fmt_times(r) -> str:
    return (f"{r['ms']:.5f}ms(wall {r['wall_ms']:.4f}; plain "
            f"{r['plain_ms']:.4f}, wall {r['plain_wall_ms']:.4f}; bound "
            f"{r['bound_ms']:.5f}; err {r['err']:.2e})")


def phase_times(gen, report):
    """Each kernel at the serving tick's shapes (bf16, a 256-token chunk
    plus 7 decode rows: T = 263), inputs rotated so L2 cannot serve
    repeated launches: 8 id sets for the gather-add, 32 pool layers for the
    attention (one per model layer, as the tick walks them)."""
    from repro_torch.kernels import aot_bias, decode_attention, ops
    rows_out = []
    dt = torch.bfloat16
    # ---- gather-add
    tables = (torch.randn(4, 49152, 960, generator=gen, device=DEV)
              * 0.03).to(dt)
    res = {}
    for T in (263, 8):
        h, tasks, ids = gather_inputs(gen, T, dt, tables, sets=8)
        kern = lambda i: ops.aot_gather_add_multitask(h, tables, tasks[i % 8],
                                                      ids[i % 8])
        plain = lambda i: aot_bias.aot_gather_add_multitask_plain(
            h, tables, tasks[i % 8], ids[i % 8])
        res[T] = timed(kern, plain, 200, 200, tol=0)
        nbytes = 3 * T * 960 * 2 + 2 * T * 4
        res[T]["bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                                 T * 960 / FP32_FLOPS) * 1e3
    del tables
    g = res[263]
    rows_out.append({
        "name": "aot_gather_add_multitask", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/aot_gather_add.cu",
        "replaces": "src/repro/kernels/aot_bias.py:56",
        "max_abs_err": g["err"], "ms": g["ms"], "plain_ms": g["plain_ms"],
        "bound_ms": g["bound_ms"], "bound_by": "bytes", "library_ms": None})
    log("4 times", kernel="aot_gather_add_multitask",
        **{f"T{T}": fmt_times(r) for T, r in res.items()})
    report["times"]["aot_gather_add_multitask"] = res
    # ---- ragged attention
    pk = packings()
    res = {}
    for name in ("chunk256_decode", "decode_only"):
        rows, pos = pk[name]
        q, k, v, bt, r, p = ragged_inputs(gen, rows, pos, dt, layers=32)
        kern = lambda i: ops.ragged_paged_attention(q, k[i % 32], v[i % 32],
                                                    bt, r, p)
        plain = lambda i: decode_attention.ragged_paged_attention_plain(
            q, k[i % 32], v[i % 32], bt, r, p)
        res[name] = timed(kern, plain, 64, 16, tol=TOL[dt])
        res[name]["bound_ms"], res[name]["bound_by"] = ragged_bound(rows, pos,
                                                                    dt)
        res[name]["T"] = len(rows)
        del q, k, v
    a = res["chunk256_decode"]
    rows_out.append({
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:286",
        "max_abs_err": a["err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
        "library_ms": None})
    log("4 times", kernel="ragged_paged_attention",
        **{n: fmt_times(r) + f"[{r['bound_by']}, T{r['T']}]"
           for n, r in res.items()})
    report["times"]["ragged_paged_attention"] = res
    rows_out += times_prefill_decode(gen, report)
    return rows_out


def times_prefill_decode(gen, report):
    """The three kernels of the whole-prompt and decode paths at those
    paths' shapes, bf16: flash at the static batch's prefill (16 prompts of
    512, causal), contiguous decode at its steps (16 rows at depths
    512-575 of S = 1024), paged decode over 8 slots of depths up to 1024.
    Inputs rotate over ROTATE layers so L2 cannot serve repeated launches."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dt, es, rows_out = torch.bfloat16, 2, []
    # ---- flash attention: (16, 512, 15, 64) causal, 8 layers of inputs
    b, s = 16, 512
    qs = [flash_inputs(gen, b, s, s, HD, dt) for _ in range(8)]
    kern = lambda i: ops.flash_attention(*qs[i % 8], causal=True)
    plain = lambda i: fa.flash_attention_plain(*qs[i % 8], causal=True)
    res = timed(kern, plain, 32, 8, tol=TOL[dt])
    sdpa = lambda i: F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in qs[i % 8]), is_causal=True,
        enable_gqa=True)
    res["library_ms"] = device_ms(sdpa, 32)      # yardstick only
    pairs = b * H * s * (s + 1) // 2               # visible (head, q, kv)
    res["bound_ms"], res["bound_by"] = bound(
        b * s * (2 * H + 2 * KVH) * HD * es, 4 * HD * pairs, dt)
    rows_out.append(dict(name="flash_attention",
                         source="src/repro_torch/kernels/csrc/"
                                "flash_attention.cu",
                         replaces="src/repro/kernels/flash_attention.py:73",
                         res=res))
    del qs
    # ---- contiguous decode: 16 rows at depths 512..575 of S = 1024
    lens = list(range(512, 576, 4))
    q, k, v, cur = decode_inputs(gen, lens, dt, layers=ROTATE)
    layer = lambda i: (k[i % ROTATE], v[i % ROTATE])
    kern = lambda i: ops.decode_attention(q, *layer(i), cur)
    plain = lambda i: da.decode_attention_plain(q, *layer(i), cur)
    res = timed(kern, plain, 64, 16, tol=TOL[dt])
    mask = (torch.arange(MAX_LEN, device=DEV)[None, :]
            < cur[:, None])[:, None, None, :]   # (b, 1, 1, S): visible
    sdpa = lambda i: F.scaled_dot_product_attention(
        q[:, :, None], *(x.transpose(1, 2) for x in layer(i)),
        attn_mask=mask, enable_gqa=True)
    res["library_ms"] = device_ms(sdpa, 64)      # yardstick only
    n_kv = sum(lens)
    res["bound_ms"], res["bound_by"] = bound(
        2 * len(lens) * H * HD * es + 2 * n_kv * KVH * HD * es
        + 4 * len(lens), 4 * HD * H * n_kv, dt)
    rows_out.append(dict(name="decode_attention",
                         source="src/repro_torch/kernels/csrc/"
                                "decode_attention.cu",
                         replaces="src/repro/kernels/decode_attention.py:97",
                         res=res))
    del q, k, v
    # ---- paged decode: 8 slots of depths up to 1024, scrambled pages
    plens = [1024, 1000, 777, 576, 512, 300, 129, 17]
    q = torch.randn(SLOTS, H, HD, generator=gen, device=DEV).to(dt)
    kp = torch.randn(ROTATE, NUM_BLOCKS, BS, KVH, HD, generator=gen,
                     device=DEV).to(dt)
    vp = torch.randn(ROTATE, NUM_BLOCKS, BS, KVH, HD, generator=gen,
                     device=DEV).to(dt)
    perm = torch.randperm(NUM_BLOCKS - 1, generator=gen, device=DEV) + 1
    bt = perm.view(SLOTS, NPAGES).to(torch.int32)
    cur = torch.tensor(plens, dtype=torch.int32, device=DEV)
    layer = lambda i: (kp[i % ROTATE], vp[i % ROTATE])
    kern = lambda i: ops.paged_decode_attention(q, *layer(i), bt, cur)
    plain = lambda i: da.paged_decode_attention_plain(q, *layer(i), bt, cur)
    res = timed(kern, plain, 64, 16, tol=TOL[dt])
    res["library_ms"] = None        # no one PyTorch call reads block tables
    n_kv = sum(plens)
    pages_read = sum(-(-n // BS) for n in plens)
    res["bound_ms"], res["bound_by"] = bound(
        2 * SLOTS * H * HD * es + 2 * n_kv * KVH * HD * es
        + 4 * (SLOTS + pages_read), 4 * HD * H * n_kv, dt)
    rows_out.append(dict(name="paged_decode_attention",
                         source="src/repro_torch/kernels/csrc/"
                                "decode_attention.cu",
                         replaces="src/repro/kernels/decode_attention.py:186",
                         res=res))
    del kp, vp
    out = []
    for row in rows_out:
        r = row.pop("res")
        report["times"][row["name"]] = r
        lib = r["library_ms"]
        log("4 times", kernel=row["name"], times=fmt_times(r) + (
            f"[{r['bound_by']}; library {lib:.5f}]" if lib is not None
            else f"[{r['bound_by']}; library none]"))
        out.append({"name": row["name"], "route": "cuda",
                    "source": row["source"], "replaces": row["replaces"],
                    "max_abs_err": r["err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": lib})
    return out


# the launcher's flags of every served stream: full-width smollm-360m in
# bf16, 4 fused tasks, a Poisson stream of prompts of 4-512 tokens
BASE = ["--arch", "smollm-360m", "--demo", "--tasks", "4",
        "--rate", "0.5", "--slots", str(SLOTS), "--block-size", str(BS),
        "--max-len", str(MAX_LEN), "--prefill-chunk", "256",
        "--max-prefills", "4", "--prompt", "512", "--steps", "48",
        "--dtype", "bfloat16", "--quiet"]
GREEDY = ["--requests", "16"]
# the path run whose count is each kernel's ``launches``
MAIN_PATH = {"aot_gather_add_multitask": "paged_greedy",
             "ragged_paged_attention": "paged_greedy",
             "flash_attention": "static_mixed",
             "decode_attention": "static_mixed",
             "paged_decode_attention": "static_paged"}


def build_engine():
    """The launcher's engine for BASE (random weights, seed 0), and the
    seconds it took."""
    from repro_torch.launch import serve as launcher
    t0 = time.perf_counter()
    engine = launcher.build_engine(launcher.parser().parse_args(BASE))
    torch.cuda.synchronize()
    return engine, time.perf_counter() - t0


def phase_main_path(report, engine, setup_s):
    """The paged streams (chunked prefill): greedy, then sampled."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    runs = {"greedy": GREEDY,
            "sampled": ["--requests", "4", "--temperature", "0.8",
                        "--top-p", "0.9", "--seed", "100"]}
    layers = engine.model.cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    total, launches = {}, {}
    for label, extra in runs.items():
        args = launcher.parser().parse_args(BASE + extra)
        arrivals = launcher.make_arrivals(args, engine.model.cfg.vocab_size,
                                          args.tasks)
        d0 = engine.dispatches
        torch.cuda.synchronize()
        ops.reset_launches()            # each run's own counts, from 0
        t1 = time.perf_counter()
        sched = launcher.serve(engine, args, arrivals)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t1
        counts = launches[label] = dict(ops.launches())
        dispatched = engine.dispatches - d0
        prompt_toks = sum(len(r.prompt) for _, r in arrivals)
        findings = sched.drain_check()
        log(f"5 main path/{label}", requests=f"{len(sched.finished)}/"
            f"{len(arrivals)}", tokens=sched.tokens_emitted,
            prompt_tokens=prompt_toks, ticks=sched.ticks,
            dispatched=dispatched, preemptions=sched.preemptions,
            seconds=f"{sec:.3f}",
            tokens_per_s=f"{sched.tokens_emitted / sec:.1f}",
            all_tokens_per_s=f"{(sched.tokens_emitted + prompt_toks) / sec:.1f}",
            drain="clean" if not findings else findings,
            launches=counts, finite="all reported rows")
        if len(sched.finished) != len(arrivals) or findings:
            raise AssertionError(f"{label}: unfinished requests or leaks")
        check_launches(label, counts, {
            "aot_gather_add_multitask": layers * dispatched,
            "ragged_paged_attention": layers * dispatched})
        total[label] = dict(requests=len(sched.finished),
                            tokens=sched.tokens_emitted,
                            prompt_tokens=prompt_toks, ticks=sched.ticks,
                            dispatched=dispatched, seconds=sec,
                            tokens_per_s=sched.tokens_emitted / sec,
                            preemptions=sched.preemptions, launches=counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("5 main path", layers=layers, setup_s=f"{setup_s:.1f}",
        peak_memory_gib=f"{peak:.2f}",
        table_gib=f"{engine.tables.numel() * 2 / 2 ** 30:.2f}")
    report["main_path"] = dict(runs=total, peak_memory_gib=peak,
                               setup_s=setup_s)
    # where the time goes: the sampled stream once more under the profiler
    # (its tracing slows the host, so the busy share is a lower bound)
    args = launcher.parser().parse_args(BASE + runs["sampled"])
    arrivals = launcher.make_arrivals(args, engine.model.cfg.vocab_size,
                                      args.tasks)
    report["profile"] = profile_run(
        "5 profile", lambda: launcher.serve(engine, args, arrivals),
        steps=total["sampled"]["ticks"])    # a tick is one step
    return {f"paged_{label}": counts for label, counts in launches.items()}


def check_launches(label, counts, want):
    """Each kernel's launches in one path's run must be exactly ``want``
    (kernels not named there: 0)."""
    for name, c in counts.items():
        if c != want.get(name, 0):
            raise AssertionError(f"{label}: {name} launched {c} times, "
                                 f"expected {want.get(name, 0)}")


def phase_whole_prompt(report, engine):
    """Phase 5's greedy stream with whole-prompt admission: through the
    slotted layout (flash prefill per request, then one contiguous decode
    call per tick) and through the paged layout with --prefill-chunk 0
    (flash prefill scattered into pages, then one ragged tick per tick)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    layers = engine.model.cfg.num_layers
    runs = {"slots_greedy": ["--layout", "slots", "--prefill-chunk", "0"],
            "paged_whole_greedy": ["--layout", "paged", "--prefill-chunk",
                                   "0"]}
    out = {}
    prefill = engine.prefill_request
    for label, extra in runs.items():
        args = launcher.parser().parse_args(BASE + GREEDY + extra)
        arrivals = launcher.make_arrivals(args, engine.model.cfg.vocab_size,
                                          args.tasks)
        n_pf = [0]

        def counted(*a, **kw):
            n_pf[0] += 1
            return prefill(*a, **kw)
        engine.prefill_request = counted        # counts whole prefills
        d0 = engine.dispatches
        torch.cuda.synchronize()
        ops.reset_launches()
        t1 = time.perf_counter()
        try:
            sched = launcher.serve(engine, args, arrivals)
            torch.cuda.synchronize()
        finally:
            del engine.prefill_request
        sec = time.perf_counter() - t1
        counts = out[label] = dict(ops.launches())
        steps = engine.dispatches - d0 - n_pf[0]   # decode / serve_step calls
        attn = "decode_attention" if args.layout == "slots" \
            else "ragged_paged_attention"
        findings = sched.drain_check()
        prompt_toks = sum(len(r.prompt) for _, r in arrivals)
        log(f"5b whole-prompt/{label}", requests=f"{len(sched.finished)}/"
            f"{len(arrivals)}", tokens=sched.tokens_emitted,
            prompt_tokens=prompt_toks, ticks=sched.ticks, prefills=n_pf[0],
            decode_calls=steps, preemptions=sched.preemptions,
            seconds=f"{sec:.3f}",
            tokens_per_s=f"{sched.tokens_emitted / sec:.1f}",
            all_tokens_per_s=f"{(sched.tokens_emitted + prompt_toks) / sec:.1f}",
            drain="clean" if not findings else findings, launches=counts)
        if len(sched.finished) != len(arrivals) or findings:
            raise AssertionError(f"{label}: unfinished requests or leaks")
        check_launches(label, counts, {
            "flash_attention": layers * n_pf[0], attn: layers * steps,
            "aot_gather_add_multitask": layers * (n_pf[0] + steps)})
        report.setdefault("whole_prompt", {})[label] = dict(
            requests=len(sched.finished), tokens=sched.tokens_emitted,
            prompt_tokens=prompt_toks, ticks=sched.ticks, prefills=n_pf[0],
            decode_calls=steps, seconds=sec,
            tokens_per_s=sched.tokens_emitted / sec,
            preemptions=sched.preemptions, launches=counts)
    return out


def paged_generate(engine, prompts, steps, task_ids):
    """The static batch over a paged pool, through the port's entry points:
    ``Model.prefill``, ``PagedKVPool.write_prefill`` of each row into its
    own pages, then greedy ``Model.decode_step(block_tables=)`` steps.
    Returns (b, steps) tokens as ``ServeEngine.generate`` does."""
    from repro_torch.serve.kv_pool import PagedKVPool
    model, dev = engine.model, engine.device
    b, s = prompts.shape
    pool = PagedKVPool(model, b, engine.cfg.max_len, block_size=BS)
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    peft = engine._peft(torch.as_tensor(task_ids, dtype=torch.int32,
                                        device=dev))
    logits, cache, pos = model.prefill(engine.params, toks, peft,
                                       max_len=engine.cache_len)
    for r in range(b):
        slot = pool.alloc(int(task_ids[r]), pool.pages_needed(s + steps))
        pool.write_prefill(slot, {n: c[:, r:r + 1] for n, c in cache.items()},
                           s)
    del cache
    bt = torch.as_tensor(pool.block_tables, device=dev)
    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    out = []
    for i in range(steps):
        out.append(tok)
        logits, pool.cache = model.decode_step(
            engine.params, tok, torch.full((b,), pos + i, dtype=torch.int32,
                                           device=dev),
            pool.cache, peft, block_tables=bt)
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    for r in range(b):
        pool.free(r)
    if pool.leak_report():
        raise AssertionError(f"paged static pool: {pool.leak_report()}")
    return torch.cat(out, dim=1).cpu().numpy()


def phase_static(report, engine):
    """The paper's Fig. 3 setting at full width: one static batch of 16
    prompts of 512 tokens with mixed task ids, 64 greedy tokens each,
    through ``ServeEngine.generate`` (flash prefill, contiguous decode);
    the same prompts as per-task batches, each on an engine holding that
    task's table alone (benchmarks/multitask_throughput.py's sequential
    baseline); and the mixed batch over a paged pool (paged decode)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeEngine
    layers = engine.model.cfg.num_layers
    n_tasks = engine.num_tasks
    b, s, steps = 16, 512, 64
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, engine.model.cfg.vocab_size,
                           (b, s)).astype(np.int32)
    task_ids = rng.integers(0, n_tasks, b).astype(np.int32)
    engine.generate(prompts[:2], 2, task_ids[:2])        # warm-up
    res, counts = {}, {}

    def run(label, fn):
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts[label] = dict(ops.launches())
        res[label] = dict(seconds=sec, tokens_per_s=b * steps / sec)
        return out

    mixed = run("static_mixed", lambda: engine.generate(prompts, steps,
                                                        task_ids))
    check_launches("static_mixed", counts["static_mixed"], {
        "flash_attention": layers, "decode_attention": layers * steps,
        "aot_gather_add_multitask": layers * (1 + steps)})

    def per_task():
        outs = np.zeros_like(mixed)
        for t in range(n_tasks):
            idx = np.where(task_ids == t)[0]
            if len(idx) == 0:
                continue
            one = ServeEngine(engine.model, engine.params, engine.cfg,
                              fused_tasks={"table": engine.tables[
                                  :, t:t + 1].contiguous()})
            outs[idx] = one.generate(prompts[idx], steps,
                                     np.zeros(len(idx), np.int32))
            del one
        return outs
    n_runs = len(set(task_ids.tolist()))
    seq = run("static_per_task", per_task)
    check_launches("static_per_task", counts["static_per_task"], {
        "flash_attention": layers * n_runs,
        "decode_attention": layers * steps * n_runs,
        "aot_gather_add_multitask": layers * (1 + steps) * n_runs})
    paged = run("static_paged", lambda: paged_generate(engine, prompts,
                                                       steps, task_ids))
    check_launches("static_paged", counts["static_paged"], {
        "flash_attention": layers, "paged_decode_attention": layers * steps,
        "aot_gather_add_multitask": layers * (1 + steps)})
    same_seq = int((seq == mixed).all(axis=1).sum())
    same_paged = int((paged == mixed).all(axis=1).sum())
    log("5c static batch", b=b, prompt=s, steps=steps,
        tasks=np.bincount(task_ids, minlength=n_tasks).tolist(),
        mixed_tokens_per_s=f"{res['static_mixed']['tokens_per_s']:.1f}",
        per_task_tokens_per_s=f"{res['static_per_task']['tokens_per_s']:.1f}",
        per_task_runs=n_runs,
        paged_tokens_per_s=f"{res['static_paged']['tokens_per_s']:.1f}",
        rows_equal_per_task=f"{same_seq}/{b}",
        rows_equal_paged=f"{same_paged}/{b}", launches=counts)
    report["static"] = dict(res, rows_equal_per_task=same_seq,
                            rows_equal_paged=same_paged, launches=counts)
    # where the time goes: the mixed batch with 16 steps under the profiler
    # (its tracing slows the host, so the busy share is a lower bound)
    report["static"]["profile"] = profile_run(
        "5c profile", lambda: engine.generate(prompts, 16, task_ids),
        steps=16)
    return counts


def profile_run(phase, fn, steps):
    """Device busy share, kernels per step and the top kernels and host
    ops of ``fn()`` under torch.profiler (CPU + CUDA)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t1) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    avgs = prof.key_averages()
    kern = sorted(((e.self_device_time_total / 1e3, e.key) for e in avgs
                   if e.device_type == cuda), reverse=True)
    host = sorted(((e.self_cpu_time_total / 1e3, e.key) for e in avgs
                   if e.device_type != cuda), reverse=True)
    busy_ms = sum(t for t, _ in kern)
    per_step = sum(e.count for e in avgs
                   if e.device_type == cuda) / max(steps, 1)
    top = lambda rows: ";".join(f"{k[:40]}:{t:.0f}ms" for t, k in rows[:5])
    log(phase, steps=steps, wall_ms=f"{wall_ms:.0f}",
        device_busy_ms=f"{busy_ms:.0f}",
        busy_share=f"{busy_ms / wall_ms:.3f}",
        kernels_per_step=f"{per_step:.0f}", top_kernels=top(kern),
        top_host_ops=top(host))
    return dict(steps=steps, wall_ms=wall_ms, device_busy_ms=busy_ms,
                kernels_per_step=per_step, kernels=kern[:15],
                host_ops=host[:25])


@contextlib.contextmanager
def plain_ops():
    """Every kernel wrapper the model calls replaced by its plain version
    (the same tensors on the card, no kernel launched)."""
    from repro_torch.kernels import aot_bias, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    plain = {"aot_gather_add_multitask": aot_bias.aot_gather_add_multitask_plain,
             "ragged_paged_attention": da.ragged_paged_attention_plain,
             "flash_attention": fa.flash_attention_plain,
             "decode_attention": da.decode_attention_plain,
             "paged_decode_attention": da.paged_decode_attention_plain}
    saved = {name: getattr(ops, name) for name in plain}
    for name, fn in plain.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def cross_check_static(gen, report, model, params, tables):
    """At full width with 2 layers: a whole-prompt prefill plus three
    decode steps through the kernels against the plain versions (bf16
    tolerance, same greedy tokens); then decode steps over a paged pool
    filled from that prefill (scrambled pages) against the contiguous
    decode steps on the same cache (same tokens)."""
    from repro_torch.serve.kv_pool import PagedKVPool
    b, s, steps = 4, 300, 3
    dev = torch.device(DEV)
    toks = torch.randint(0, model.cfg.vocab_size, (b, s), generator=gen,
                         device=DEV, dtype=torch.int32)
    peft = {"method": "aot", "tables": tables,
            "task_ids": torch.arange(b, dtype=torch.int32, device=dev) % 4}

    def decode(logits, cache, block_tables=None):
        """``steps`` greedy decode steps after ``logits``: per-step logits
        (steps + 1, b, V) float32 and the tokens (b, steps)."""
        lgs, tokens = [logits[:, -1].float()], []
        for i in range(steps):
            tok = lgs[-1].argmax(-1).to(torch.int32)[:, None]
            tokens.append(tok)
            pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
            logits, cache = model.decode_step(params, tok, pos, cache, peft,
                                              block_tables=block_tables)
            lgs.append(logits[:, -1].float())
        torch.cuda.synchronize()
        return torch.stack(lgs), torch.cat(tokens, 1)

    def prefill_and_decode():
        logits, cache, _ = model.prefill(params, toks, peft, max_len=MAX_LEN)
        return decode(logits, cache)

    lg_k, tok_k = prefill_and_decode()
    with plain_ops():
        lg_p, tok_p = prefill_and_decode()
    err = (lg_k - lg_p).abs().max().item()
    same = torch.equal(tok_k, tok_p)
    ok = torch.allclose(lg_k, lg_p, atol=2e-2, rtol=2e-2) and same
    first, cache, _ = model.prefill(params, toks, peft, max_len=MAX_LEN)
    # the paged pool, pages handed out in a scrambled order
    pool = PagedKVPool(model, b, MAX_LEN, block_size=BS)
    pool._free_blocks = [int(p) for p in np.random.default_rng(1).permutation(
        pool._free_blocks)]
    for r in range(b):
        slot = pool.alloc(0, pool.pages_needed(s + steps))
        pool.write_prefill(slot, {n: c[:, r:r + 1] for n, c in cache.items()},
                           s)
    bt = torch.as_tensor(pool.block_tables, device=dev)
    lg_c, tok_c = decode(first, cache)
    lg_g, tok_g = decode(first, pool.cache, bt)
    paged_err = (lg_g - lg_c).abs().max().item()
    paged_same = torch.equal(tok_g, tok_c)
    log("6 cross-check static", layers=2, b=b, prompt=s, steps=steps,
        logits_max_abs_err=f"{err:.3e}",
        greedy_tokens="identical" if same else "DIFFER",
        paged_vs_contiguous_max_abs_err=f"{paged_err:.3e}",
        paged_tokens="identical" if paged_same else "DIFFER")
    report["cross_check_static"] = dict(
        logits_max_abs_err=err, same_tokens=same,
        paged_vs_contiguous_max_abs_err=paged_err, paged_same=paged_same)
    if not (ok and paged_same and paged_err <= 2e-2):
        raise AssertionError("static path: kernel and plain, or paged and "
                             "contiguous decode, disagree")


def phase_cross_check(gen, report):
    from repro_torch import configs
    from repro_torch.core import aot as aot_mod
    from repro_torch.models import model as model_mod
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.scheduler import (ContinuousScheduler, Request,
                                             SchedulerConfig)
    dt = torch.bfloat16
    cfg = configs.get("smollm-360m").replace(num_layers=2)
    model = model_mod.Model(cfg, model_mod.ModelOptions(dt, dt), device=DEV)
    params = model.init(1)
    tables = aot_mod.stack_tasks([aot_mod.random_fused(
        cfg, params["embed"]["tok"], seed=t, scale=0.03, vocab_chunk=4096,
        dtype=dt) for t in range(4)])["table"]
    rows, pos = packings()["chunks_decode_dead"]
    T = len(rows)
    cache0 = model.init_paged_cache(NUM_BLOCKS, BS)
    for name in ("k", "v"):
        cache0[name].normal_(generator=gen)
    perm = torch.randperm(NUM_BLOCKS - 1, generator=gen, device=DEV) + 1
    bt = perm.view(SLOTS, NPAGES).to(torch.int32)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=DEV)
    tokens = torch.randint(0, cfg.vocab_size, (T, 1), generator=gen,
                           device=DEV, dtype=torch.int32)
    slot_task = [0, 1, 2, 3, 0, 1, 2, 3]
    lidx = [0] * SLOTS
    for t, (r, p) in enumerate(zip(rows, pos)):
        if p >= 0:
            lidx[r] = t
    live = sorted({r for r, p in zip(rows, pos) if p >= 0})
    peft = {"method": "aot", "tables": tables,
            "task_ids": i32([slot_task[r] for r in rows])}

    def tick():
        cache = {n: c.clone() for n, c in cache0.items()}
        logits, cache = model.mixed_step(params, tokens, i32(rows), i32(pos),
                                         cache, peft, block_tables=bt,
                                         logit_idx=i32(lidx))
        torch.cuda.synchronize()
        return logits[live].float(), cache

    lg_k, cache_k = tick()
    with plain_ops():
        lg_p, cache_p = tick()
    err = (lg_k - lg_p).abs().max().item()
    same_tokens = torch.equal(lg_k.argmax(-1), lg_p.argmax(-1))
    kv_err = max((cache_k[n].float() - cache_p[n].float()).abs().max().item()
                 for n in ("k", "v"))
    ok = torch.allclose(lg_k, lg_p, atol=2e-2, rtol=2e-2) and same_tokens
    log("6 cross-check", layers=2, T=T, logits_max_abs_err=f"{err:.3e}",
        greedy_tokens="identical" if same_tokens else "DIFFER",
        kv_max_abs_err=f"{kv_err:.3e}")
    report["cross_check"] = dict(logits_max_abs_err=err,
                                 same_tokens=same_tokens, kv_max_abs_err=kv_err)
    if not ok:
        raise AssertionError("kernel and plain ticks disagree")
    cross_check_static(gen, report, model, params, tables)
    # preempt-and-recompute parity through the scheduler (reported only:
    # cuBLAS may round a row differently at another packed width)
    engine = ServeEngine(model, params, ServeConfig(max_len=256),
                         fused_tasks={"table": tables})
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(20, 121)))
             .astype(np.int32), int(rng.integers(0, 4)),
             int(rng.integers(24, 61))) for _ in range(6)]
    outs, preempts = [], []
    for num_blocks in (0, 17):          # 17: one max_len request + scratch
        sched = ContinuousScheduler(engine, SchedulerConfig(
            num_slots=4, block_size=BS, num_blocks=num_blocks,
            prefill_chunk=64, max_prefills=2))
        for i, (p, task, n) in enumerate(reqs):
            sched.submit(Request(rid=i, prompt=p, task_id=task,
                                 max_new_tokens=n))
        sched.run()
        outs.append([sched.finished[i].out for i in range(len(reqs))])
        preempts.append(sched.preemptions)
    same = outs[0] == outs[1]
    n_same = sum(a == b for a, b in zip(*outs))
    log("6 recompute parity", preemptions=preempts[1],
        streams_equal=f"{n_same}/{len(reqs)}", required="no")
    report["recompute_parity"] = dict(preemptions=preempts, equal=same,
                                      equal_requests=n_same)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the build and parity phases (a first "
                         "check of new kernel code; prints no result)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    # float32 matmuls in full float32 (no TF32), stated for the tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops      # noqa: F401 (fails if missing)
    t_start = time.perf_counter()
    card = smi()
    log("1 device", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())
    report = {"card": card, "parity": {}, "times": {}}
    report["build_s"], _ = phase_build(KERNEL_SOURCES)
    gen = torch.Generator(device=DEV).manual_seed(0)
    phase_parity(gen, report)
    if args.quick:
        print("[quick] stopped after parity; no result")
        return 0
    kernels = phase_times(gen, report)
    engine, setup_s = build_engine()
    launches = phase_main_path(report, engine, setup_s)
    launches.update(phase_whole_prompt(report, engine))
    launches.update(phase_static(report, engine))
    del engine
    torch.cuda.empty_cache()
    for row in kernels:     # each kernel's count on the path it serves
        row["launches"] = launches[MAIN_PATH[row["name"]]][row["name"]]
        row["launches_sampled"] = launches["paged_sampled"][row["name"]]
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in launches.items()}
        if row["launches"] < 1:
            raise AssertionError(f"{row['name']} never launched on "
                                 f"{MAIN_PATH[row['name']]}")
    phase_cross_check(gen, report)
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                        default=str))
    print(f"[done] seconds={report['seconds']:.1f}")
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
