#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py        # from the root of a checkout

Phases, each printing one line of results; any failure exits non-zero:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every CUDA source under src/repro_torch/kernels/csrc compiled by
   nvcc for sm_90a, one nvcc each, in parallel; each redesigned kernel
   instance's registers and spill bytes (none may spill): flash_mma_kernel,
   decode_split_kernel (contiguous and paged), ragged_split_kernel (the
   split walk and the token tile), aot_gather_add_kernel (both gather-adds
   with and without the fused norm, and the norm alone);
3. parity: each kernel's public wrapper against its plain PyTorch version
   on the card at smollm-360m's shapes (both gather-adds bitwise, the
   single-table one's NaN rows for ids outside [-V, V) included; fused
   with the norm, h_out bitwise and x within the tolerance below, the norm
   alone on the sum bitwise that x, the single-table and multi-task
   entries bitwise equal on the same rows; attention and norms within 2e-5
   in float32 and 2e-2 in bfloat16), for both the
   16-byte-load and the one-element-load build where a kernel has both:
   ragged paged attention (every packing of packings(), among them runs
   that the plan puts on the tensor cores: four chunks at unaligned
   offsets, runs of 1 and 5, a run across pages from position 27, a run
   ending at 1023, positions past the table, dead padding between runs; at
   pages of 16, 8 and 32, hd 60 / 64 / 128 and g 8; the decode_only packing
   bitwise equal to paged decode with cur_len = pos + 1); flash attention
   (causal, full, window; sq = skv
   in {1, 37, 100, 512, 577}, sq != skv either way, hd 32, 60, 96, 128,
   a strided q, a misaligned q, g 8; queries from an offset over sq +
   offset keys, P-Tuning v2's prefill, with and without a window);
   contiguous decode (scalar and per-row lengths with 0, 1 and ragged
   depths, S = 1024; lengths at and on either side of the cluster's block
   boundaries, 0 and S, at S 300, 1000, 1024, 2048); paged decode (length
   0, lengths that straddle pages, depth 1024; pages of 16, 8 and 32; and
   bitwise equal to contiguous decode over the same K/V wherever the
   capacities match: those lengths and every split case at pages of 4-32
   that divide S); and NaN in the K/V that nothing may read (past each
   row's length, scratch page 0) leaves contiguous, paged and ragged
   outputs bitwise as zeros there do, kernel and plain version alike;
4. kernel times at the serving paths' shapes (device time from
   torch.profiler), beside the plain version's, one PyTorch library call's
   where there is one, and the least time the card could take (bytes at
   3.35 TB/s, operations at the published peak); the fused gather-adds
   also beside the sequence they replace (the gather-add, then the norm as
   layers.apply_norm launches it), F.rms_norm alone, and host microseconds
   per wrapper call; flash also at one prompt of 512 (a whole-prompt
   stream's prefill); the ragged kernel's plan (host microseconds per
   tick, items);
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
   (Model.decode_step(block_tables=)). Generated tokens/s of each, and
   16 steps of the mixed batch under the profiler, contiguous and paged;
   in 5-5d every request must finish, every pool must drain clean, and
   each kernel must launch exactly 32 times per call that runs it (counts
   zeroed just before each run): on the AoT paths the fused gather-add +
   norm, elsewhere the norm alone (rms_norm);
5d. the paper's Fig. 3 comparison: 5c's prompts through one
   ServeEngine(peft=...) per method (bare backbone, one task's fused AoT
   tables through the single-table gather-add, BitFit, LoRA unfused and
   fused, adapters, P-Tuning v2): generated tokens/s and its ratio to the
   backbone's, kernels per step and device busy ms from a profiled run;
   the AoT engine's tokens must equal the multi-task engine's with every
   task id 0; then Model.logits at benchmarks/speed_overhead.py's grid,
   time ratios to the backbone's (reported, no limit);
5e. the faulted tick: phase 5's greedy stream fault-free (the twin), then
   F1 (an injected alloc_failure on one chunk tick and an exception raised
   after 16 layers of another: every stream bitwise the twin's, 2 faults,
   2 retries), F2 (NaN on one row of a decode-only tick: exactly that
   request quarantined, every survivor's tokens through that tick the
   twin's, shutdown releases the hold clean; whole streams reported),
   F3 (a seeded FaultPlan with every kind but crash, then shutdown with
   work live: drained, leak-free, every kind fired, the survivors the
   twin's requests less the disconnected, quarantined and shed; token
   equality reported); each run's kernels launch exactly 32 times per
   dispatch plus the layers a raised attempt reached;
6. cross-checks at full width with 2 layers, inputs drawn from a
   generator of their own (seed PHASE6_SEED; chip_seeds.py runs this phase
   at other seeds): one mixed tick, and a prefill plus three decode steps
   (for every method of 5d too), through the kernels and through the plain
   versions fed the kernels' tokens (every logit within the bf16
   tolerance, so a token that differs is a near tie; each line counts
   them); paged against contiguous decode steps from one prefill (same
   tokens); preempt-and-recompute parity is reported.

The last two lines are a JSON line of per-kernel numbers (``launches``:
the count on the path each kernel serves; ``launches_by_path``: every
path's) and ``{"ok": true, "device": {...}}``. Details go to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from statistics import median

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
PROFILE_ATTEMPTS = 3               # traces device_ms takes at most
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
    (torch.profiler, CUPTI). Every call launches at least one kernel, so a
    trace that holds fewer kernels than calls lost records and is taken
    again, up to ``PROFILE_ATTEMPTS`` traces; raises if none is whole or
    none holds kernel time. Unlike wall_ms, host time between launches does
    not count."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        us, kernels = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us += getattr(e, "self_device_time_total", 0.0) or 0.0
                kernels += e.count
        if kernels >= iters:
            break
    else:
        raise RuntimeError(f"torch.profiler recorded {kernels} kernels for "
                           f"{iters} calls in each of {PROFILE_ATTEMPTS} "
                           "traces")
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
    # the ragged kernel's plan: runs of one slot at consecutive positions
    # go onto the tensor cores in tiles of 16, other tokens walk alone.
    # Four chunks of unequal lengths at token offsets 4, 41, 111, 120
    # after four decode tokens (the multi-prefill budget split), dead
    # padding to 263
    rows, pos = [4, 5, 6, 7], [17, 300, 64, 1021]
    for slot, lo, n in ((0, 100, 37), (1, 0, 70), (2, 500, 9), (3, 883, 140)):
        rows += [slot] * n
        pos += list(range(lo, lo + n))
    out["four_chunks_unaligned"] = (rows + [0] * (263 - len(rows)),
                                    pos + [-1] * (263 - len(pos)))
    # a run of 1 token and a run of 5 between decode tokens
    out["runs_1_and_5"] = ([0, 1, 2, 2, 2, 2, 2, 3, 4],
                           [40, 77, 200, 201, 202, 203, 204, 9, 640])
    # a run that crosses pages, starting at position 27 (not a multiple of
    # 16) at token offset 3
    out["run_crosses_page_unaligned"] = ([0, 1, 2] + [3] * 34,
                                         [5, 16, 700] + list(range(27, 61)))
    # a run ending at 1023, the table's last position
    out["run_ends_1023"] = ([1] + [6] * 24, [3] + list(range(1000, 1024)))
    # positions past the table (1024 of 1024): a run across the end, and a
    # single token far past it; each sees the whole table
    out["past_table"] = ([7] * 11 + [2, 0], list(range(1020, 1031))
                         + [1500, 12])
    # dead padding between runs, the same slot on either side
    out["dead_between_runs"] = ([0] * 20 + [0] * 5 + [0] * 10 + [0] * 3
                                + [1] * 3,
                                list(range(20)) + [-1] * 5
                                + list(range(20, 30)) + [-1] * 3
                                + [50, 51, 52])
    return out


def misaligned(x):
    """A contiguous copy of x whose data starts one element past a 16-byte
    boundary, so that the kernels take their one-element (not 16-byte)
    loads."""
    y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    y = y.view(x.shape).copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    return y


def ragged_inputs(gen, rows, pos, dtype, layers=1, hd=HD, bs=BS,
                  heads=(H, KVH)):
    """q (T, h, hd), K/V pools (layers, blocks, bs, kvh, hd) of SLOTS slots
    of MAX_LEN positions in pages of bs, scrambled block tables, and the
    token indices, on the card."""
    dev, T, (h, kvh) = DEV, len(rows), heads
    npages = MAX_LEN // bs
    blocks = SLOTS * npages + 1
    q = torch.randn(T, h, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(layers, blocks, bs, kvh, hd, generator=gen,
                    device=dev).to(dtype)
    v = torch.randn(layers, blocks, bs, kvh, hd, generator=gen,
                    device=dev).to(dtype)
    perm = torch.randperm(blocks - 1, generator=gen, device=dev) + 1
    bt = perm.view(SLOTS, npages).to(torch.int32)
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

def ptxas_kernels(out):
    """{mangled kernel name: (registers, spill bytes stored + loaded)} from
    nvcc's ``-Xptxas -v`` output."""
    kernels, name = {}, None
    for ln in out.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for")[-1].strip()
        elif name and "spill stores" in ln:
            spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill", ln))
            kernels[name] = (0, spill)
        elif name and "Used" in ln and "registers" in ln:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            kernels[name] = (regs, kernels.get(name, (0, 0))[1])
            name = None
    return kernels


# the tensor-core flash, the cluster decode (contiguous and paged), the
# ragged (split walk and token tile) and the gather-add (with and without
# the fused norm, and the norm alone) kernels, by source: phase 2 lists each
# of their instances' registers and spill bytes (none may spill)
REDESIGNED = {"flash_mma_kernel": "flash_attention",
              "decode_split_kernel": "decode_attention",
              "ragged_split_kernel": "decode_attention",
              "aot_gather_add_kernel": "aot_gather_add"}


def redesigned(logs):
    """{kernel of REDESIGNED: ["<template arguments>:<registers>r/<spill
    bytes>s", ...]} from each source's ``-Xptxas -v`` output in ``logs``.
    Raises if an instance spills, or if a source compiled in this run (not
    ``"cached"``) lacks its kernel."""
    new, spilled = {}, []
    for out in logs.values():
        for fn, (r, sp) in ptxas_kernels(out).items():
            for base in REDESIGNED:
                if base in fn:      # template arguments, mangled
                    args = fn.split(base, 1)[1].split("EEv")[0] + "E"
                    new.setdefault(base, []).append(f"{args}:{r}r/{sp}s")
                    if sp > 0:
                        spilled.append(fn)
    missing = [base for base, src in REDESIGNED.items()
               if logs.get(src, "cached") != "cached" and base not in new]
    if spilled or missing:
        raise AssertionError(f"redesigned kernel instances spill {spilled} "
                             f"or are missing from ptxas's output {missing}")
    return new


def phase_build(names):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build(names)
    sec = time.perf_counter() - t0
    regs = []
    for name, out in logs.items():
        found = ptxas_kernels(out)
        spill = sum(sp for _, sp in found.values())
        regs.append(f"{name}:{len(found)} kernels, spill bytes {spill}"
                    if found else f"{name}:{out.strip()[:40]}")
    log("2 build", seconds=f"{sec:.1f}", arch="sm_90a",
        sources=",".join(f"{n}.cu" for n in names), ptxas="|".join(regs))
    found = redesigned(logs)
    for base, inst in sorted(found.items()):
        log("2 build", redesigned=base, instances=len(inst),
            registers_spill_bytes=",".join(sorted(inst)))
    return sec, found


def norm_scale(gen, d):
    """A random RMSNorm scale (d,) float32 whose values bf16 holds exactly
    (so that F.rms_norm with a bf16 weight computes the same function)."""
    return (1 + 0.1 * torch.randn(d, generator=gen, device=DEV)).to(
        torch.bfloat16).float()


EPS = 1e-6          # smollm-360m's norm_eps


def check_norm(what, x, want, dtype, report):
    """A fused norm's output against the plain norm's at TOL[dtype], NaN
    rows in the same places. Returns the max abs error over the rest."""
    torch.cuda.synchronize()
    a, b = x.float(), want.float()
    err = (a - b).nan_to_num().abs().max().item()
    report["parity"][what] = err
    if not torch.allclose(a, b, atol=TOL[dtype], rtol=TOL[dtype],
                          equal_nan=True):
        raise AssertionError(f"{what}: max abs err {err} over tol "
                             f"{TOL[dtype]} (or NaN rows differ)")
    return err


def check_fused(what, fused, plain_out, h, scale, report):
    """The fused gather-add + norm's (h_out, x) against the plain sum
    ``plain_out``: h_out bitwise (NaN rows equal), x within TOL of the
    plain norm, and the norm alone (ops.rms_norm) on the sum, in the build
    h took (an input with h's alignment), bitwise that x. Returns x's max
    abs error."""
    from repro_torch.kernels import aot_bias, ops
    h_out, x = fused
    torch.cuda.synchronize()
    if not torch.allclose(h_out, plain_out, rtol=0, atol=0, equal_nan=True):
        raise AssertionError(f"{what}: h_out not bitwise the plain sum")
    err = check_norm(what, x, aot_bias.rms_norm_plain(plain_out, scale, EPS),
                     h.dtype, report)
    same_build = plain_out if h.data_ptr() % 16 == 0 else misaligned(plain_out)
    alone = ops.rms_norm(same_build, scale, EPS)
    torch.cuda.synchronize()
    if not torch.allclose(alone, x, rtol=0, atol=0, equal_nan=True):
        raise AssertionError(f"{what}: rms_norm of the sum is not bitwise "
                             "the fused x")
    return err


def phase_parity(gen, report):
    """Each kernel through its public wrapper (kernels.ops) against its
    plain version. Every kernel has a 16-byte-load build and a
    one-element-load build, picked by width and alignment; the "scalar"
    cases (a width not a multiple of 8, or data one element off a 16-byte
    boundary) hold the second against the plain version too."""
    from repro_torch.kernels import aot_bias, decode_attention, ops
    cases = {"vec": 0, "scalar": 0}
    norm_err, same_rows = {}, 0

    def check_gather(h, tables, task, ids, what):
        out = ops.aot_gather_add_multitask(h, tables, task, ids)
        plain = aot_bias.aot_gather_add_multitask_plain(h, tables, task, ids)
        torch.cuda.synchronize()
        what = f"gather-add {what} h={h.dtype} table={tables.dtype} " \
               f"T={h.shape[0]}"
        if not torch.equal(out, plain):
            raise AssertionError(
                f"{what} not bitwise equal: max err "
                f"{(out.float() - plain.float()).abs().max().item()}")
        scale = norm_scale(gen, h.shape[1])
        fused = ops.aot_gather_add_multitask(h, tables, task, ids,
                                             norm=(scale, EPS))
        err = check_fused(what + " +norm", fused, plain, h, scale, report)
        key = str(h.dtype)[6:]
        norm_err[key] = max(norm_err.get(key, 0.0), err)

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
            same_rows += single_vs_multitask(gen, h, tables, ids[0])
            check_gather(misaligned(h), tables, tasks[0], ids[0],
                         "scalar/misaligned h")
            h, tasks, ids = gather_inputs(gen, 263, h_dtype, odd)
            check_gather(h, odd, tasks[0], ids[0], "scalar/d 962")
            cases["scalar"] += 2
        del tables, odd
    log("3 parity", kernel="aot_gather_add_multitask",
        cases=f"{cases['vec']} vec + {cases['scalar']} scalar",
        result="h_out bitwise equal (with and without the norm)",
        norm_max_abs_err=",".join(f"{k}:{e:.2e}"
                                  for k, e in norm_err.items()),
        rms_norm="bitwise the fused x in every case",
        single_vs_multitask_norm=f"bitwise in {same_rows} cases",
        tables="4x49152x960 (vec, misaligned h), 4x4096x962 (d%8!=0)",
        types="{f32,bf16}^2", T="8,263")
    parity_single_gather(gen, report)

    parity_ragged(gen, report)
    parity_flash(gen, report)
    parity_decode(gen, report)
    parity_stale_nan(gen, report)


# ragged and paged parity builds: name -> (hd, data one element off a
# 16-byte boundary, (h, kvh)); each at every page size of PARITY_BS
PARITY_VARIANTS = {"vec": (HD, False, (H, KVH)),
                   "vec_hd128": (128, False, (H, KVH)),
                   "scalar_hd60": (60, False, (H, KVH)),
                   "scalar_misaligned": (HD, True, (H, KVH)),
                   "vec_g8": (HD, False, (8, 1))}
PARITY_BS = (16, 8, 32)


def parity_ragged(gen, report):
    """Ragged attention against its plain version on every packing, in
    float32 and bf16, at every build of PARITY_VARIANTS and page size of
    PARITY_BS (the plan built by the wrapper from the indices); dead tokens
    must be exact zeros; and the decode_only packing bitwise equal to paged
    decode of the same tokens with cur_len = pos + 1."""
    from repro_torch.kernels import decode_attention, ops
    for variant, (hd, shift, heads) in PARITY_VARIANTS.items():
        for bs in PARITY_BS:
            rcases, bitwise = [], 0
            for name, (rows, pos) in packings().items():
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v, bt, r, p = ragged_inputs(gen, rows, pos, dtype,
                                                      hd=hd, bs=bs,
                                                      heads=heads)
                    k, v = k[0], v[0]
                    if shift:
                        k, v = misaligned(k), misaligned(v)
                    out = ops.ragged_paged_attention(q, k, v, bt, r, p)
                    plain = decode_attention.ragged_paged_attention_plain(
                        q, k, v, bt, r, p)
                    what = f"ragged/{variant}/bs{bs}/{name}/{dtype}"
                    err = check_close(what, out, plain, dtype, report, p < 0)
                    rcases.append(f"{name}/{str(dtype)[6:]}:{err:.2e}")
                    if name == "decode_only":
                        paged = ops.paged_decode_attention(
                            q, k, v, bt[r.long()].contiguous(), p + 1)
                        torch.cuda.synchronize()
                        if not torch.equal(out, paged):
                            raise AssertionError(
                                f"{what}: not bitwise equal to paged decode "
                                f"with cur_len = pos + 1 (max abs diff "
                                f"{(out.float() - paged.float()).abs().max()})")
                        bitwise += 1
            log("3 parity", kernel="ragged_paged_attention", variant=variant,
                bs=bs, shapes=f"h{heads[0]} kvh{heads[1]} hd{hd} "
                f"depth<=1024", bitwise_vs_paged=f"{bitwise}/2",
                max_abs_err=",".join(rcases))


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


def single_vs_multitask(gen, h, tables, ids):
    """The single-table and the multi-task fused entries on the same rows
    (task 1's table, in-range ids) give bitwise the same (h_out, x), as
    phase 5d's token gate needs. Returns the number of cases (1)."""
    from repro_torch.kernels import ops
    ids = ids.clamp(0, tables.shape[1] - 1)
    norm = (norm_scale(gen, h.shape[1]), EPS)
    single = ops.aot_gather_add(h, tables[1], ids, norm=norm)
    multi = ops.aot_gather_add_multitask(h, tables, torch.ones_like(ids),
                                         ids, norm=norm)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(single, multi)):
        raise AssertionError(f"single-table and multi-task norm modes differ "
                             f"(h {h.dtype}, table {tables.dtype}, "
                             f"T {h.shape[0]})")
    return 1


def parity_single_gather(gen, report):
    """The single-table gather-add (one task's fused AoT tables) against
    its plain version, bitwise with NaN rows equal: ids include -1 and -V
    (wrap once) and V, V + 5, -V - 1 (NaN rows, jnp.take's fill); the
    16-byte build at d 960 and the one-element build at d 60 and with h
    one element off a 16-byte boundary; f32 and bf16 h and tables."""
    from repro_torch.kernels import aot_bias, ops
    cases, nan_rows, norm_err = [], 0, {}
    for t_dtype in (torch.bfloat16, torch.float32):
        for vocab, d in ((49152, 960), (4096, 60)):
            table = (torch.randn(vocab, d, generator=gen, device=DEV)
                     * 0.03).to(t_dtype)
            for h_dtype in (torch.bfloat16, torch.float32):
                for T in (16, 263):
                    h = torch.randn(T, d, generator=gen,
                                    device=DEV).to(h_dtype)
                    ids = torch.randint(0, vocab, (T,), generator=gen,
                                        device=DEV, dtype=torch.int32)
                    ids[:6] = torch.tensor([-1, -vocab, vocab, vocab + 5,
                                            -vocab - 1, vocab - 1])
                    variants = {"vec" if d % 8 == 0 else "scalar_d60": h}
                    if d % 8 == 0:
                        variants["scalar_misaligned"] = misaligned(h)
                    for variant, hh in variants.items():
                        out = ops.aot_gather_add(hh, table, ids)
                        plain = aot_bias.aot_gather_add_plain(hh, table, ids)
                        torch.cuda.synchronize()
                        what = (f"single gather-add {variant} h={h_dtype} "
                                f"table={t_dtype} T={T} d={d}")
                        if not torch.allclose(out, plain, rtol=0, atol=0,
                                              equal_nan=True):
                            raise AssertionError(f"{what}: not bitwise equal")
                        nan = out.isnan().all(dim=1)
                        if nan.tolist()[:6] != [False] * 2 + [True] * 3 + [
                                False] or int(nan.sum()) != 3:
                            raise AssertionError(f"{what}: NaN rows "
                                                 f"{nan.nonzero().tolist()}")
                        nan_rows += 3
                        cases.append(variant)
                        scale = norm_scale(gen, d)
                        fused = ops.aot_gather_add(hh, table, ids,
                                                   norm=(scale, EPS))
                        err = check_fused(what + " +norm", fused, plain, hh,
                                          scale, report)
                        if not fused[1].isnan().all(dim=1).equal(nan):
                            raise AssertionError(f"{what}: x's NaN rows "
                                                 "are not h_out's")
                        key = str(h_dtype)[6:]
                        norm_err[key] = max(norm_err.get(key, 0.0), err)
            del table
    report["parity"]["aot_gather_add"] = dict(cases=len(cases),
                                              nan_rows=nan_rows,
                                              norm_max_abs_err=norm_err)
    log("3 parity", kernel="aot_gather_add", cases=len(cases),
        builds=",".join(sorted(set(cases))),
        result="h_out bitwise equal (with and without the norm)",
        norm_max_abs_err=",".join(f"{k}:{e:.2e}"
                                  for k, e in norm_err.items()),
        rms_norm="bitwise the fused x in every case",
        nan_rows=f"{nan_rows} (ids V, V+5, -V-1)",
        tables="49152x960, 4096x60", types="{f32,bf16}^2", T="16,263")


# flash parity cases: name -> (b, sq, skv, hd, causal, window, strided,
# heads, misaligned); smollm's heads (15 over 5) unless a case names
# others. The bf16 kernel's edges: query tiles of 64 (sq 100, 577), kv
# tiles of 64 past either end, hd padded to 64 (hd 32, 60) or 128 (hd 96,
# 128), the element-load build (hd 60, a misaligned q), a strided q
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
    "full_100": (2, 100, 100, HD, False, 0, False),
    "causal_577": (1, 577, 577, HD, True, 0, False),
    "causal_sq577_skv300": (1, 577, 300, HD, True, 0, False),
    "causal_sq300_skv577": (1, 300, 577, HD, True, 0, False),
    "full_sq577_skv100": (1, 577, 100, HD, False, 0, False),
    "window100_577": (1, 577, 577, HD, True, 100, False),
    "causal_hd32": (2, 100, 100, 32, True, 0, False),
    "causal_hd96": (2, 100, 100, 96, True, 0, False),
    "causal_hd60_577": (1, 577, 577, 60, True, 0, False),
    "causal_hd128_577": (1, 577, 577, 128, True, 0, False),
    "causal_strided_q_577": (1, 577, 577, HD, True, 0, True),
    "causal_misaligned_100": (2, 100, 100, HD, True, 0, False, (H, KVH),
                              True),
    "causal_g8_577": (1, 577, 577, HD, True, 0, False, (8, 1)),
}


# queries from an offset (P-Tuning v2's prefill: sq prompt queries at
# positions q_offset.. over the prefix and the prompt, skv = q_offset + sq):
# name -> (b, sq, q_offset, window)
FLASH_OFFSET_CASES = {
    "offset20_37": (2, 37, 20, 0),
    "offset37_100": (2, 100, 37, 0),
    "offset20_512": (1, 512, 20, 0),
    "offset20_window16": (2, 100, 20, 16),
    "offset37_window64_512": (1, 512, 37, 64),
    "offset37_window100_577": (1, 577, 37, 100),
}


def flash_inputs(gen, b, sq, skv, hd, dtype, strided=False,
                 heads=(H, KVH), shift=False):
    """q (b, sq, h, hd), k and v (b, skv, kvh, hd); ``strided`` gives q as
    a view with wider head and sequence strides (the kernel reads
    strides); ``shift`` starts all three one element past a 16-byte
    boundary (the element-load build)."""
    h, kvh = heads
    rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                     device=DEV).to(dtype)
    q = rnd(b, sq, h, 2 * hd)[..., :hd] if strided else rnd(b, sq, h, hd)
    k, v = rnd(b, skv, kvh, hd), rnd(b, skv, kvh, hd)
    if shift:
        q, k, v = misaligned(q), misaligned(k), misaligned(v)
    return q, k, v


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
    for name, (b, sq, off, window) in FLASH_OFFSET_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(gen, b, sq, sq + off, HD, dtype)
            out = ops.flash_attention(q, k, v, causal=True, window=window,
                                      q_offset=off)
            plain = flash_attention.flash_attention_plain(
                q, k, v, causal=True, window=window, q_offset=off)
            err = check_close(f"flash/{name}/{dtype}", out, plain, dtype,
                              report)
            cases.append(f"{name}/{str(dtype)[6:]}:{err:.2e}")
    log("3 parity", kernel="flash_attention",
        shapes="h15 kvh5 hd32|60|64|96|128, h8 kvh1 hd64; sq 1-577; "
        "q_offset 20|37", max_abs_err=",".join(cases))


DECODE_LENS = [0, 1, 33, 255, 256, 577, 1000, 1024]   # per row, S = 1024
# the contiguous kernel's cluster split (decode_split): S -> per-row
# lengths at and on either side of a block boundary (chunk = ceil(S /
# split): 256 at S 1024 and 2048, 250 at S 1000, 150 at S 300), 0 and S
SPLIT_LENS = {1024: [0, 255, 256, 257, 1024, 1, 511, 769],
              1000: [0, 249, 250, 251, 1000, 1, 749, 751],
              2048: [0, 255, 256, 257, 2048, 1, 1791, 1793],
              300: [0, 149, 150, 151, 300, 1, 299, 64]}
PAGED_LENS = [0, 1, 15, 16, 17, 300, 1000, 1024]      # 8 slots, pages of 16


def decode_inputs(gen, lens, dtype, hd=HD, layers=1, S=MAX_LEN,
                  heads=(H, KVH)):
    b, (h, kvh) = len(lens), heads
    rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                     device=DEV).to(dtype)
    q = rnd(b, h, hd)
    k, v = rnd(layers, b, S, kvh, hd), rnd(layers, b, S, kvh, hd)
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=DEV)


def paged_copy(gen, k, v, bs, shift):
    """A contiguous cache (b, S, kvh, hd) as a paged pool: pages of bs in a
    scrambled order after scratch page 0, and the (b, S / bs) tables that
    map them. ``shift`` puts the pool one element off a 16-byte
    boundary."""
    b, S, kvh, hd = k.shape
    npages = S // bs
    perm = torch.randperm(b * npages, generator=gen, device=DEV)
    pools = []
    for x in (k, v):
        pool = torch.zeros(b * npages + 1, bs, kvh, hd, dtype=x.dtype,
                           device=DEV)
        pool[perm + 1] = x.reshape(b * npages, bs, kvh, hd)
        pools.append(misaligned(pool) if shift else pool)
    bt = (perm + 1).view(b, npages).to(torch.int32)
    return pools[0], pools[1], bt


def paged_vs_contiguous(gen, dtype, hd, shift, heads):
    """Paged decode over the pages of a contiguous cache against contiguous
    decode of that cache, bitwise: at PAGED_LENS over S 1024 and at every
    SPLIT_LENS case, at every page size of 4, 8, 16, 32 that divides S (the
    capacities match, so the split walks see the same ranges and tiles).
    Returns the number of cases."""
    from repro_torch.kernels import ops
    cases = 0
    for S, lens in [(MAX_LEN, PAGED_LENS)] + list(SPLIT_LENS.items()):
        q, k, v, cur = decode_inputs(gen, lens, dtype, hd, S=S, heads=heads)
        k, v = k[0], v[0]
        kc, vc = (misaligned(k), misaligned(v)) if shift else (k, v)
        want = ops.decode_attention(q, kc, vc, cur)
        for bs in (4, 8, 16, 32):
            if S % bs:
                continue
            kp, vp, bt = paged_copy(gen, k, v, bs, shift)
            got = ops.paged_decode_attention(q, kp, vp, bt, cur)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"paged decode S {S} bs {bs} hd {hd} {dtype} is not "
                    f"bitwise contiguous decode: max abs diff "
                    f"{(got.float() - want.float()).abs().max().item()}")
            cases += 1
    return cases


def parity_decode(gen, report):
    """The contiguous and the paged decode kernel, each through its 16-byte
    load build (hd 64 or 128, aligned) and its one-element build (hd 60, or
    data one element off a 16-byte boundary), at smollm's heads and at the
    kernels' most query heads per KV head (8); paged decode at pages of 16,
    8 and 32, and bitwise against contiguous decode over the same K/V."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    for variant, (hd, shift, heads) in PARITY_VARIANTS.items():
        cases, bitwise = [], 0
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
            for S, slens in SPLIT_LENS.items():
                sq_, sk, sv, scur = decode_inputs(gen, slens, dtype, hd,
                                                  S=S, heads=heads)
                sk, sv = sk[0], sv[0]
                if shift:
                    sk, sv = misaligned(sk), misaligned(sv)
                out = ops.decode_attention(sq_, sk, sv, scur)
                plain = da.decode_attention_plain(sq_, sk, sv, scur)
                err = check_close(f"decode/{variant}/split_S{S}/{dtype}",
                                  out, plain, dtype, report, scur <= 0)
                cases.append(f"split_S{S}/{str(dtype)[6:]}:{err:.2e}")
            # paged: scrambled pages over 8 slots of 1024 tokens
            plens = torch.tensor(PAGED_LENS, dtype=torch.int32, device=DEV)
            for bs in PARITY_BS:
                npages = MAX_LEN // bs
                kp = torch.randn(SLOTS * npages + 1, bs, kvh, hd,
                                 generator=gen, device=DEV).to(dtype)
                vp = torch.randn(SLOTS * npages + 1, bs, kvh, hd,
                                 generator=gen, device=DEV).to(dtype)
                if shift:
                    kp, vp = misaligned(kp), misaligned(vp)
                perm = torch.randperm(SLOTS * npages, generator=gen,
                                      device=DEV) + 1
                bt = perm.view(SLOTS, npages).to(torch.int32)
                out = ops.paged_decode_attention(q, kp, vp, bt, plens)
                plain = da.paged_decode_attention_plain(q, kp, vp, bt, plens)
                err = check_close(f"paged_decode/{variant}/bs{bs}/{dtype}",
                                  out, plain, dtype, report, plens <= 0)
                cases.append(f"paged_bs{bs}/{str(dtype)[6:]}:{err:.2e}")
            bitwise += paged_vs_contiguous(gen, dtype, hd, shift, heads)
        log("3 parity", kernel="decode_attention+paged_decode_attention",
            variant=variant,
            shapes=f"b8 h{heads[0]} kvh{kvh} hd{hd} S300-2048 bs8|16|32",
            paged_bitwise_contiguous=f"{bitwise} cases",
            max_abs_err=",".join(cases))


def poison_past(pool, bt, depth, bs, fill):
    """A copy of a paged pool (blocks, bs, kvh, hd) with ``fill`` on
    scratch page 0 and at every position at or past each row's depth
    (rows of ``bt``: (rows, npages) tables of distinct pages)."""
    npages = bt.shape[1]
    pos = torch.arange(npages * bs, device=DEV).view(npages, bs)
    past = torch.zeros(pool.shape[:2], dtype=torch.bool, device=DEV)
    past[0] = True
    for r in range(bt.shape[0]):
        past[bt[r].long()] = pos >= int(depth[r])
    return torch.where(past[:, :, None, None],
                       torch.full_like(pool, fill), pool)


def parity_stale_nan(gen, report):
    """K/V that nothing may read (past each row's length, scratch page 0)
    set to NaN give bitwise the output of zeros there, through each
    kernel and through its plain version (a retried tick and
    released quarantine pages leave stale rows behind). Contiguous and
    paged decode at DECODE_LENS / PAGED_LENS, ragged attention on three
    packings with chunks, decode tokens and dead padding; f32 and bf16."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    nan = float("nan")
    cases = []

    def same(what, fn):
        outs = [fn(fill) for fill in (0.0, nan)]
        torch.cuda.synchronize()
        for fill, (k_out, p_out) in zip(("0", "nan"), outs):
            if not (torch.isfinite(k_out).all()
                    and torch.isfinite(p_out).all()):
                raise AssertionError(f"{what} fill {fill}: non-finite output")
        if not (torch.equal(outs[0][0], outs[1][0])
                and torch.equal(outs[0][1], outs[1][1])):
            raise AssertionError(f"{what}: NaN past the length changed the "
                                 "output (kernel or plain)")
        report["parity"][f"stale_nan/{what}"] = "bitwise"
        cases.append(what)

    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, lens = decode_inputs(gen, DECODE_LENS, dtype)
        k, v = k[0], v[0]
        past = (torch.arange(MAX_LEN, device=DEV)[None, :]
                >= lens[:, None])[:, :, None, None]

        def contiguous(fill):
            kk = torch.where(past, torch.full_like(k, fill), k)
            vv = torch.where(past, torch.full_like(v, fill), v)
            return (ops.decode_attention(q, kk, vv, lens),
                    da.decode_attention_plain(q, kk, vv, lens))
        same(f"decode/{str(dtype)[6:]}", contiguous)
        plens = torch.tensor(PAGED_LENS, dtype=torch.int32, device=DEV)
        kp, vp, bt = paged_copy(gen, k, v, BS, False)
        bt[0, 1:] = 0                   # unmapped entries point at page 0

        def paged(fill):
            kk = poison_past(kp, bt, PAGED_LENS, BS, fill)
            vv = poison_past(vp, bt, PAGED_LENS, BS, fill)
            return (ops.paged_decode_attention(q, kk, vv, bt, plens),
                    da.paged_decode_attention_plain(q, kk, vv, bt, plens))
        same(f"paged_decode/{str(dtype)[6:]}", paged)
        for name in ("decode_only", "chunks_decode_dead",
                     "four_chunks_unaligned"):
            rows, pos = packings()[name]
            q_r, k_r, v_r, bt_r, r, p = ragged_inputs(gen, rows, pos, dtype)
            depth = [0] * SLOTS
            for row, at in zip(rows, pos):
                depth[row] = max(depth[row], at + 1)

            def ragged(fill):
                kk = poison_past(k_r[0], bt_r, depth, BS, fill)
                vv = poison_past(v_r[0], bt_r, depth, BS, fill)
                return (ops.ragged_paged_attention(q_r, kk, vv, bt_r, r, p),
                        da.ragged_paged_attention_plain(q_r, kk, vv, bt_r,
                                                        r, p))
            same(f"ragged/{name}/{str(dtype)[6:]}", ragged)
    log("3 parity", kernel="decode+paged_decode+ragged (stale NaN)",
        result="kernel and plain bitwise unchanged by NaN past each row's "
        "length and on page 0", cases=len(cases))


def flat(res):
    """A kernel's output, or all its outputs (the fused gather-add's
    (h_out, x)) end to end, as one float32 vector."""
    parts = res if isinstance(res, tuple) else (res,)
    return torch.cat([x.float().flatten() for x in parts])


def timed(kern, plain, iters, plain_iters, tol):
    """A kernel's wrapper and its plain version on the same inputs: device
    time per call (``ms``, profiler), wall time per call back to back
    (``wall_ms``, CUDA events, host launch overhead included), their max
    abs difference over every output, which must be within tol (0: bitwise
    equal), and the share of output elements that differ at all
    (``differ``: in bf16, one ulp of rounding apart for most)."""
    res = dict(ms=device_ms(kern, iters),
               plain_ms=device_ms(plain, plain_iters),
               wall_ms=wall_ms(kern, iters),
               plain_wall_ms=wall_ms(plain, plain_iters))
    a, b = flat(kern(0)), flat(plain(0))
    res["err"] = (a - b).abs().max().item()
    res["differ"] = (a != b).float().mean().item()
    ok = (torch.equal(a, b) if tol == 0
          else torch.allclose(a, b, atol=tol, rtol=tol))
    if not ok:
        raise AssertionError(f"timed kernel disagrees with its plain "
                             f"version: max abs err {res['err']}, tol {tol}")
    return res


def fmt_times(r) -> str:
    return (f"{r['ms']:.5f}ms(wall {r['wall_ms']:.4f}; plain "
            f"{r['plain_ms']:.4f}, wall {r['plain_wall_ms']:.4f}; bound "
            f"{r['bound_ms']:.5f}; err {r['err']:.2e}; differ "
            f"{r['differ']:.5f})")


def phase_times(gen, report):
    """Each kernel at the serving tick's shapes (bf16, a 256-token chunk
    plus 7 decode rows: T = 263), inputs rotated so L2 cannot serve
    repeated launches: 8 id sets for the gather-add, 32 pool layers for the
    attention (one per model layer, as the tick walks them)."""
    from repro_torch.kernels import aot_bias, decode_attention, ops
    rows_out = times_single_gather(gen, report)
    dt = torch.bfloat16
    # ---- gather-add fused with the norm: the serving tick (T 263) and a
    # decode tick (T 8)
    tables = (torch.randn(4, 49152, 960, generator=gen, device=DEV)
              * 0.03).to(dt)
    res = {}
    for T in (263, 8):
        h, tasks, ids = gather_inputs(gen, T, dt, tables, sets=8)
        args = lambda i: (h, tables, tasks[i % 8], ids[i % 8])
        res[T] = times_gather_norm(
            gen, h, lambda i, **kw: ops.aot_gather_add_multitask(*args(i),
                                                                 **kw),
            lambda i, **kw: aot_bias.aot_gather_add_multitask_plain(
                *args(i), **kw), 200)
    del tables
    report["times"]["aot_gather_add_multitask"] = res
    log("4 times", kernel="aot_gather_add_multitask", fused="norm",
        **{f"T{T}": fmt_gather_norm(r) for T, r in res.items()})
    rows_out.insert(1, gather_row("aot_gather_add_multitask",
                                  "src/repro/kernels/aot_bias.py:56",
                                  res[263]))
    # ---- ragged attention
    pk = packings()
    res = {}
    for name in ("chunk256_decode", "decode_only"):
        rows, pos = pk[name]
        q, k, v, bt, r, p = ragged_inputs(gen, rows, pos, dt, layers=32)
        # the plan, as the tick builds it on the host and uploads it
        rows_np = np.asarray(rows, np.int32)
        pos_np = np.asarray(pos, np.int32)
        t0 = time.perf_counter()
        for _ in range(1000):
            plan_np = decode_attention.ragged_plan(rows_np, pos_np)
        plan_us = (time.perf_counter() - t0) * 1e3
        plan = torch.from_numpy(plan_np).to(DEV)
        kern = lambda i: ops.ragged_paged_attention(q, k[i % 32], v[i % 32],
                                                    bt, r, p, plan)
        plain = lambda i: decode_attention.ragged_paged_attention_plain(
            q, k[i % 32], v[i % 32], bt, r, p)
        res[name] = timed(kern, plain, 64, 16, tol=TOL[dt])
        res[name]["bound_ms"], res[name]["bound_by"] = ragged_bound(rows, pos,
                                                                    dt)
        res[name]["T"] = len(rows)
        res[name]["plan_host_us"] = plan_us
        res[name]["plan_items"] = int(plan_np.shape[0])
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
        **{n: fmt_times(r) + f"[{r['bound_by']}, T{r['T']}, "
           f"{r['plan_items']} plan items, plan host "
           f"{r['plan_host_us']:.1f}us]" for n, r in res.items()})
    report["times"]["ragged_paged_attention"] = res
    rows_out += times_prefill_decode(gen, report)
    return rows_out


def times_gather_norm(gen, h, call, plain_call, iters):
    """The fused gather-add + norm ``call(i, norm=...)`` (the gather-add
    alone without ``norm``) at h's shape, bf16: device and wall time
    against its plain version ``plain_call`` (h_out bitwise, x within
    TOL); the sequence
    it replaces, the gather-add kernel then the plain norm (what
    ``layers.apply_norm`` launches), timed beside it; F.rms_norm alone on
    the summed h (a yardstick for the norm's half); at T <= HOST_T, host
    microseconds per call by perf_counter (the enqueue, no wait) of the
    fused wrapper, the gather-add wrapper alone and the replaced sequence
    (at larger T the device, not the host, would set the pace); the bound:
    bytes, h and a table row read, h_out and x written, the ids and the
    scale read once."""
    import torch.nn.functional as F
    from repro_torch.kernels import aot_bias
    T, d = h.shape
    norm = (norm_scale(gen, d), EPS)
    kern = lambda i: call(i, norm=norm)
    plain = lambda i: plain_call(i, norm=norm)
    seq = lambda i: aot_bias.rms_norm_plain(call(i), *norm)
    res = timed(kern, plain, iters, iters // 4, tol=TOL[h.dtype])
    if not torch.equal(kern(0)[0], plain(0)[0]):
        raise AssertionError(f"fused gather-add T {T}: h_out not bitwise "
                             "the plain sum")
    res["replaced_ms"] = device_ms(seq, iters)
    res["replaced_wall_ms"] = wall_ms(seq, iters)
    summed = call(0)
    w = norm[0].to(h.dtype)
    res["library_norm_ms"] = device_ms(      # yardstick only
        lambda i: F.rms_norm(summed, (d,), w, EPS), iters)
    res["host_us"] = {name: host_us(fn) for name, fn in (
        ("fused", kern), ("gather_add_alone", lambda i: call(i)),
        ("replaced", seq))} if T <= HOST_T else None
    es = h.element_size()
    res["bound_ms"] = max((4 * T * d * es + 8 * T + 4 * d) / HBM_BYTES_PER_S,
                          5 * T * d / FP32_FLOPS) * 1e3
    return res


HOST_T = 263        # the largest T whose calls host_us times


def host_us(fn, calls=500):
    """Host microseconds per call of fn(i), back to back without a wait
    (at T <= HOST_T each launch's device time is shorter than its host
    time, so the launch queue never fills)."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def fmt_gather_norm(r) -> str:
    host = r["host_us"]
    return fmt_times(r) + (
        f"[replaced {r['replaced_ms']:.5f}ms (wall "
        f"{r['replaced_wall_ms']:.4f}); F.rms_norm "
        f"{r['library_norm_ms']:.5f}" + ("" if host is None else
                                         f"; host us fused {host['fused']:.1f}"
                                         f", gather-add alone "
                                         f"{host['gather_add_alone']:.1f}, "
                                         f"replaced {host['replaced']:.1f}")
        + "]")


def gather_row(name, replaces, r):
    """The kernels line's row of a fused gather-add: no one PyTorch call
    gathers, adds and normalises (F.rms_norm's time for the norm's half
    rides along as ``library_norm_ms``)."""
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/aot_gather_add.cu",
            "replaces": replaces, "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "replaced_ms": r["replaced_ms"],
            "library_norm_ms": r["library_norm_ms"]}


def times_single_gather(gen, report):
    """The single-table gather-add fused with the norm, and the norm alone
    (no table: the input norm of the methods without AoT), at the static
    batch's shapes, bf16: its prefill (T = 16 x 512) and a decode step (T =
    16), one task's table (49152, 960), 8 id sets rotated. The norm alone
    beside F.rms_norm (the same function: the scale's values are bf16's)
    and its bound (bytes: h read, x written). Returns both kernels' rows of
    the kernels line."""
    import torch.nn.functional as F
    from repro_torch.kernels import aot_bias, ops
    dt, d = torch.bfloat16, 960
    table = (torch.randn(49152, d, generator=gen, device=DEV) * 0.03).to(dt)
    res, alone = {}, {}
    for T in (16 * 512, 16):
        h = torch.randn(T, d, generator=gen, device=DEV).to(dt)
        ids = [torch.randint(0, 49152, (T,), generator=gen, device=DEV,
                             dtype=torch.int32) for _ in range(8)]
        res[T] = times_gather_norm(
            gen, h, lambda i, **kw: ops.aot_gather_add(h, table, ids[i % 8],
                                                       **kw),
            lambda i, **kw: aot_bias.aot_gather_add_plain(h, table,
                                                          ids[i % 8], **kw),
            200)
        hs = [torch.randn(T, d, generator=gen, device=DEV).to(dt)
              for _ in range(8)]
        scale = norm_scale(gen, d)
        kern = lambda i: ops.rms_norm(hs[i % 8], scale, EPS)
        plain = lambda i: aot_bias.rms_norm_plain(hs[i % 8], scale, EPS)
        r = alone[T] = timed(kern, plain, 200, 50, tol=TOL[dt])
        w = scale.to(dt)
        r["library_ms"] = device_ms(       # yardstick only
            lambda i: F.rms_norm(hs[i % 8], (d,), w, EPS), 200)
        r["host_us"] = host_us(kern) if T <= HOST_T else None
        r["bound_ms"] = (2 * T * d * 2 + 4 * d) / HBM_BYTES_PER_S * 1e3
        del hs
    del table
    report["times"]["aot_gather_add"] = res
    report["times"]["rms_norm"] = alone
    log("4 times", kernel="aot_gather_add", fused="norm",
        **{f"T{T}": fmt_gather_norm(r) for T, r in res.items()})
    log("4 times", kernel="rms_norm", **{
        f"T{T}": fmt_times(r) + f"[bytes; library {r['library_ms']:.5f}"
        + ("" if r["host_us"] is None else f"; host us {r['host_us']:.1f}")
        + "]" for T, r in alone.items()})
    r = alone[16 * 512]
    return [gather_row("aot_gather_add", "src/repro/kernels/aot_bias.py:27",
                       res[16 * 512]),
            {"name": "rms_norm", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/aot_gather_add.cu",
             "replaces": "src/repro/models/layers.py:57",
             "note": "not a TPU kernel (the reference's norm is XLA's); the "
                     "gather-add's body with no table",
             "max_abs_err": r["err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": "bytes", "library_ms": r["library_ms"]}]


def times_flash_offset(gen, report):
    """Flash attention at P-Tuning v2's prefill shape, bf16: 16 prompts of
    512 queries at positions 20.. over 532 keys (the 20-position prefix
    and the prompt), causal, beside SDPA with the same mask given as an
    explicit boolean mask (a yardstick only)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dt, es, b, s, off = torch.bfloat16, 2, 16, 512, 20
    qs = [flash_inputs(gen, b, s, s + off, HD, dt) for _ in range(8)]
    kern = lambda i: ops.flash_attention(*qs[i % 8], causal=True,
                                         q_offset=off)
    plain = lambda i: fa.flash_attention_plain(*qs[i % 8], causal=True,
                                               q_offset=off)
    res = timed(kern, plain, 32, 8, tol=TOL[dt])
    mask = (torch.arange(s + off, device=DEV)[None, :]
            <= off + torch.arange(s, device=DEV)[:, None])     # (sq, skv)
    sdpa = lambda i: F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in qs[i % 8]), attn_mask=mask,
        enable_gqa=True)
    res["library_ms"] = device_ms(sdpa, 32)      # yardstick only
    pairs = b * H * (s * off + s * (s + 1) // 2)   # visible (head, q, kv)
    res["bound_ms"], res["bound_by"] = bound(
        2 * b * s * H * HD * es + 2 * b * (s + off) * KVH * HD * es,
        4 * HD * pairs, dt)
    del qs
    report["times"]["flash_attention_q_offset"] = res
    log("4 times", kernel="flash_attention", shape=f"ptv2 b{b} sq{s} "
        f"skv{s + off} q_offset{off}", times=fmt_times(res)
        + f"[{res['bound_by']}; library {res['library_ms']:.5f}]")


def times_flash_one_prompt(gen, report):
    """Flash attention at a whole-prompt stream's prefill, bf16: one prompt
    of 512, causal (8 query tiles x 15 heads = 120 blocks of the bf16
    kernel on 132 SMs: whether one prompt fills the card), ROTATE layers of
    inputs, beside SDPA (a yardstick only)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dt, es, s = torch.bfloat16, 2, 512
    qs = [flash_inputs(gen, 1, s, s, HD, dt) for _ in range(ROTATE)]
    kern = lambda i: ops.flash_attention(*qs[i % ROTATE], causal=True)
    plain = lambda i: fa.flash_attention_plain(*qs[i % ROTATE], causal=True)
    res = timed(kern, plain, 64, 16, tol=TOL[dt])
    sdpa = lambda i: F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in qs[i % ROTATE]), is_causal=True,
        enable_gqa=True)
    res["library_ms"] = device_ms(sdpa, 64)      # yardstick only
    res["bound_ms"], res["bound_by"] = bound(
        s * (2 * H + 2 * KVH) * HD * es, 4 * HD * H * s * (s + 1) // 2, dt)
    del qs
    report["times"]["flash_attention_one_prompt"] = res
    log("4 times", kernel="flash_attention", shape=f"b1 sq{s} causal",
        times=fmt_times(res) + f"[{res['bound_by']}; library "
        f"{res['library_ms']:.5f}]")


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
    times_flash_one_prompt(gen, report)
    times_flash_offset(gen, report)
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
MAIN_PATH = {"aot_gather_add": "peft_aot",
             "aot_gather_add_multitask": "paged_greedy",
             "rms_norm": "peft_none",
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


# ---------------------------------------------------------------------------
# phase 5e: the faulted tick (tick retries, NaN watchdog, chaos, shutdown)
# ---------------------------------------------------------------------------

FAULT_LAYER = 16        # F1's raised attempt runs this many layers, raises
F1_ALLOC_TICK = 4       # F1: alloc_failure on the first chunk tick from here
F1_RAISE_TICK = 12      # F1: the raise on the first chunk tick from here
F2_TICK = 45            # F2: NaN on the first decode-only tick from here
# F3: every kind but crash; the seed is one whose every kind fires on
# phase 5's stream (tests/test_torch_smoke_checks.py replays it on the CPU)
F3_PLAN = dict(seed=32, horizon=64, p_exhaust=0.08, exhaust_pages=480,
               exhaust_ticks=3, p_straggler=0.1, straggler_ms=0.5,
               p_disconnect=0.05, p_malformed=0.08, p_nan=0.05,
               p_alloc_failure=0.05)
F3_KINDS = ("exhaust", "straggler", "disconnect", "malformed", "nan",
            "alloc_failure")
F3_SHUTDOWN_CLOCK = 56  # after the last arrival (43), with work still live
F3_GRACE = 4


def stream_ticks(sched, arrivals, before=None, until=None):
    """Submit and tick as ``run_stream`` does (idle gaps fast-forward),
    calling ``before(sched)`` before each tick; stop when all is served or
    ``until(sched)`` is true."""
    order = sorted(arrivals, key=lambda a: a[0])
    i = 0
    while i < len(order) or sched.busy():
        if until is not None and until(sched):
            return
        if not sched.busy() and order[i][0] > sched.clock:
            sched.clock = order[i][0]
        while i < len(order) and order[i][0] <= sched.clock:
            sched.submit(order[i][1])
            i += 1
        if before is not None:
            before(sched)
        sched.step()


def stream_outs(requests):
    return {r.rid: list(r.out) for r in requests.values()}


def survivors_expected(twin_rids, disconnected, quarantined, shed):
    """F3's survivors: the twin's requests less those a fault or the
    shutdown took."""
    return set(twin_rids) - set(disconnected) - set(quarantined) - set(shed)


def prefix_mismatches(got, twin, ticks_of, tick):
    """Requests of ``got`` whose tokens emitted up to and including
    ``tick`` (``ticks_of[rid]``: the tick of each token) are not the
    twin's."""
    bad = []
    for rid, out in got.items():
        n = sum(t <= tick for t in ticks_of.get(rid, []))
        if out[:n] != twin[rid][:n]:
            bad.append(rid)
    return sorted(bad)


def first_divergence(got, twin, ticks_of):
    """(rid, tick) of the lowest request whose stream differs from the
    twin's, at the tick this run emitted its first differing token (or its
    last, when one stream is a prefix of the other); None if all equal."""
    for rid in sorted(got):
        a, b = got[rid], twin[rid]
        if a != b:
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            ticks = ticks_of.get(rid, [])
            return rid, ticks[min(j, len(ticks) - 1)] if ticks else None
    return None


def fault_launches(layers, dispatched, reached):
    """Each main-path kernel's launches in a faulted run: ``layers`` per
    dispatch that ran the whole model, plus the layers that raised
    attempts reached (an injected alloc_failure reaches none)."""
    return layers * dispatched + reached


def f1_before(engine, state):
    """F1's hook: an alloc_failure on the first chunk tick from
    F1_ALLOC_TICK, then the raise between layers armed for the first chunk
    tick from F1_RAISE_TICK (the model's layer hook consumes it)."""
    def before(sched):
        if not sched._prefills:
            return
        if "alloc" not in state and sched.ticks >= F1_ALLOC_TICK:
            engine.inject_fault("alloc_failure")
            state["alloc"] = sched.ticks
        elif "raise" not in state and sched.ticks >= F1_RAISE_TICK:
            state["raise"], state["armed"] = sched.ticks, True
    return before


def f2_before(engine, state):
    """F2's hook: NaN on the middle running row of the first tick from
    F2_TICK that can only be decode-only (nothing chunking or queued)."""
    def before(sched):
        if ("tick" in state or sched.ticks < F2_TICK or sched._prefills
                or sched.queue or len(sched.running) < 3):
            return
        slots = sorted(sched.running)
        slot = slots[len(slots) // 2]
        state.update(tick=sched.ticks, slot=slot, rid=sched.running[slot].rid)
        engine.inject_fault("nan", slot)
    return before


def run_f3(sched, arrivals):
    """F3 on a fresh scheduler: F3_PLAN's faults before every tick until
    the clock reaches F3_SHUTDOWN_CLOCK, then the seized pages back, then
    ``shutdown(F3_GRACE)``."""
    from repro_torch.serve.faults import FaultInjector, FaultPlan
    inj = FaultInjector(sched, FaultPlan(**F3_PLAN))
    stream_ticks(sched, arrivals, lambda s: inj.before_tick(),
                 lambda s: s.clock >= F3_SHUTDOWN_CLOCK)
    inj.finish()
    held = sched.pool.num_quarantined()
    leaks = sched.drain_check()
    rep = sched.shutdown(grace_ticks=F3_GRACE)
    return dict(injector=inj, held=held, leaks_before=leaks, report=rep,
                leaks_after=sched.drain_check())


def f3_failures(sched, twin_rids, res, n_arrivals):
    """F3's required gates, as a list of what failed (empty = passed)."""
    inj, rep = res["injector"], res["report"]
    bad = [f"{k} never fired" for k in F3_KINDS if not inj.applied[k]]
    if not inj.malformed_ok:
        bad.append("a malformed submission was accepted")
    if res["leaks_before"] or not rep.clean or res["leaks_after"]:
        bad.append(f"leaks {res['leaks_before']} / {rep.leak_findings} / "
                   f"{res['leaks_after']}")
    if sched.busy():
        bad.append("not drained")
    if not rep.shed_rids:
        bad.append("no work was live at shutdown")
    seen = (set(sched.finished) | set(sched.aborted)
            | set(sched.quarantined))
    if len(seen) != n_arrivals:
        bad.append(f"{n_arrivals - len(seen)} requests unaccounted for")
    want = survivors_expected(twin_rids, inj.disconnected,
                              sched.quarantined, rep.shed_rids)
    if set(sched.finished) != want:
        bad.append(f"survivors {sorted(sched.finished)} != {sorted(want)}")
    reasons = {r.finish_reason for r in sched.aborted.values()}
    if not reasons <= {"disconnect", "shutdown"}:
        bad.append(f"abort reasons {sorted(reasons)}")
    return bad


def fault_run(engine, args, drive=None):
    """Phase 5's greedy stream on a fresh scheduler, through ``drive(sched,
    arrivals)`` (default: served to the end), recording the tick of every
    token. Returns the scheduler, ``ticks_of``, seconds, dispatches, the
    kernels' launches and what ``drive`` returned."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    ticks_of = {}
    box = {}

    def on_token(req, tok):
        ticks_of.setdefault(req.rid, []).append(box["sched"].ticks)
    arrivals = launcher.make_arrivals(args, engine.model.cfg.vocab_size,
                                      args.tasks, on_token)
    sched = box["sched"] = launcher.make_scheduler(engine, args)
    d0 = engine.dispatches
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    extra = (drive or stream_ticks)(sched, arrivals)
    torch.cuda.synchronize()
    return dict(sched=sched, arrivals=arrivals, ticks_of=ticks_of,
                seconds=time.perf_counter() - t0,
                dispatched=engine.dispatches - d0,
                counts=dict(ops.launches()), extra=extra)


def fault_line(label, run, card, **kv):
    sched = run["sched"]
    log(f"5e faults/{label}", tokens=sched.tokens_emitted,
        seconds=f"{run['seconds']:.3f}",
        tokens_per_s=f"{sched.tokens_emitted / run['seconds']:.1f}",
        ticks=sched.ticks, dispatched=run["dispatched"],
        dispatch_faults=sched.dispatch_faults,
        retries=sched.tick_retries_used, preemptions=sched.preemptions,
        launches=run["counts"], **kv, card=card)
    return dict(tokens=sched.tokens_emitted, seconds=run["seconds"],
                tokens_per_s=sched.tokens_emitted / run["seconds"],
                ticks=sched.ticks, dispatched=run["dispatched"],
                dispatch_faults=sched.dispatch_faults,
                retries=sched.tick_retries_used,
                preemptions=sched.preemptions, launches=run["counts"],
                **{k: v for k, v in kv.items()})


def phase_faults(report, engine):
    """Phase 5e: phase 5's greedy stream, fault-free (the twin), then F1
    (an injected alloc_failure and an exception raised between two layers
    of another chunk tick: every stream bitwise the twin's), F2 (NaN on one
    decode row of a decode-only tick: that request quarantined, every
    survivor's tokens through that tick the twin's, the hold released
    clean by shutdown), F3 (F3_PLAN's seeded chaos ending in shutdown:
    drained, leak-free, every kind fired, the survivors as
    survivors_expected says). Each run's kernels launch exactly
    fault_launches times."""
    from repro_torch.launch import serve as launcher
    layers = engine.model.cfg.num_layers
    args = launcher.parser().parse_args(BASE + GREEDY)
    card = smi()
    kernels = ("aot_gather_add_multitask", "ragged_paged_attention")
    res, failed = {}, []

    def launches_ok(label, run, reached):
        want = fault_launches(layers, run["dispatched"], reached)
        check_launches(label, run["counts"], {k: want for k in kernels})

    twin = fault_run(engine, args)
    twin_out = stream_outs(twin["sched"].finished)
    if len(twin_out) != args.requests or twin["sched"].drain_check():
        raise AssertionError("5e twin: unfinished requests or leaks")
    launches_ok("5e twin", twin, 0)
    res["twin"] = fault_line("twin", twin, card)

    # F1: raised dispatches, retried
    state = {}
    model = engine.model
    block = model._block

    def hooked(lp, h, sincos, attend, peft, i, aot):
        if i == FAULT_LAYER and state.pop("armed", False):
            raise RuntimeError(f"injected fault after {FAULT_LAYER} layers")
        return block(lp, h, sincos, attend, peft, i, aot)
    model._block = hooked
    try:
        f1 = fault_run(engine, args, lambda s, a: stream_ticks(
            s, a, f1_before(engine, state)))
    finally:
        del model._block
    sched = f1["sched"]
    got = stream_outs(sched.finished)
    n_same = sum(got.get(r) == o for r, o in twin_out.items())
    ok = (n_same == len(twin_out) and "alloc" in state and "raise" in state
          and "armed" not in state and sched.dispatch_faults == 2
          and sched.tick_retries_used == 2 and not sched.drain_check())
    res["F1"] = fault_line(
        "F1", f1, card, alloc_failure_tick=state.get("alloc"),
        raise_tick=state.get("raise"), raised_after_layers=FAULT_LAYER,
        streams_equal=f"{n_same}/{len(twin_out)}",
        required="16/16 bitwise, 2 faults, 2 retries")
    launches_ok("5e F1", f1, FAULT_LAYER)
    if not ok:
        failed.append("F1")

    # F2: the NaN watchdog
    state = {}
    held = {}

    def drive_f2(s, a):
        stream_ticks(s, a, f2_before(engine, state))
        held["pages"] = s.pool.num_quarantined()
        return s.shutdown()
    f2 = fault_run(engine, args, drive_f2)
    sched, rep = f2["sched"], f2["extra"]
    got = stream_outs(sched.finished)
    bad_prefix = prefix_mismatches(got, twin_out, f2["ticks_of"],
                                   state.get("tick", -1))
    div = first_divergence(got, twin_out, f2["ticks_of"])
    ok = ("tick" in state and set(sched.quarantined) == {state["rid"]}
          and held["pages"] > 0 and rep.clean
          and rep.quarantined_pages_released > 0
          and sched.pool.num_quarantined() == 0 and not bad_prefix
          and set(got) == set(twin_out) - {state["rid"]})
    n_same = sum(got[r] == twin_out[r] for r in got)
    res["F2"] = fault_line(
        "F2", f2, card, nan_tick=state.get("tick"), nan_rid=state.get("rid"),
        quarantined=sorted(sched.quarantined), held_pages=held["pages"],
        released=rep.quarantined_pages_released, clean=rep.clean,
        prefix_mismatches=bad_prefix, streams_equal=f"{n_same}/{len(got)}",
        first_divergence="none" if div is None
        else f"rid {div[0]} at tick {div[1]}",
        required="1 quarantined, survivors' prefixes equal, released clean")
    launches_ok("5e F2", f2, 0)
    if not ok:
        failed.append("F2")

    # F3: seeded chaos, then shutdown with work still live
    f3 = fault_run(engine, args, run_f3)
    sched, r3 = f3["sched"], f3["extra"]
    bad = f3_failures(sched, twin_out, r3, args.requests)
    got = stream_outs(sched.finished)
    n_same = sum(got[r] == twin_out[r] for r in got)
    inj, rep = r3["injector"], r3["report"]
    res["F3"] = fault_line(
        "F3", f3, card, applied=inj.applied, disconnected=inj.disconnected,
        quarantined=sorted(sched.quarantined), shed=rep.shed_rids,
        grace_ticks=rep.grace_ticks_used, held_pages=r3["held"],
        released=rep.quarantined_pages_released,
        leaks=r3["leaks_before"] + rep.leak_findings + r3["leaks_after"],
        survivors=len(got), streams_equal=f"{n_same}/{len(got)}",
        failures=bad or "none", required="no failures")
    launches_ok("5e F3", f3, 0)
    if bad:
        failed.append("F3")
    report["faults"] = res
    if failed:
        raise AssertionError(f"phase 5e failed: {failed}")
    return {f"faults_{label}": run["counts"]
            for label, run in (("twin", twin), ("F1", f1), ("F2", f2),
                               ("F3", f3))}


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


STATIC_STEPS = 64


def static_batch(engine):
    """The static batch's 16 prompts of 512 tokens and their mixed task
    ids (seed 0)."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, engine.model.cfg.vocab_size,
                           (16, 512)).astype(np.int32)
    return prompts, rng.integers(0, engine.num_tasks, 16).astype(np.int32)


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
    prompts, task_ids = static_batch(engine)
    (b, s), steps = prompts.shape, STATIC_STEPS
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
    # ... and over the paged pool (paged decode in place of contiguous)
    report["static"]["profile_paged"] = profile_run(
        "5c profile paged", lambda: paged_generate(engine, prompts, 16,
                                                   task_ids), steps=16)
    return counts


# the paper's Fig. 3 methods (benchmarks/speed_overhead.py), each served by
# one ServeEngine(peft=...): the backbone, one task's fused AoT tables,
# BitFit, LoRA (rank 16, alpha 32) unfused and fused into W_q / W_v,
# adapters (rank 16), P-Tuning v2 (a 20-position prefix)
PEFT_METHODS = ("none", "aot", "bitfit", "lora", "lora_fused", "adapters",
                "ptv2")
LOGITS_GRID = ((1, 64), (8, 64), (1, 384), (8, 384))   # speed_overhead's
PEFT_ROUNDS = 5     # each method's runs, in turns (the host's speed drifts)


def peft_setup(label, model, params, table, gen):
    """(backbone params, PEFT bundle or None) serving ``label`` of
    PEFT_METHODS: ``aot`` gets ``table`` (L, V, d); every other method's
    leaves are drawn as normals x 0.02 (speed_overhead.py:30-32), in the
    model's compute dtype; ``lora_fused`` folds its LoRA into the backbone
    (core.peft.fuse_lora_into)."""
    from repro_torch.core import peft as P
    method = "lora" if label == "lora_fused" else label
    if method == "none":
        return params, None
    opt = P.PEFTOptions(method=method, aot=P.AoTOptions(mode="fused"),
                        lora_rank=16, lora_alpha=32.0, adapter_rank=16,
                        prompt_len=20)
    if method == "aot":
        return params, P.make({"aot": {"table": table}}, opt)
    dt = model.opts.compute_dtype

    def redraw(tree):
        if isinstance(tree, dict):
            return {k: redraw(v) for k, v in tree.items()}
        return (torch.randn(tree.shape, generator=gen, device=DEV)
                * 0.02).to(dt)
    pp = redraw(P.init(model.cfg, opt, device=DEV, dtype=dt))
    if label == "lora_fused":
        return P.fuse_lora_into(params, pp, model.cfg, opt), None
    return params, P.make(pp, opt)


def phase_peft(report, engine):
    """The paper's Fig. 3 comparison at full width, bf16: phase 5c's 16
    prompts of 512 tokens, 64 greedy tokens, through one
    ``ServeEngine(peft=...)`` per method of PEFT_METHODS (AoT: task 0's
    tables of the launcher's engine), PEFT_ROUNDS runs each, the methods
    in turns: median generated tokens/s and its time ratio to the
    backbone's; kernels per step and device busy ms from one profiled
    16-step run. Launches are checked exactly in every run; the AoT rows
    must equal the multi-task engine's with every task id 0, token for
    token. Then ``Model.logits`` at speed_overhead.py's grid, in turns,
    each method's median time ratio to the backbone's (reported only)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeEngine
    model = engine.model
    layers = model.cfg.num_layers
    prompts, _ = static_batch(engine)
    (b, s), steps = prompts.shape, STATIC_STEPS
    gen = torch.Generator(device=DEV).manual_seed(5)
    table = engine.tables[:, 0].contiguous()
    setups = {label: peft_setup(label, model, engine.params, table, gen)
              for label in PEFT_METHODS}
    engines = {label: ServeEngine(model, params, engine.cfg, peft=bundle)
               for label, (params, bundle) in setups.items()}
    for eng in engines.values():
        eng.generate(prompts[:2], 2)                     # warm-up
    want = {"flash_attention": layers, "decode_attention": layers * steps}
    secs = {label: [] for label in PEFT_METHODS}
    counts, outs = {}, {}
    for r in range(PEFT_ROUNDS):        # in turns, the order rotated
        for label in PEFT_METHODS[r:] + PEFT_METHODS[:r]:
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            outs[label] = engines[label].generate(prompts, steps)
            torch.cuda.synchronize()
            secs[label].append(time.perf_counter() - t0)
            counts[f"peft_{label}"] = dict(ops.launches())
            per_call = layers * (1 + steps)     # prefill + steps, per layer
            check_launches(f"peft_{label}", counts[f"peft_{label}"], dict(
                want, aot_gather_add=per_call * (label == "aot"),
                rms_norm=per_call * (label != "aot")))
    res = {}
    for label, eng in engines.items():
        prof = profile_of(lambda: eng.generate(prompts, 16), steps=16)
        tps = sorted(b * steps / t for t in secs[label])
        res[label] = dict(seconds=secs[label], tokens_per_s=median(tps),
                          tokens_per_s_range=(tps[0], tps[-1]),
                          kernels_per_step=prof["kernels_per_step"],
                          device_busy_ms=prof["device_busy_ms"],
                          profiled_wall_ms=prof["wall_ms"],
                          top_kernels=prof["kernels"][:5])
    del engines
    base = res["none"]
    for label, r in res.items():
        r["ratio"] = base["tokens_per_s"] / r["tokens_per_s"]   # time / none
        r["busy_ratio"] = r["device_busy_ms"] / base["device_busy_ms"]
        log(f"5d peft/{label}", b=b, prompt=s, steps=steps,
            rounds=PEFT_ROUNDS, tokens_per_s=f"{r['tokens_per_s']:.1f}",
            tokens_per_s_range="{:.1f}-{:.1f}".format(
                *r["tokens_per_s_range"]),
            time_ratio_to_none=f"{r['ratio']:.3f}",
            kernels_per_step=f"{r['kernels_per_step']:.0f}",
            device_busy_ms_16_steps=f"{r['device_busy_ms']:.1f}",
            busy_ratio_to_none=f"{r['busy_ratio']:.3f}",
            profiled_wall_ms=f"{r['profiled_wall_ms']:.0f}",
            launches=counts[f"peft_{label}"])
    multi = engine.generate(prompts, steps, np.zeros(b, np.int32))
    same = int((multi == outs["aot"]).all(axis=1).sum())
    log("5d peft/aot vs multi-task", rows_equal=f"{same}/{b}",
        required=f"{b}/{b}")
    if same != b:
        raise AssertionError(f"the single-table AoT engine's tokens equal "
                             f"the multi-task engine's in {same}/{b} rows")
    grid = {}
    rng = np.random.default_rng(1)
    for gb, gs in LOGITS_GRID:
        toks = torch.as_tensor(rng.integers(0, model.cfg.vocab_size,
                                            (gb, gs)), dtype=torch.int32,
                               device=DEV)
        ms = {label: [] for label in PEFT_METHODS}
        for r in range(PEFT_ROUNDS):
            for label in PEFT_METHODS[r:] + PEFT_METHODS[:r]:
                p, bd = setups[label]
                ms[label].append(wall_ms(
                    lambda i: model.logits(p, toks, bd), iters=3,
                    warmup=2 if r == 0 else 0))
        ms = {label: median(t) for label, t in ms.items()}
        grid[f"b{gb}_s{gs}"] = ms
        log("5d logits", b=gb, s=gs, rounds=PEFT_ROUNDS, **{
            label: f"{t:.2f}ms({t / ms['none']:.3f}x)"
            for label, t in ms.items()})
    report["peft"] = dict(runs=res, launches=counts, aot_rows_equal=same,
                          logits_ms=grid)
    del setups, table
    return counts


def profile_run(phase, fn, steps):
    """Device busy share, kernels per step and the top kernels and host
    ops of ``fn()`` under torch.profiler (CPU + CUDA), logged as one line
    of ``phase``."""
    r = profile_of(fn, steps)
    top = lambda rows: ";".join(f"{k[:40]}:{t:.0f}ms" for t, k in rows[:5])
    log(phase, steps=steps, wall_ms=f"{r['wall_ms']:.0f}",
        device_busy_ms=f"{r['device_busy_ms']:.0f}",
        busy_share=f"{r['device_busy_ms'] / r['wall_ms']:.3f}",
        kernels_per_step=f"{r['kernels_per_step']:.0f}",
        top_kernels=top(r["kernels"]), top_host_ops=top(r["host_ops"]))
    return r


def profile_of(fn, steps):
    """``fn()`` under torch.profiler (CPU + CUDA): wall ms, device busy ms
    (the kernels' summed device time), kernels per step, the top kernels
    and host ops."""
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
    return dict(steps=steps, wall_ms=wall_ms, device_busy_ms=busy_ms,
                kernels_per_step=per_step, kernels=kern[:15],
                host_ops=host[:25])


@contextlib.contextmanager
def plain_ops():
    """Every kernel wrapper the model calls replaced by its plain version
    (the same tensors on the card, no kernel launched; the ragged kernel's
    plan, which only the kernel reads, is dropped)."""
    from repro_torch.kernels import aot_bias, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    def ragged(q, k_pages, v_pages, block_tables, token_rows, token_pos,
               plan=None):
        return da.ragged_paged_attention_plain(q, k_pages, v_pages,
                                               block_tables, token_rows,
                                               token_pos)
    plain = {"aot_gather_add": aot_bias.aot_gather_add_plain,
             "aot_gather_add_multitask":
                 aot_bias.aot_gather_add_multitask_plain,
             "rms_norm": aot_bias.rms_norm_plain,
             "ragged_paged_attention": ragged,
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


def tasks_peft(tables, task_ids):
    """The multi-task fused-AoT bundle (as ServeEngine builds it) for
    stacked tables (L, tasks, V, d) and per-row ``task_ids``."""
    from repro_torch.core import peft as P
    opt = P.PEFTOptions(method="aot", aot=P.AoTOptions(mode="fused"))
    return dict(P.make({"aot": {"table": tables}}, opt), task_ids=task_ids)


def greedy_decode(model, params, logits, cache, pos0, peft, steps,
                  block_tables=None, forced=None):
    """``steps`` greedy decode steps after ``logits``, the first at cache
    row ``pos0``: per-step logits (steps + 1, b, V) float32 and the tokens
    (b, steps). ``forced`` (b, steps) feeds those tokens in place of the
    argmax (teacher forcing)."""
    b = logits.shape[0]
    lgs, tokens = [logits[:, -1].float()], []
    for i in range(steps):
        tok = (lgs[-1].argmax(-1).to(torch.int32)[:, None] if forced is None
               else forced[:, i:i + 1])
        tokens.append(tok)
        pos = torch.full((b,), pos0 + i, dtype=torch.int32, device=DEV)
        logits, cache = model.decode_step(params, tok, pos, cache, peft,
                                          block_tables=block_tables)
        lgs.append(logits[:, -1].float())
    torch.cuda.synchronize()
    return torch.stack(lgs), torch.cat(tokens, 1)


# phase 6's bf16 tolerance of kernel logits against the plain versions
LOGIT_TOL = dict(atol=2e-2, rtol=2e-2)


def against_plain(lg_k, lg_p):
    """Kernel logits ``lg_k`` against the plain versions' ``lg_p`` of the
    same inputs (..., V) float32: max abs error, the rows whose argmax
    differs, the largest gap in ``lg_p`` between its argmax and the
    kernels' there, and whether every logit is within LOGIT_TOL. Within it,
    a differing argmax is a near tie: its gap is at most two tolerances."""
    a_k, a_p = lg_k.argmax(-1), lg_p.argmax(-1)
    gap = (lg_p.gather(-1, a_p[..., None])
           - lg_p.gather(-1, a_k[..., None])).max().item()
    return dict(logits_max_abs_err=(lg_k - lg_p).abs().max().item(),
                near_ties=int((a_k != a_p).sum()), tie_gap=gap,
                ok=torch.allclose(lg_k, lg_p, **LOGIT_TOL))


def kernels_vs_plain(model, params, toks, peft, steps):
    """A whole-prompt prefill plus ``steps`` greedy decode steps through
    the kernels, against the plain versions fed the kernels' tokens (the
    same inputs at every step): ``against_plain`` of the logits, plus
    whether the plain versions' own greedy run picks the same tokens
    (``free_same``, reported: a near tie may send it elsewhere)."""
    def run(forced=None):
        logits, cache, pos = model.prefill(params, toks, peft,
                                           max_len=MAX_LEN)
        return greedy_decode(model, params, logits, cache, pos, peft, steps,
                             forced=forced)
    lg_k, tok_k = run()
    with plain_ops():
        lg_p, _ = run(forced=tok_k)
        _, tok_free = run()
    return dict(against_plain(lg_k, lg_p),
                free_same=torch.equal(tok_k, tok_free))


def verdict(r):
    """One result of ``against_plain`` as text for a log line."""
    return (f"{r['logits_max_abs_err']:.3e}/ties {r['near_ties']}"
            f"/gap {r['tie_gap']:.3e}"
            + ("" if r.get("free_same", True) else "/free-run DIFFER"))


def cross_check_static(gen, report, model, params, tables):
    """At full width with 2 layers: a whole-prompt prefill plus three
    decode steps through the kernels against the plain versions
    (``kernels_vs_plain``); then decode steps over a paged pool filled from
    that prefill (scrambled pages) against the contiguous decode steps on
    the same cache (same tokens). Returns whether both held."""
    from repro_torch.serve.kv_pool import PagedKVPool
    b, s, steps = 4, 300, 3
    toks = torch.randint(0, model.cfg.vocab_size, (b, s), generator=gen,
                         device=DEV, dtype=torch.int32)
    peft = tasks_peft(tables, torch.arange(b, dtype=torch.int32,
                                           device=DEV) % 4)
    res = kernels_vs_plain(model, params, toks, peft, steps)
    first, cache, _ = model.prefill(params, toks, peft, max_len=MAX_LEN)
    # the paged pool, pages handed out in a scrambled order
    pool = PagedKVPool(model, b, MAX_LEN, block_size=BS)
    pool._free_blocks = [int(p) for p in np.random.default_rng(1).permutation(
        pool._free_blocks)]
    for r in range(b):
        slot = pool.alloc(0, pool.pages_needed(s + steps))
        pool.write_prefill(slot, {n: c[:, r:r + 1] for n, c in cache.items()},
                           s)
    bt = torch.as_tensor(pool.block_tables, device=DEV)
    lg_c, tok_c = greedy_decode(model, params, first, cache, s, peft, steps)
    lg_g, tok_g = greedy_decode(model, params, first, pool.cache, s, peft,
                                steps, bt)
    paged_err = (lg_g - lg_c).abs().max().item()
    paged_same = torch.equal(tok_g, tok_c)
    log("6 cross-check static", layers=2, b=b, prompt=s, steps=steps,
        vs_plain=verdict(res),
        paged_vs_contiguous_max_abs_err=f"{paged_err:.3e}",
        paged_tokens="identical" if paged_same else "DIFFER")
    report["cross_check_static"] = dict(
        res, paged_vs_contiguous_max_abs_err=paged_err, paged_same=paged_same)
    return res["ok"] and paged_same and paged_err <= 2e-2


def cross_check_peft(gen, report, model, params, tables):
    """At full width with 2 layers, for every method of phase 5d (AoT:
    task 0's tables): ``kernels_vs_plain`` of a whole-prompt prefill plus
    three decode steps. Returns the methods that missed the tolerance."""
    b, s, steps = 4, 300, 3
    toks = torch.randint(0, model.cfg.vocab_size, (b, s), generator=gen,
                         device=DEV, dtype=torch.int32)
    table = tables[:, 0].contiguous()
    res = {}
    for label in PEFT_METHODS:
        p, bundle = peft_setup(label, model, params, table, gen)
        res[label] = kernels_vs_plain(model, p, toks, bundle, steps)
    log("6 cross-check peft", layers=2, b=b, prompt=s, steps=steps,
        **{label: verdict(r) for label, r in res.items()})
    report["cross_check_peft"] = res
    return [label for label, r in res.items() if not r["ok"]]


# phase 6 draws its inputs and PEFT parameters from a generator of its own,
# so that draws added to earlier phases leave them as they are
PHASE6_SEED = 0


def phase_cross_check(report, seed=PHASE6_SEED, recompute=True):
    """Phase 6 at inputs drawn from ``seed``: kernels against the plain
    versions at full width with 2 layers, the plain versions fed the
    kernels' tokens, every logit within LOGIT_TOL (so a token that differs
    is a near tie, counted in each line), and paged against contiguous
    decode (same tokens). Records every check, then raises if one failed."""
    from repro_torch import configs
    from repro_torch.core import aot as aot_mod
    from repro_torch.models import model as model_mod
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.scheduler import (ContinuousScheduler, Request,
                                             SchedulerConfig)
    gen = torch.Generator(device=DEV).manual_seed(seed)
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
    peft = tasks_peft(tables, i32([slot_task[r] for r in rows]))

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
    res = against_plain(lg_k, lg_p)
    kv_err = max((cache_k[n].float() - cache_p[n].float()).abs().max().item()
                 for n in ("k", "v"))
    log("6 cross-check", seed=seed, layers=2, T=T, vs_plain=verdict(res),
        kv_max_abs_err=f"{kv_err:.3e}")
    report["cross_check"] = dict(res, seed=seed, kv_max_abs_err=kv_err)
    failed = [] if res["ok"] else ["tick"]
    if not cross_check_static(gen, report, model, params, tables):
        failed.append("static")
    failed += cross_check_peft(gen, report, model, params, tables)
    if failed:
        raise AssertionError(f"kernel and plain runs disagree for {failed}")
    if not recompute:
        return
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
    report["build_s"], report["redesigned"] = phase_build(KERNEL_SOURCES)
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
    launches.update(phase_peft(report, engine))
    launches.update(phase_faults(report, engine))
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
    phase_cross_check(report)
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
