#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py        # from the root of a checkout

Phases, each printing one line of results; any failure exits non-zero:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: both CUDA kernels compiled by nvcc for sm_90a from
   src/repro_torch/kernels/csrc, in parallel;
3. parity: each kernel's public wrapper against its plain PyTorch version
   on the card at smollm-360m's shapes (gather-add bitwise; ragged
   attention within 2e-5 in float32 and 2e-2 in bfloat16), for both the
   16-byte-load and the one-element-load build of each kernel;
4. kernel times at the serving tick's shapes (device time from
   torch.profiler), beside the plain version's and the least time the card
   could take (bytes at 3.35 TB/s, operations at the published peak);
5. the main path: full-width 32-layer smollm-360m in bfloat16 with 4 fused
   tasks serving a Poisson stream through the launcher's own code
   (repro_torch.launch.serve), greedy, then 4 requests sampled at
   temperature 0.8 / top-p 0.9; every request must finish, the pool must
   drain clean, and each kernel must launch 32 times per dispatched tick
   (launch counts zeroed just before each stream; ``launches`` in the
   kernels line is the greedy stream's, ``launches_sampled`` the other's);
6. cross-check at full width with 2 layers: one mixed tick through the
   kernels and through the plain versions must agree (bf16 tolerance,
   same greedy tokens); preempt-and-recompute parity is reported.

The last two lines are a JSON line of per-kernel numbers and
``{"ok": true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
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
    peak = BF16_TENSOR_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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

    variants = {"vec": (HD, False), "scalar_hd60": (60, False),
                "scalar_misaligned": (HD, True)}
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
        "source": "src/repro_torch/kernels/csrc/ragged_paged_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:286",
        "max_abs_err": a["err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
        "library_ms": None})
    log("4 times", kernel="ragged_paged_attention",
        **{n: fmt_times(r) + f"[{r['bound_by']}, T{r['T']}]"
           for n, r in res.items()})
    report["times"]["ragged_paged_attention"] = res
    return rows_out


def phase_main_path(report):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    base = ["--arch", "smollm-360m", "--demo", "--tasks", "4",
            "--rate", "0.5", "--slots", str(SLOTS), "--block-size", str(BS),
            "--max-len", str(MAX_LEN), "--prefill-chunk", "256",
            "--max-prefills", "4", "--prompt", "512", "--steps", "48",
            "--dtype", "bfloat16", "--quiet"]
    runs = {"greedy": ["--requests", "16"],
            "sampled": ["--requests", "4", "--temperature", "0.8",
                        "--top-p", "0.9", "--seed", "100"]}
    t0 = time.perf_counter()
    args = launcher.parser().parse_args(base + runs["greedy"])
    engine = launcher.build_engine(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    layers = engine.model.cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    total, launches = {}, {}
    for label, extra in runs.items():
        args = launcher.parser().parse_args(base + extra)
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
        for name, c in counts.items():
            if c != layers * dispatched:
                raise AssertionError(f"{label}: {name} launched {c} times, "
                                     f"expected {layers} x {dispatched}")
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
    from torch.profiler import ProfilerActivity, profile
    args = launcher.parser().parse_args(base + runs["sampled"])
    arrivals = launcher.make_arrivals(args, engine.model.cfg.vocab_size,
                                      args.tasks)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sched = launcher.serve(engine, args, arrivals)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t1) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    avgs = prof.key_averages()
    kern = sorted(((e.self_device_time_total / 1e3, e.key) for e in avgs
                   if e.device_type == cuda), reverse=True)
    host = sorted(((e.self_cpu_time_total / 1e3, e.key) for e in avgs
                   if e.device_type != cuda), reverse=True)
    busy_ms = sum(t for t, _ in kern)
    per_tick = sum(e.count for e in avgs
                   if e.device_type == cuda) / max(sched.ticks, 1)
    top = lambda rows: ";".join(f"{k[:40]}:{t:.0f}ms" for t, k in rows[:5])
    log("5 profile", ticks=sched.ticks, wall_ms=f"{wall_ms:.0f}",
        device_busy_ms=f"{busy_ms:.0f}",
        busy_share=f"{busy_ms / wall_ms:.3f}",
        kernels_per_tick=f"{per_tick:.0f}", top_kernels=top(kern),
        top_host_ops=top(host))
    report["profile"] = dict(ticks=sched.ticks, wall_ms=wall_ms,
                             device_busy_ms=busy_ms,
                             kernels_per_tick=per_tick,
                             kernels=kern[:15], host_ops=host[:25])
    del engine
    torch.cuda.empty_cache()
    return launches


def phase_cross_check(gen, report):
    from repro_torch import configs
    from repro_torch.core import aot as aot_mod
    from repro_torch.kernels import aot_bias, decode_attention
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
    ops = model_mod.ops
    saved = ops.aot_gather_add_multitask, ops.ragged_paged_attention
    ops.aot_gather_add_multitask = aot_bias.aot_gather_add_multitask_plain
    ops.ragged_paged_attention = decode_attention.ragged_paged_attention_plain
    try:
        lg_p, cache_p = tick()
    finally:
        ops.aot_gather_add_multitask, ops.ragged_paged_attention = saved
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
    report["build_s"], _ = phase_build(["aot_gather_add",
                                        "ragged_paged_attention"])
    gen = torch.Generator(device=DEV).manual_seed(0)
    phase_parity(gen, report)
    if args.quick:
        print("[quick] stopped after parity; no result")
        return 0
    kernels = phase_times(gen, report)
    launches = phase_main_path(report)
    for row in kernels:       # the greedy stream is the main path's run
        row["launches"] = launches["greedy"][row["name"]]
        row["launches_sampled"] = launches["sampled"][row["name"]]
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
