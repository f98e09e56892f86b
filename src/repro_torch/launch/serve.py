"""Multi-task serving launcher of the port.

Fabricates fused AoT task tables (``--demo``) and serves a continuous
Poisson stream of mixed-task requests from one frozen backbone: requests
arrive on the scheduler's tick clock, pick a task at random, and stream
their tokens through a callback as they decode. ``--layout`` picks the
paged KV pool (chunked prefill, or whole prompts with ``--prefill-chunk
0``) or contiguous slots (whole prompts); ``--static`` serves one static
batch of equal-length prompts instead (greedy). Runs on the card unless
``--device cpu`` is given. Exits non-zero if the KV pool leaks.

    # on a GPU: full-width smollm-360m in bf16, four tasks
    PYTHONPATH=src python -m repro_torch.launch.serve --demo --tasks 4 \\
        --dtype bfloat16 --slots 8 --max-len 1024 --prefill-chunk 256
    # ... the slotted layout, or one static batch
    PYTHONPATH=src python -m repro_torch.launch.serve --demo --tasks 4 \\
        --dtype bfloat16 --slots 8 --max-len 1024 --layout slots
    PYTHONPATH=src python -m repro_torch.launch.serve --demo --tasks 4 \\
        --dtype bfloat16 --static --requests 16 --prompt 512 --steps 64 \\
        --max-len 1024

    # on the CPU, reduced widths
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --demo --tasks 3 --requests 6
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import aot as aot_mod
from repro_torch.models.model import Model, ModelOptions
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import (ContinuousScheduler, Request,
                                         SchedulerConfig)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the arch to 2 layers and tiny widths")
    ap.add_argument("--demo", action="store_true",
                    help="fabricate random task tables (required for now: "
                         "loading exported tables is not ported)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu only "
                         "when asked for)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                    help="compute and parameter dtype (ModelOptions)")
    ap.add_argument("--tasks", type=int, default=3,
                    help="number of fabricated tasks")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rate", type=float, default=0.5,
                    help="mean arrivals per tick (Poisson stream)")
    ap.add_argument("--slots", type=int, default=4,
                    help="KV-pool slots (continuous batch width)")
    ap.add_argument("--layout", choices=("paged", "slots"), default="paged",
                    help="KV layout: paged pool, or contiguous per-slot "
                         "caches (whole-prompt prefills)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV page size in tokens (--layout paged)")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="physical KV pages incl. the scratch page "
                         "(0 = slots * max-len / block-size + 1)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="per-tick prefill token budget, split across the "
                         "prompts chunking concurrently (--layout paged; "
                         "0 = whole-prompt prefills)")
    ap.add_argument("--max-prefills", type=int, default=4,
                    help="prompts allowed to chunk concurrently")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy argmax; > 0 samples with per-request "
                         "seeded streams")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k highest logits (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = off)")
    ap.add_argument("--seed", type=int, default=0,
                    help="base RNG seed (request i uses seed + i)")
    ap.add_argument("--prompt", type=int, default=16,
                    help="max prompt length (sampled 4..this)")
    ap.add_argument("--steps", type=int, default=8,
                    help="max new tokens per request (sampled 2..this)")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-token streaming output")
    ap.add_argument("--static", action="store_true",
                    help="one static batch: --requests prompts of --prompt "
                         "tokens, --steps greedy tokens each")
    return ap


def build_engine(args) -> ServeEngine:
    """Model with random weights (seed 0) and ``--tasks`` fabricated fused
    tables, on ``--device``."""
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg, repeats=2)
    dt = DTYPES[args.dtype]
    model = Model(cfg, ModelOptions(compute_dtype=dt, param_dtype=dt),
                  device=args.device)
    params = model.init(0)
    tasks = [aot_mod.random_fused(cfg, params["embed"]["tok"], seed=t,
                                  scale=0.03, vocab_chunk=4096, dtype=dt)
             for t in range(args.tasks)]
    return ServeEngine(model, params, ServeConfig(max_len=args.max_len),
                       fused_tasks=aot_mod.stack_tasks(tasks))


def make_arrivals(args, vocab_size: int, n_tasks: int,
                  on_token=None) -> List[Tuple[int, Request]]:
    """The ``--demo`` Poisson stream, drawn from ``default_rng(0)`` in the
    reference launcher's order (so the same flags give the same requests)."""
    rng = np.random.default_rng(0)
    ticks, t = [], 0.0
    for _ in range(args.requests):
        t += rng.exponential(1.0 / max(args.rate, 1e-6))
        ticks.append(int(t))
    sampling = None
    if args.temperature > 0:
        sampling = SamplingParams(temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p)
    arrivals = []
    for i in range(args.requests):
        plen = int(rng.integers(4, args.prompt + 1))
        rng.random()        # the reference draws a priority class here
        task = int(rng.integers(0, n_tasks))
        prompt = rng.integers(0, vocab_size, plen).astype(np.int32)
        req = Request(
            rid=i, prompt=prompt, task_id=task,
            max_new_tokens=int(rng.integers(2, args.steps + 1)),
            on_token=on_token,
            sampling=None if sampling is None
            else dataclasses.replace(sampling, seed=args.seed + i))
        arrivals.append((ticks[i], req))
    return arrivals


def make_scheduler(engine: ServeEngine, args) -> ContinuousScheduler:
    """A fresh scheduler over ``engine`` as the flags configure it."""
    return ContinuousScheduler(engine, SchedulerConfig(
        num_slots=args.slots, kv_layout=args.layout,
        block_size=args.block_size, num_blocks=args.num_blocks,
        prefill_chunk=args.prefill_chunk, max_prefills=args.max_prefills))


def serve(engine: ServeEngine, args, arrivals) -> ContinuousScheduler:
    """Serve the stream to the end on a fresh scheduler."""
    sched = make_scheduler(engine, args)
    sched.run_stream(arrivals)
    return sched


def static_batch(args, vocab_size: int, n_tasks: int):
    """The ``--static`` batch, drawn from ``default_rng(0)`` as the
    reference launcher draws it: (requests, prompt) prompts and their
    task ids."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, vocab_size,
                           (args.requests, args.prompt)).astype(np.int32)
    task_ids = rng.integers(0, n_tasks, args.requests).astype(np.int32)
    return prompts, task_ids


def main(argv: Optional[List[str]] = None):
    """Serve as the flags say. Returns the scheduler that served the
    stream, or with ``--static`` the (requests, steps) generated tokens."""
    ap = parser()
    args = ap.parse_args(argv)
    if not args.demo:
        ap.error("pass --demo (fabricated tables); loading exported tables "
                 "is not ported yet")
    if args.prompt + args.steps - 1 > args.max_len:
        ap.error(f"--prompt {args.prompt} + --steps {args.steps} cannot fit "
                 f"--max-len {args.max_len}")
    engine = build_engine(args)
    cfg = engine.model.cfg
    mb = aot_mod.table_bytes(cfg, args.tasks,
                             engine.tables.element_size()) / 1e6
    print(f"serving {args.tasks} tasks on {engine.device}; fused tables "
          f"{mb:.1f} MB")

    if args.static:
        if args.temperature > 0 or args.top_k > 0 or args.top_p < 1.0:
            print("warning: --static is greedy only; ignoring --temperature"
                  "/--top-k/--top-p/--seed")
        prompts, task_ids = static_batch(args, cfg.vocab_size, args.tasks)
        out = engine.generate(prompts, args.steps, task_ids)
        for i in range(args.requests):
            print(f"req {i} task={task_ids[i]}: {out[i].tolist()}")
        return out

    def on_token(req, tok):
        if not args.quiet:
            print(f"  [stream] req {req.rid} task={req.task_id} "
                  f"tok#{len(req.out)}: {tok}")

    if args.temperature > 0:
        print(f"sampling: temp={args.temperature} top_k={args.top_k} "
              f"top_p={args.top_p} (seeded per request)")
    arrivals = make_arrivals(args, cfg.vocab_size, args.tasks, on_token)
    if args.prefill_chunk > 0 and args.layout != "paged":
        print("warning: chunked prefill rides the unified paged serve step; "
              "--layout slots falls back to whole-prompt prefills")
        args.prefill_chunk = 0
    sched = serve(engine, args, arrivals)
    pool = sched.pool
    print(f"\nserved {len(sched.finished)} requests in {sched.ticks} real "
          f"ticks (+{sched.clock - sched.ticks} idle fast-forwarded): "
          f"{sched.steps_decoded} decode steps, {sched.prefill_chunks_run} "
          f"prefill chunks, {sched.tokens_emitted} tokens, "
          f"{engine.dispatches} dispatches, {args.slots} slots")
    if sched.paged:
        print(f"paged pool: {pool.num_blocks - 1} usable pages x "
              f"{pool.block_size} tokens, peak pages {pool.peak_pages}, "
              f"peak concurrency {sched.peak_running}, peak concurrent "
              f"prefills {sched.peak_prefills}, {sched.preemptions} "
              "preemptions")
    else:
        print(f"slot pool: {pool.num_slots} slots x {pool.alloc_len} "
              f"tokens, peak concurrency {sched.peak_running}")
    findings = sched.drain_check()
    if findings:
        print("DRAIN FAILED: KV pool leak findings at exit:", file=sys.stderr)
        for f in findings:
            print(f"  {f}", file=sys.stderr)
        sys.exit(1)
    for rid in sorted(sched.finished):
        req = sched.finished[rid]
        ms = (req.t_done - req.t_submit) * 1e3
        print(f"req {rid} task={req.task_id} plen={len(req.prompt)} "
              f"latency={ms:.0f}ms: {req.out}")
    return sched


if __name__ == "__main__":
    main()
