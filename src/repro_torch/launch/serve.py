"""Multi-task serving launcher of the port.

Loads fused AoT task tables exported by ``repro_torch.launch.export`` or
the reference's ``examples/fuse_and_export.py`` (``--load DIR``, one
checkpoint step per task) or fabricates them (``--demo``), and serves a
continuous stream of mixed-task requests from one frozen backbone:
requests arrive on the scheduler's tick clock as a Poisson process (or
``--arrivals bursty``, or ``--arrival-trace FILE``), carry a priority
class drawn from ``--priority-mix``, pick a task at random, and stream
their tokens through a callback as they decode. ``--layout`` picks the
paged KV pool (chunked prefill, or whole prompts with ``--prefill-chunk
0``) or contiguous slots (whole prompts); ``--static`` serves one static
batch of equal-length prompts instead (greedy). ``--system-prompt`` opens
every request of a task with the same prefix, which
``--prefix-cache-pages`` reuses across requests; ``--samples`` draws n
samples per request from one prefill. Overload: ``--max-queue`` bounds
the queue (a shed request is retried with exponential backoff,
``--backoff`` ** (attempt - 1) ticks, up to ``--max-retries`` times),
latency-class requests can carry ``--deadline-ticks``, and
``--grace-ticks`` hands the drain to ``Scheduler.shutdown``.
``--journal`` appends every request transition to a JSONL file,
``--crash-at-tick`` then simulates a process death at a tick (the journal
is replayed into a fresh scheduler, which serves on) and
``--restore-from`` replays a journal before serving. ``--metrics``,
``--metrics-out``, ``--trace-out`` and ``--torch-profile`` turn on the
serve path's metrics, SLO summary, tick trace and profiler bracket.
Runs on the card unless ``--device cpu`` is given. Exits non-zero if the
KV pool leaks.

    # on a GPU: full-width smollm-360m in bf16, four tasks
    PYTHONPATH=src python -m repro_torch.launch.serve --demo --tasks 4 \\
        --dtype bfloat16 --slots 8 --max-len 1024 --prefill-chunk 256
    # ... the slotted layout, or one static batch
    PYTHONPATH=src python -m repro_torch.launch.serve --demo --tasks 4 \\
        --dtype bfloat16 --slots 8 --max-len 1024 --layout slots
    PYTHONPATH=src python -m repro_torch.launch.serve --demo --tasks 4 \\
        --dtype bfloat16 --static --requests 16 --prompt 512 --steps 64 \\
        --max-len 1024

    # ... a shared system prompt with the prefix cache, n = 4 samples,
    # or a priority mix against a bounded queue
    PYTHONPATH=src python -m repro_torch.launch.serve --demo --tasks 4 \
        --dtype bfloat16 --slots 8 --max-len 1024 --prefill-chunk 256 \
        --system-prompt 384 --prompt 128 --prefix-cache-pages 128
    PYTHONPATH=src python -m repro_torch.launch.serve --demo --tasks 4 \
        --dtype bfloat16 --slots 8 --max-len 1024 --samples 4 \
        --temperature 0.8 --top-p 0.9
    PYTHONPATH=src python -m repro_torch.launch.serve --demo --tasks 4 \
        --dtype bfloat16 --slots 8 --max-len 1024 --max-queue 4 \
        --priority-mix latency=0.25,standard=0.5,best_effort=0.25
    # ... bursts against that queue, deadlines, a bounded drain
    PYTHONPATH=src python -m repro_torch.launch.serve --demo --tasks 4 \
        --dtype bfloat16 --slots 8 --max-len 1024 --max-queue 4 \
        --arrivals bursty --burst 6 --deadline-ticks 24 --grace-ticks 8
    # ... the tables that repro_torch.launch.export wrote
    PYTHONPATH=src python -m repro_torch.launch.serve --dtype bfloat16 \
        --slots 8 --max-len 1024 --load results/fused_artifacts

    # on the CPU, reduced widths; then a crash at tick 6 and a restore
    # from the journal, with the metrics and SLO summary at the end
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --demo --tasks 3 --requests 6
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --demo --tasks 3 --requests 6 --quiet --metrics \\
        --journal /tmp/serve.jsonl --crash-at-tick 6
"""
from __future__ import annotations

import argparse
import dataclasses
import heapq
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import aot as aot_mod
from repro_torch.models.model import Model, ModelOptions, check_servable
from repro_torch.obs import ServeObservability
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.faults import crash_restore
from repro_torch.serve.recovery import RequestJournal, replay_journal
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import (PRIORITIES, ContinuousScheduler,
                                         Request, SchedulerConfig, ShedError)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the arch to 2 layers and tiny widths")
    src = ap.add_argument_group("task tables (one of)")
    src.add_argument("--demo", action="store_true",
                     help="fabricate random task tables instead of loading")
    src.add_argument("--load", metavar="DIR",
                     help="load fused tables exported by repro_torch.launch."
                          "export or examples/fuse_and_export.py (one "
                          "checkpoint step per task, task id = step order)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu only "
                         "when asked for)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                    help="compute and parameter dtype (ModelOptions)")
    ap.add_argument("--tasks", type=int, default=3,
                    help="number of fabricated tasks (--demo only)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rate", type=float, default=0.5,
                    help="mean arrivals per tick (Poisson stream)")
    ovl = ap.add_argument_group("overload")
    ovl.add_argument("--arrivals", choices=("poisson", "bursty"),
                     default="poisson",
                     help="arrival process: poisson (independent "
                          "increments) or bursty (on/off bursts)")
    ovl.add_argument("--burst", type=int, default=6,
                     help="arrivals per burst (--arrivals bursty)")
    ovl.add_argument("--burst-gap", type=int, default=0,
                     help="quiet ticks between bursts (0 = derived from "
                          "--rate so the mean rate matches poisson)")
    ovl.add_argument("--arrival-trace", metavar="FILE",
                     help="trace-driven arrivals: one 'tick[,priority]' "
                          "line per request (overrides --arrivals/--rate)")
    ovl.add_argument("--deadline-ticks", type=int, default=0,
                     help="deadline of latency-class requests in real "
                          "ticks: past it a request is aborted and its "
                          "pages freed (0 = no deadlines)")
    ovl.add_argument("--max-retries", type=int, default=4,
                     help="client retries of a shed submission")
    ovl.add_argument("--backoff", type=int, default=2,
                     help="backoff base in ticks: retry k waits "
                          "backoff ** (k - 1) ticks")
    ovl.add_argument("--grace-ticks", type=int, default=-1,
                     help="once the stream ends, Scheduler.shutdown gives "
                          "in-flight work this many ticks and sheds the "
                          "rest (-1 = drain fully)")
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
    ap.add_argument("--prefix-cache-pages", type=int, default=0,
                    help="prefix-cache capacity in pages: finished requests' "
                         "full prompt pages are kept (LRU) and mapped into "
                         "later requests of the same task, whose prefill "
                         "starts at the first uncached token (needs "
                         "--layout paged and --prefill-chunk > 0; 0 = off)")
    ap.add_argument("--system-prompt", type=int, default=0,
                    help="open every request of a task with the same "
                         "seeded prefix of this many tokens (0 = none)")
    ap.add_argument("--priority-mix", metavar="SPEC", default="standard=1",
                    help="request class weights, e.g. "
                         "'latency=0.2,standard=0.5,best_effort=0.3'")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded admission queue: past this depth "
                         "submissions are shed (0 = unbounded)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy argmax; > 0 samples with per-request "
                         "seeded streams")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k highest logits (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = off)")
    ap.add_argument("--samples", type=int, default=1,
                    help="parallel samples per request (n > 1 shares the "
                         "prefill's pages copy-on-write; --layout paged)")
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
    rec = ap.add_argument_group("crash recovery (serve.recovery)")
    rec.add_argument("--journal", metavar="FILE",
                     help="append every request lifecycle transition "
                          "(submit/admit/emit/finish/shed/abort/"
                          "quarantine) to this JSONL file, enough to "
                          "replay the run after a crash")
    rec.add_argument("--restore-from", metavar="FILE",
                     help="before serving, replay this journal and "
                          "re-admit its live requests (their KV recomputed "
                          "from prompt + emitted tokens)")
    rec.add_argument("--crash-at-tick", type=int, default=0,
                     help="simulate a process death at this global tick: "
                          "abandon the scheduler, replay --journal into a "
                          "fresh one, serve on (0 = off; needs --journal)")
    obs_g = ap.add_argument_group("observability (repro_torch.obs)")
    obs_g.add_argument("--metrics", action="store_true",
                       help="collect serve-path metrics and request "
                            "lifecycles; print the snapshot and the "
                            "TTFT/TPOT/e2e SLO summary at drain")
    obs_g.add_argument("--metrics-out", metavar="FILE",
                       help="append the final metrics snapshot as one "
                            "JSONL line (implies --metrics)")
    obs_g.add_argument("--trace-out", metavar="FILE",
                       help="write a Chrome trace-event JSON of every "
                            "scheduler tick (admission / ensure_pages / "
                            "budget split / dispatch / postprocess spans)")
    obs_g.add_argument("--torch-profile", metavar="DIR",
                       help="bracket the run with torch.profiler (CPU and "
                            "CUDA) and export its trace into DIR; each tick "
                            "span is marked with record_function")
    obs_g.add_argument("--check-leaks", action="store_true",
                       help="sweep the KV pool's invariants at drain; "
                            "findings go into the metrics and fail the run")
    obs_g.add_argument("--slo-ttft-ticks", type=float, default=8.0,
                       help="TTFT SLO target in real ticks (attainment "
                            "reported with --metrics)")
    return ap


def load_tasks(cfg, directory: str, dtype=torch.float32,
               device="cuda") -> List[dict]:
    """The fused task tables under ``directory`` (one checkpoint step per
    task, as ``launch.export`` and the reference's example write them),
    task id = step order: each read to the host, copied to ``device`` and
    cast to ``dtype`` there before the next is read, so the host holds one
    float32 table at a time. The shapes are read from a meta ``like``, so
    nothing is allocated to learn them."""
    mgr = CheckpointManager(directory, async_save=False)
    steps = mgr.all_steps()
    if not steps:
        raise FileNotFoundError(
            f"no fused-table checkpoints under {directory!r}; run "
            "examples/fuse_and_export.py first (or pass --demo)")
    like = {"table": torch.empty(
        (cfg.num_layers, cfg.vocab_size, cfg.d_model), dtype=torch.float32,
        device="meta")}
    tasks = []
    for s in steps:
        tree, extra = mgr.restore(like, step=s)
        print(f"  step {s}: fused {extra.get('mode', '?')} tables "
              f"({extra.get('arch', '?')})")
        tasks.append({"table": tree["table"].to(device).to(dtype)})
        del tree
    return tasks


def build_engine(args) -> ServeEngine:
    """Model with random weights (seed 0) and the fused tables of
    ``--load`` (:func:`load_tasks`) or ``--tasks`` fabricated ones, on
    ``--device``."""
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg, repeats=2)
    check_servable(cfg)         # before the weights and tables are drawn
    dt = DTYPES[args.dtype]
    model = Model(cfg, ModelOptions(compute_dtype=dt, param_dtype=dt),
                  device=args.device)
    params = model.init(0)
    if args.load:
        tasks = load_tasks(cfg, args.load, dt, model.device)
    else:
        tasks = [aot_mod.random_fused(cfg, params["embed"]["tok"], seed=t,
                                      scale=0.03, vocab_chunk=4096, dtype=dt)
                 for t in range(args.tasks)]
    return ServeEngine(model, params, ServeConfig(max_len=args.max_len),
                       fused_tasks=aot_mod.stack_tasks(tasks))


def parse_priority_mix(spec: str):
    """``latency=0.2,standard=0.5,best_effort=0.3`` -> weights over the
    scheduler's priority classes, normalised (missing classes get 0)."""
    weights = {c: 0.0 for c in PRIORITIES}
    for part in spec.split(","):
        if not part.strip():
            continue
        name, _, val = part.partition("=")
        name = name.strip()
        if name not in weights:
            raise ValueError(f"unknown priority class {name!r} "
                             f"(choose from {', '.join(PRIORITIES)})")
        weights[name] = float(val)
    total = sum(weights.values())
    if total <= 0:
        raise ValueError(f"priority mix {spec!r} has no positive weight")
    return {c: w / total for c, w in weights.items()}


def bursty_ticks(rng, n: int, burst: int, gap: int) -> List[int]:
    """On/off arrivals: bursts of ``burst`` near-simultaneous arrivals
    (each at the burst's tick or the next) every ``max(gap, 1)`` ticks,
    the pattern that exercises shedding and displacement; sorted."""
    ticks, t = [], 0
    while len(ticks) < n:
        k = min(burst, n - len(ticks))
        ticks.extend(t + int(rng.integers(0, 2)) for _ in range(k))
        t += max(gap, 1)
    return sorted(ticks[:n])


def burst_gap(args) -> int:
    """``--burst-gap``, or (0) the gap that gives ``--rate`` arrivals per
    tick on average."""
    return args.burst_gap or max(int(args.burst / max(args.rate, 1e-6)), 1)


def load_arrival_trace(path: str, n: int):
    """A trace's first ``n`` requests, one ``tick[,priority]`` line each
    (``#`` comments and blank lines skipped): (ticks, classes), a class
    None where the line names none."""
    ticks, prios = [], []
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = [p.strip() for p in line.split(",")]
            ticks.append(int(parts[0]))
            prios.append(parts[1] if len(parts) > 1 and parts[1] else None)
            if len(ticks) == n:
                break
    if not ticks:
        raise ValueError(f"arrival trace {path!r} is empty")
    return ticks, prios


def make_arrivals(args, vocab_size: int, n_tasks: int,
                  on_token=None) -> List[Tuple[int, Request]]:
    """The stream, drawn from ``default_rng(0)`` in the reference
    launcher's order (so the same flags give the same requests): the
    arrival ticks (exponential gaps, ``bursty_ticks``, or none for a
    trace, which also cuts ``--requests`` to its length), then each
    task's system prompt, then per request its prompt length, class (no
    draw where the trace names one), task, prompt and length.
    Latency-class requests carry ``--deadline-ticks`` when it is > 0.
    Raises ValueError for a trace class outside ``PRIORITIES``."""
    rng = np.random.default_rng(0)
    n = args.requests
    trace_prios = [None] * n
    if args.arrival_trace:
        ticks, trace_prios = load_arrival_trace(args.arrival_trace, n)
        n = len(ticks)
    elif args.arrivals == "bursty":
        ticks = bursty_ticks(rng, n, args.burst, burst_gap(args))
    else:
        ticks, t = [], 0.0
        for _ in range(n):
            t += rng.exponential(1.0 / max(args.rate, 1e-6))
            ticks.append(int(t))
    mix = parse_priority_mix(args.priority_mix)
    classes = list(mix)
    weights = [mix[c] for c in classes]
    sys_prompts = {}
    if args.system_prompt > 0:
        sys_prompts = {t: rng.integers(0, vocab_size, args.system_prompt)
                       .astype(np.int32) for t in range(n_tasks)}
    sampling = None
    if args.temperature > 0 or args.samples > 1:
        sampling = SamplingParams(temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p,
                                  n=args.samples)
    arrivals = []
    for i in range(n):
        plen = int(rng.integers(4, args.prompt + 1))
        prio = trace_prios[i] or str(rng.choice(classes, p=weights))
        if prio not in PRIORITIES:
            raise ValueError(f"arrival trace priority {prio!r} is not one "
                             f"of {', '.join(PRIORITIES)}")
        task = int(rng.integers(0, n_tasks))
        prompt = rng.integers(0, vocab_size, plen).astype(np.int32)
        if sys_prompts:
            prompt = np.concatenate([sys_prompts[task], prompt])
        req = Request(
            rid=i, prompt=prompt, task_id=task,
            max_new_tokens=int(rng.integers(2, args.steps + 1)),
            priority=prio, on_token=on_token,
            deadline_ticks=(args.deadline_ticks
                            if args.deadline_ticks > 0 and prio == "latency"
                            else None),
            sampling=None if sampling is None
            else dataclasses.replace(sampling, seed=args.seed + i))
        arrivals.append((ticks[i], req))
    return arrivals


def make_obs(args) -> Optional[ServeObservability]:
    """The observability bundle the flags ask for (None: none)."""
    if not (args.metrics or args.metrics_out or args.trace_out
            or args.torch_profile or args.check_leaks):
        return None
    return ServeObservability(
        metrics=bool(args.metrics or args.metrics_out),
        trace=bool(args.trace_out), profile_dir=args.torch_profile,
        check_leaks=args.check_leaks)


def make_scheduler(engine: ServeEngine, args, obs=None,
                   journal=None) -> ContinuousScheduler:
    """A fresh scheduler over ``engine`` as the flags configure it,
    reporting to ``obs`` and journaling to ``journal``."""
    return ContinuousScheduler(engine, SchedulerConfig(
        num_slots=args.slots, kv_layout=args.layout,
        block_size=args.block_size, num_blocks=args.num_blocks,
        prefill_chunk=args.prefill_chunk, max_prefills=args.max_prefills,
        prefix_cache_pages=args.prefix_cache_pages,
        max_queue=args.max_queue), obs=obs, journal=journal)


def run_with_retries(sched: ContinuousScheduler, arrivals,
                     grace_ticks: int = -1, max_retries: int = 4,
                     backoff: int = 2, crash_at_tick: int = 0,
                     make_sched=None, on_token=None):
    """The client loop of the reference launcher: submit each request on
    its arrival tick; a shed request (``ShedError`` at submit, or later
    displaced from the queue, found in ``sched.shed`` after each tick) is
    submitted again ``backoff ** (attempt - 1)`` ticks later, up to
    ``max_retries`` times. Idle gaps fast-forward as in ``run_stream``,
    which this equals when nothing is shed. When the stream ends,
    ``grace_ticks >= 0`` hands the drain to ``Scheduler.shutdown`` (work
    still live after that many ticks is shed and reported); ``-1`` serves
    to the end.

    ``crash_at_tick > 0`` with ``make_sched`` (a zero-argument factory of
    a fresh scheduler journaling to the same path) simulates a process
    death once, after that many ticks counted across the run: the
    scheduler is abandoned where it stands, its journal replayed and the
    factory's scheduler restored (``on_token`` attached to the restored
    requests), which serves on. Returns (the rids that gave up, the number
    of retries, the ``DrainReport`` or None, the scheduler that finished
    the run)."""
    heap = [(t, i, req) for i, (t, req) in enumerate(arrivals)]
    heapq.heapify(heap)
    seq = len(heap)
    attempts = {}                       # rid -> submissions so far
    pending = {req.rid for _, _, req in heap}   # waiting to be submitted
    gave_up, retries = [], 0
    gt = 0                              # global tick, survives the crash

    def requeue(req):
        nonlocal seq, retries
        if attempts[req.rid] > max_retries:
            if req.rid not in gave_up:
                gave_up.append(req.rid)
            return
        retries += 1
        heapq.heappush(heap, (sched.clock + backoff ** (attempts[req.rid] - 1),
                              seq, req))
        seq += 1
        pending.add(req.rid)

    while heap:
        if not sched.busy() and heap[0][0] > sched.clock:
            sched.clock = heap[0][0]     # idle: fast-forward
        while heap and heap[0][0] <= sched.clock:
            _, _, req = heapq.heappop(heap)
            pending.discard(req.rid)
            attempts[req.rid] = attempts.get(req.rid, 0) + 1
            try:
                sched.submit(req)
            except ShedError:
                requeue(req)
        sched.step()
        gt += 1
        if crash_at_tick and gt == crash_at_tick and make_sched is not None:
            sched, snap, counts = crash_restore(sched, make_sched, on_token)
            print(f"simulated crash at tick {gt}: replayed journal "
                  f"{sched.journal.path} ({len(snap['requests'])} requests, "
                  f"{counts['live']} live re-admitted through prefill "
                  "replay)")
        for rid in [r for r in sched.shed if r not in pending]:
            requeue(sched.shed[rid])     # displaced: the client resubmits
    if grace_ticks >= 0:
        return gave_up, retries, sched.shutdown(grace_ticks), sched
    while sched.busy():
        sched.step()
    sched._maybe_check_leaks()
    return gave_up, retries, None, sched


def serve(engine: ServeEngine, args, arrivals) -> ContinuousScheduler:
    """Serve the stream on a fresh scheduler through the client loop
    (:func:`run_with_retries`) with the flags' retry policy and drain;
    returns the scheduler."""
    return run_with_retries(make_scheduler(engine, args), arrivals,
                            grace_ticks=args.grace_ticks,
                            max_retries=args.max_retries,
                            backoff=args.backoff)[3]


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
    if not args.demo and not args.load:
        ap.error("pass --demo (fabricated tables) or --load DIR (fused "
                 "tables from repro_torch.launch.export or examples/"
                 "fuse_and_export.py)")
    if args.system_prompt + args.prompt + args.steps - 1 > args.max_len:
        ap.error(f"--system-prompt {args.system_prompt} + --prompt "
                 f"{args.prompt} + --steps {args.steps} cannot fit "
                 f"--max-len {args.max_len}")
    if args.prefix_cache_pages > 0 and (args.layout != "paged"
                                        or args.prefill_chunk <= 0):
        ap.error(f"--prefix-cache-pages {args.prefix_cache_pages} needs "
                 "--layout paged with --prefill-chunk > 0 (cached pages are "
                 "mapped through block tables and prefill resumes at the "
                 "first uncached token)")
    if args.samples > 1 and args.layout != "paged":
        ap.error(f"--samples {args.samples} needs --layout paged (the "
                 "samples share the prefill's pages copy-on-write)")
    if args.crash_at_tick > 0 and not args.journal:
        ap.error("--crash-at-tick needs --journal (recovery replays the "
                 "journal; without one there is nothing to restore from)")
    try:
        parse_priority_mix(args.priority_mix)
    except ValueError as e:
        ap.error(str(e))
    engine = build_engine(args)
    cfg = engine.model.cfg
    n_tasks = engine.num_tasks
    mb = aot_mod.table_bytes(cfg, n_tasks,
                             engine.tables.element_size()) / 1e6
    print(f"serving {n_tasks} tasks on {engine.device}; fused tables "
          f"{mb:.1f} MB")

    if args.static:
        if args.temperature > 0 or args.samples > 1 or args.top_k > 0 \
                or args.top_p < 1.0:
            print("warning: --static is greedy single-sample only; "
                  "ignoring --temperature/--top-k/--top-p/--samples/--seed")
        prompts, task_ids = static_batch(args, cfg.vocab_size, n_tasks)
        out = engine.generate(prompts, args.steps, task_ids)
        for i in range(args.requests):
            print(f"req {i} task={task_ids[i]}: {out[i].tolist()}")
        return out

    def on_token(req, tok):
        if not args.quiet:
            print(f"  [stream] req {req.rid} task={req.task_id} "
                  f"tok#{len(req.out)}: {tok}")

    if args.temperature > 0 or args.samples > 1:
        print(f"sampling: temp={args.temperature} top_k={args.top_k} "
              f"top_p={args.top_p} n={args.samples} (seeded per request)")
    try:
        arrivals = make_arrivals(args, cfg.vocab_size, n_tasks, on_token)
    except ValueError as e:
        ap.error(str(e))
    if args.arrival_trace:
        if len(arrivals) < args.requests:
            print(f"arrival trace has {len(arrivals)} entries; truncating "
                  f"--requests {args.requests} to match")
        print(f"trace-driven arrivals from {args.arrival_trace} "
              f"({len(arrivals)} requests)")
    elif args.arrivals == "bursty":
        print(f"bursty arrivals: bursts of {args.burst} every "
              f"{burst_gap(args)} ticks")
    if args.prefill_chunk > 0 and args.layout != "paged":
        print("warning: chunked prefill rides the unified paged serve step; "
              "--layout slots falls back to whole-prompt prefills")
        args.prefill_chunk = 0
    obs = make_obs(args)

    def make_sched():
        journal = RequestJournal(args.journal) if args.journal else None
        return make_scheduler(engine, args, obs, journal)

    sched = make_sched()
    if args.restore_from:
        snap = replay_journal(args.restore_from)
        counts = sched.restore(snap, on_token=on_token)
        print(f"restored from journal {args.restore_from}: "
              f"{len(snap['requests'])} requests replayed, {counts['live']} "
              "live re-admitted through prefill replay")
    if obs is not None:
        obs.tracer.start()          # nothing without --torch-profile
    try:
        gave_up, retries, drain_report, sched = run_with_retries(
            sched, arrivals, grace_ticks=args.grace_ticks,
            max_retries=args.max_retries, backoff=args.backoff,
            crash_at_tick=args.crash_at_tick,
            make_sched=make_sched if args.journal else None,
            on_token=on_token)
    finally:
        if obs is not None:
            prof = obs.tracer.stop()
            if prof:
                print(f"torch.profiler trace -> {prof}")
            if args.trace_out:
                obs.tracer.write(args.trace_out)
                print(f"tick trace -> {args.trace_out} "
                      f"({len(obs.tracer.events)} events; load in "
                      "chrome://tracing or ui.perfetto.dev)")
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
              f"preemptions, {pool.forks} forks, {pool.cow_copies} COW page "
              f"copies, {pool.compactions} compactions ({pool.pages_deduped} "
              "pages deduplicated)")
        cache = pool.prefix_cache
        if cache is not None:
            print(f"prefix cache ({cache.capacity} pages): {cache.hits}/"
                  f"{cache.hits + cache.misses} admissions hit, "
                  f"{cache.hit_tokens} prefill tokens skipped, "
                  f"{cache.retained_pages} pages retained, "
                  f"{cache.evicted_pages} evicted, {len(cache)} resident "
                  "at exit")
    else:
        print(f"slot pool: {pool.num_slots} slots x {pool.alloc_len} "
              f"tokens, peak concurrency {sched.peak_running}")
    print_overload(args, sched, gave_up, retries, drain_report)
    if args.journal:
        j = sched.journal
        print(f"journal {args.journal}: {j.events_written} events, "
              f"{j.bytes_written} bytes this run")
        j.close()
    if obs is not None and obs.metrics.enabled:
        print_slo(obs, args, sched)
    findings = sched.drain_check()
    if drain_report is not None:
        findings = sorted(set(findings) | set(drain_report.leak_findings))
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


def print_overload(args, sched, gave_up, retries, drain_report) -> None:
    """The overload and shutdown lines, as the reference launcher prints
    them: retries and requests that gave up, deadline misses, aborts by
    reason, the drain report, quarantined requests."""
    if retries or gave_up or sched.shed or sched.aborted:
        print(f"overload: {retries} shed retries (backoff base "
              f"{args.backoff}), {len(gave_up)} requests gave up after "
              f"{args.max_retries} retries "
              f"{sorted(gave_up) if gave_up else ''}".rstrip())
        if sched.deadline_misses:
            print(f"  {sched.deadline_misses} deadline misses "
                  f"(--deadline-ticks {args.deadline_ticks}); pages freed "
                  "at abort")
        if sched.aborted:
            reasons = {}
            for r in sched.aborted.values():
                reasons[r.finish_reason] = reasons.get(r.finish_reason, 0) + 1
            print(f"  aborted in flight: {dict(sorted(reasons.items()))}")
    if drain_report is not None:
        shed = drain_report.shed_rids
        print(f"shutdown(grace={args.grace_ticks}): finished "
              f"{drain_report.finished}, used {drain_report.grace_ticks_used}"
              f" grace ticks, released {drain_report.cache_pages_released} "
              f"cached prefix pages, shed {len(shed)} in-flight "
              f"{shed if shed else ''}".rstrip())
    if sched.quarantined:
        print(f"quarantined {len(sched.quarantined)} poisoned requests "
              f"{sorted(sched.quarantined)}; their pages were held for "
              "forensics and released at shutdown")


def print_slo(obs: ServeObservability, args, sched) -> None:
    """The SLO summary in ticks and in ms (never mixed), per class when
    several ran, and the metrics snapshot (``--metrics``) or its JSONL
    line (``--metrics-out``), as the reference launcher prints them."""
    summary = obs.slo.summary(targets={"ttft_ticks": args.slo_ttft_ticks})
    tick = {k: v for k, v in summary.items() if k.endswith("_ticks")}
    wall = {k: v for k, v in summary.items() if k.endswith("_ms")}
    print("\nSLO summary (real-tick series, load-invariant):")
    for k, v in tick.items():
        print(f"  {k:>18}: p50={v['p50']:g} p95={v['p95']:g} "
              f"p99={v['p99']:g}")
    print("SLO summary (wall-clock series, ms; a token is stamped after "
          "its tick's download, so the device time is in):")
    for k, v in wall.items():
        print(f"  {k:>18}: p50={v['p50']:g} p95={v['p95']:g} "
              f"p99={v['p99']:g}")
    for name, frac in summary.get("slo_attainment", {}).items():
        print(f"  attainment {name}: {frac:.1%}")
    by_class = summary.get("by_class", {})
    if by_class:
        print("per-class SLO (real-tick series):")
        for cls, c in by_class.items():
            parts = [f"requests={c.get('requests', 0)}"]
            for key in ("ttft_ticks", "tpot_ticks"):
                if key in c:
                    parts.append(f"{key} p50={c[key]['p50']:g} "
                                 f"p95={c[key]['p95']:g}")
            if c.get("shed"):
                parts.append(f"shed={c['shed']}")
            if c.get("aborted"):
                parts.append(f"aborted={c['aborted']}")
            print(f"  {cls:>12}: " + " ".join(parts))
            for name, frac in c.get("slo_attainment", {}).items():
                print(f"  {'':>12}  attainment {name}: {frac:.1%}")
    if summary.get("sheds"):
        print(f"  sheds: {summary['sheds']} "
              f"(by class: {summary.get('sheds_by_class', {})})")
    pcs = summary.get("prefix_cache")
    if pcs:
        print("prefix-cache TTFT (real-tick series): "
              f"warm p50={pcs['warm_ttft_ticks']['p50']:g} "
              f"({pcs['warm_requests']} requests) vs "
              f"cold p50={pcs['cold_ttft_ticks']['p50']:g} "
              f"({pcs['cold_requests']} requests); "
              f"{pcs['cached_tokens']} prompt tokens served from cache")
    if args.metrics_out:
        obs.metrics.write_jsonl(args.metrics_out, extra={
            "slo": summary, "ticks": sched.ticks,
            "idle_fast_forward": sched.clock - sched.ticks})
        print(f"metrics JSONL -> {args.metrics_out}")
    if args.metrics:
        print("\nmetrics snapshot (prometheus text):")
        print(obs.metrics.prometheus_text())


if __name__ == "__main__":
    main()
