"""Continuous-batching scheduler: queue -> admit -> prefill -> decode ->
finish, over a paged or a contiguous (slotted) KV pool.

Counterpart of ``repro.serve.scheduler``. Each request carries its own
task, prompt, ``max_new_tokens`` and priority class; requests join between
ticks.

- ``kv_layout="paged"`` (the default): every tick is ONE
  ``ServeEngine.serve_step`` call over a ragged packed token list, each
  decode row contributing its fed-back token. With ``prefill_chunk > 0``
  each of up to ``max_prefills`` in-flight prefills adds its next prompt
  chunk: the per-tick chunk budget is split class by class,
  shortest-remaining-first, with the oldest prefill of each class
  guaranteed a ``budget / max_prefills`` slice so that short prompts can
  never starve it. With ``prefill_chunk = 0`` (the default, as in the
  reference) a prompt is admitted whole: one bucket-padded
  ``prefill_request`` whose cache is scattered into the slot's pages. When
  the pool runs out of pages mid-decode the worst class's newest request
  is preempted (freed and requeued) and later recomputed; the
  counter-based sampling streams make the recompute replay the same draws.
- ``kv_layout="slots"``: whole-prompt admission into a contiguous slot,
  then one ``decode_mixed`` call over every slot per tick.

Pages are shared three ways on the paged layout. A request with ``n > 1``
samples prefills once and its samples fork the slot copy-on-write
(``PagedKVPool.fork``). With ``prefix_cache_pages > 0`` (chunked prefill)
a finishing request's full prompt pages stay in a ``PrefixCache`` and a
later request of the same task maps its longest cached prefix, its
prefill starting at the first uncached token. When a chunked admission is
short of pages, ``PagedKVPool.compact`` first folds duplicate prompt
pages of the running rows together; only then does a queued request
preempt a row of a strictly worse class.

Admission is strict-priority across the classes ``latency``,
``standard`` and ``best_effort`` (FIFO within one); ``max_queue`` bounds
the queue, shedding a submission (``ShedError``, reason ``queue_full``)
unless it outranks and displaces the newest waiter of a worse class
(``displaced``). The oldest admitted row of each class is the last to be
preempted, so under page pressure someone of every class finishes.

The paged tick heals itself. A dispatch that raises is repacked and
retried, up to ``tick_retries`` times, then re-raised; a request whose
reported logits row is not finite is quarantined (its pages held off the
free list) and the tick is retried with the survivors. The model writes
the pool in place, yet the retry is exact: a tick writes only rows that no
reader trusts yet, into pages no one else holds, and rewrites each before
reading it (the write-fresh rule of ``Model.mixed_step``, checked on the
host every tick). ``abort`` cancels a request in any state (a fork group
whole), ``deadline_ticks`` aborts one that has not finished in time, and
``shutdown`` drains, aborts what is left, flushes the prefix cache and
sweeps the pool. ``serve.faults`` drives all of it from a seeded plan.

A crash is recovered from the request journal (``journal=``, a
``serve.recovery.RequestJournal``): every lifecycle transition is one
flushed JSONL line, ``serve.recovery.replay_journal`` rebuilds a snapshot
from it, and :meth:`restore` re-admits the survivors into a fresh
scheduler through the preempt-and-recompute path (:meth:`snapshot` makes
the same snapshot from a live scheduler). No KV page is serialised.

``obs=`` (a ``repro_torch.obs.ServeObservability``) turns on the
reference's metrics, per-tick trace spans (``admission``,
``ensure_pages``, ``pack_budget_split``, ``dispatch``, ``postprocess``)
and SLO lifecycles. Every hook reads host values the scheduler already
holds, so observability on or off gives the same tokens.
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.models.model import (check_write_exclusive, check_write_fresh,
                                      recurrent_kinds)
from repro_torch.obs import NULL_OBS, ServeObservability
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv_pool import PagedKVPool, SlotKVPool
from repro_torch.serve.recovery import (NULL_JOURNAL, RequestJournal,
                                        scheduler_restore, scheduler_snapshot)
from repro_torch.serve.sampling import SamplingParams, request_base_key

QUEUED, RUNNING, FINISHED = "queued", "running", "finished"
ABORTED, SHED, QUARANTINED = "aborted", "shed", "quarantined"
# every state a request can end in
TERMINAL_STATES = (FINISHED, SHED, ABORTED, QUARANTINED)

# priority classes, best first
LATENCY, STANDARD, BEST_EFFORT = "latency", "standard", "best_effort"
PRIORITIES = (LATENCY, STANDARD, BEST_EFFORT)
PRIORITY_RANK = {c: i for i, c in enumerate(PRIORITIES)}


class InvalidRequest(ValueError):
    """A malformed submission, rejected at ``submit()``."""


class InvalidConfig(ValueError):
    """A malformed :class:`SchedulerConfig` knob or scheduler argument."""


class ShedError(RuntimeError):
    """The scheduler refused an admissible request: the bounded queue is
    full (``reason="queue_full"``), a better class displaced it from the
    queue (``"displaced"``, recorded in ``shed``, never raised), or the
    scheduler is draining (``"shutting_down"``)."""

    def __init__(self, rid: int, reason: str):
        super().__init__(f"request {rid} shed: {reason}")
        self.rid = rid
        self.reason = reason


def _check_count(name: str, v, minimum: int) -> int:
    if isinstance(v, bool) or not isinstance(
            v, (int, float, np.integer, np.floating)):
        raise InvalidConfig(f"{name} must be an integer (got {v!r})")
    f = float(v)
    if not math.isfinite(f) or f != int(f):
        raise InvalidConfig(f"{name} must be a finite integer (got {v!r})")
    if int(f) < minimum:
        raise InvalidConfig(f"{name} must be >= {minimum} (got {v!r})")
    return int(f)


class _ClassQueues:
    """The admission queue, one FIFO per priority class, served in class
    order. It has the deque surface the scheduler uses (``len``, ``[0]``,
    ``append``, ``appendleft``, ``popleft``, iteration); ``appendleft``
    fronts the request's own class, where a preempted request keeps its
    place."""

    def __init__(self):
        self._q: Dict[str, deque] = {c: deque() for c in PRIORITIES}

    def __len__(self) -> int:
        return sum(len(q) for q in self._q.values())

    def __bool__(self) -> bool:
        return any(self._q.values())

    def __iter__(self):
        for c in PRIORITIES:
            yield from self._q[c]

    def __getitem__(self, i: int) -> "Request":
        if i != 0:
            raise IndexError("class queue exposes only the head")
        for c in PRIORITIES:
            if self._q[c]:
                return self._q[c][0]
        raise IndexError("empty queue")

    def append(self, req: "Request") -> None:
        self._q[req.priority].append(req)

    def appendleft(self, req: "Request") -> None:
        self._q[req.priority].appendleft(req)

    def popleft(self) -> "Request":
        for c in PRIORITIES:
            if self._q[c]:
                return self._q[c].popleft()
        raise IndexError("empty queue")

    def remove(self, req: "Request") -> None:
        # by identity: Request's dataclass __eq__ would compare numpy
        # prompts (an ambiguous truth value)
        q = self._q[req.priority]
        for i, r in enumerate(q):
            if r is req:
                del q[i]
                return
        raise ValueError(f"request {req.rid} is not queued")

    def worst(self) -> Optional["Request"]:
        """The displacement victim: the newest request of the worst
        non-empty class."""
        for c in reversed(PRIORITIES):
            if self._q[c]:
                return self._q[c][-1]
        return None


@dataclass
class Request:
    """One serving request. ``on_token`` streams tokens as they decode;
    ``sampling`` None is greedy. With ``sampling.n > 1`` each sample runs
    as a child request (``parent`` and ``sample_idx`` set, the same
    ``rid``), forked from the one prefill; the finished request's
    ``samples`` holds every sample's tokens and ``out`` sample 0's, and
    ``on_token`` receives the children."""
    rid: int
    prompt: np.ndarray                  # (s,) int32
    task_id: int = 0
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    on_token: Optional[Callable[["Request", int], None]] = None
    sampling: Optional[SamplingParams] = None
    priority: str = STANDARD            # latency | standard | best_effort
    deadline_ticks: Optional[int] = None  # aborted unless finished within
                                          # this many ticks of submission
    # filled in by the scheduler
    out: List[int] = field(default_factory=list)
    state: str = QUEUED
    slot: int = -1
    finish_reason: str = ""             # "" (completed) | deadline | client |
                                        # disconnect | shutdown | nan_logits
                                        # | shutting_down | queue_full
                                        # | displaced
    submit_tick: int = 0                # scheduler tick at submit
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    # n > 1: the parent gathers its children's tokens
    samples: Optional[List[Optional[List[int]]]] = None
    parent: Optional["Request"] = None
    sample_idx: int = 0


@dataclass(frozen=True)
class SchedulerConfig:
    num_slots: int = 8                  # batch width (decode rows)
    bucket_min: int = 16                # smallest prefill bucket (doubles up)
    admit_per_step: int = 0             # whole-prompt admissions per tick
                                        # (0 = fill every free slot)
    kv_layout: str = "paged"            # "paged" | "slots"
    block_size: int = 16                # KV page size in tokens (paged)
    num_blocks: int = 0                 # physical pages incl. scratch page 0
                                        # (0 = capacity parity with slots)
    prefill_chunk: int = 0              # per-tick prefill TOKEN BUDGET, split
                                        # across in-flight prefills (paged
                                        # only; 0 = whole-prompt admission)
    max_prefills: int = 4               # cap on concurrently chunking prefills
    prefix_cache_pages: int = 0         # prefix-cache capacity in pages
                                        # (paged with prefill_chunk > 0;
                                        # 0 = off)
    max_queue: int = 0                  # bounded admission queue: submits
                                        # past this many waiters are shed
                                        # unless they displace a worse
                                        # class (0 = unbounded)
    tick_retries: int = 2               # retries of one paged tick after a
                                        # raised dispatch before the fault
                                        # is re-raised (a quarantine's
                                        # retry needs none)


@dataclass
class _Prefill:
    """A chunked prefill in flight: the request holds its slot and pages
    while its prompt streams through the tick's single call chunk by chunk."""
    req: Request
    slot: int
    toks: np.ndarray                    # (s,) the tokens to prefill
    length: int                         # == len(toks): prompt [+ recompute]
    done: int = 0                       # tokens resident so far

    @property
    def remaining(self) -> int:
        return self.length - self.done


@dataclass
class DrainReport:
    """What :meth:`ContinuousScheduler.shutdown` did with the work left."""
    finished: int                       # requests completed overall
    shed_rids: List[int]                # rids aborted when the grace ended
    grace_ticks_used: int               # ticks spent draining
    leak_findings: List[str]            # pool invariant sweep (empty = clean)
    cache_pages_released: int = 0       # prefix-cache pages flushed back
    quarantined_pages_released: int = 0  # the quarantine hold, freed

    @property
    def clean(self) -> bool:
        return not self.leak_findings


class ContinuousScheduler:
    """Drives a ServeEngine and a KV pool over an online stream."""

    def __init__(self, engine: ServeEngine,
                 cfg: Optional[SchedulerConfig] = None,
                 obs: Optional[ServeObservability] = None,
                 journal: Optional[RequestJournal] = None):
        cfg = cfg if cfg is not None else SchedulerConfig()
        for knob, lo in (("num_slots", 1), ("bucket_min", 1),
                         ("admit_per_step", 0), ("block_size", 1),
                         ("num_blocks", 0), ("prefill_chunk", 0),
                         ("max_prefills", 1), ("prefix_cache_pages", 0),
                         ("max_queue", 0), ("tick_retries", 0)):
            _check_count(f"SchedulerConfig.{knob}", getattr(cfg, knob), lo)
        if cfg.kv_layout not in ("paged", "slots"):
            raise InvalidConfig(f"SchedulerConfig.kv_layout must be 'paged' "
                                f"or 'slots' (got {cfg.kv_layout!r})")
        if cfg.prefill_chunk > 0 and cfg.kv_layout == "slots":
            raise InvalidConfig(
                "chunked prefill rides the unified paged serve step; "
                "kv_layout='slots' serves whole-prompt prefills only")
        if cfg.prefix_cache_pages > 0 and not (
                cfg.kv_layout == "paged" and cfg.prefill_chunk > 0):
            raise InvalidConfig(
                "the prefix cache maps cached pages into block tables and "
                "starts prefill at the first uncached token: it needs "
                "kv_layout='paged' with chunked prefill (prefill_chunk > 0)")
        mcfg = engine.model.cfg
        if mcfg.prefix_lm_len:
            raise InvalidConfig(
                f"{mcfg.name}: a bidirectional prefix ({mcfg.prefix_lm_len} "
                "tokens) attends to bucket padding; continuous batching "
                "needs fully-causal attention")
        method = engine.peft["method"] if engine.peft else "none"
        if method in ("ptv1", "ptv2"):
            raise InvalidConfig(
                f"{method}: prompt/prefix tuning changes the cache layout "
                "per request; serve it with static batches")
        kinds = recurrent_kinds(engine.model.cfg)
        if kinds:
            raise InvalidConfig(
                f"{engine.model.cfg.name}: recurrent blocks ({set(kinds)}) "
                "fold bucket padding into their state; continuous batching "
                "needs attention-only stacks (or exact-length prefill) for "
                "now: serve them with static batches")
        if cfg.kv_layout == "paged" and engine.model.window():
            raise InvalidConfig(
                f"{engine.model.cfg.name}: paged decode has no "
                "sliding-window masking yet; serve SWA models with "
                "kv_layout='slots'")
        self.engine = engine
        self.cfg = cfg
        self.max_len = engine.cfg.max_len
        self.paged = cfg.kv_layout == "paged"
        if self.paged:
            self.pool = PagedKVPool(engine.model, cfg.num_slots, self.max_len,
                                    block_size=cfg.block_size,
                                    num_blocks=cfg.num_blocks or None)
            if cfg.prefix_cache_pages > 0:
                self.pool.enable_prefix_cache(cfg.prefix_cache_pages)
        else:
            self.pool = SlotKVPool(engine.model, cfg.num_slots, self.max_len)
        self.queue = _ClassQueues()
        self.running: Dict[int, Request] = {}        # slot -> request
        self.finished: Dict[int, Request] = {}       # rid -> request
        self.aborted: Dict[int, Request] = {}        # client, disconnect,
                                                     # deadline, shutdown
        self.shed: Dict[int, Request] = {}           # refused or displaced
        self.quarantined: Dict[int, Request] = {}    # non-finite logits
        self.deadline_misses = 0
        self.dispatch_faults = 0        # serve_step calls that raised
        self.tick_retries_used = 0      # retry passes of the tick loop
        # the append-only lifecycle journal (crash recovery); the null one
        # by default, whose hooks do nothing
        self.journal = journal if journal is not None else NULL_JOURNAL
        self._draining = False
        self.slot_tokens = np.zeros((cfg.num_slots, 1), np.int32)
        # per-slot sampling vectors, threaded into serve_step
        self.slot_temps = np.zeros(cfg.num_slots, np.float32)
        self.slot_topk = np.zeros(cfg.num_slots, np.int32)
        self.slot_topp = np.ones(cfg.num_slots, np.float32)
        self.slot_keys = np.zeros((cfg.num_slots, 2), np.uint32)
        self.slot_steps = np.zeros(cfg.num_slots, np.int32)
        self.clock = 0                  # arrival clock (fast-forwards idle)
        self.ticks = 0                  # real step() calls
        self.steps_decoded = 0
        self.tokens_emitted = 0
        self.preemptions = 0
        self.prefill_chunks_run = 0
        self.peak_running = 0
        self.peak_prefills = 0
        # chunked prefills in flight, admission order (newest last)
        self._prefills: List[_Prefill] = []
        self._admit_seq: Dict[int, int] = {}         # slot -> admission order
        self._seq = 0
        # static per-tick chunk budget: chunk ticks pack to one width
        self._qw = max(1, cfg.prefill_chunk)
        # observability: NULL_OBS hands out no-op instruments; real ones
        # read host values only, never a device tensor
        self.obs = obs if obs is not None else NULL_OBS
        if self.obs.metrics.enabled:
            self.pool.attach_metrics(self.obs.metrics)
            engine.attach_metrics(self.obs.metrics)
        m = self.obs.metrics
        self._m_ticks = m.counter(
            "sched_ticks_total", "real step() calls (no idle fast-forward)")
        self._m_tokens = m.counter(
            "sched_tokens_emitted_total", "generated tokens streamed out")
        self._m_submitted = m.counter(
            "sched_requests_submitted_total", "requests entering the queue")
        self._m_admitted = m.counter(
            "sched_admissions_total", "queue departures (slot+pages claimed; "
            "recomputes re-admit)")
        self._m_finished = m.counter(
            "sched_requests_finished_total", "requests (or sample children) "
            "completed")
        self._m_preempt = m.counter(
            "sched_preemptions_total", "decode rows preempted for pages")
        self._m_aborts = m.counter(
            "sched_prefill_aborts_total", "in-flight prefills aborted for "
            "pages")
        self._m_chunks = m.counter(
            "sched_prefill_chunks_total", "prefill chunks advanced")
        self._m_queue = m.gauge("sched_queue_depth", "requests waiting")
        self._m_running = m.gauge("sched_running", "decode rows in flight")
        self._m_inflight_pf = m.gauge(
            "sched_prefills_inflight", "prompts mid-chunking")
        self._m_peak_running = m.gauge(
            "sched_peak_running", "high-water decode concurrency")
        self._m_peak_pf = m.gauge(
            "sched_peak_prefills", "high-water concurrent prefills")
        self._m_tick_tokens = m.histogram(
            "sched_tick_packed_tokens", [1, 2, 4, 8, 16, 32, 64, 128, 256],
            "real (non-dead) tokens advanced per tick")
        self._m_tick_ms = m.histogram(
            "sched_tick_wall_ms", [1, 2, 5, 10, 20, 50, 100, 200, 500, 1000],
            "wall ms per tick (the first ticks include kernel builds)")
        self._m_leaks = m.gauge(
            "kv_leak_findings", "drain-time pool invariant violations "
            "(0 = clean; see ContinuousScheduler.drain_check)")
        self._m_shed = m.counter(
            "sched_shed_total", "submissions refused or displaced from the "
            "bounded queue (see sched_shed_<reason>_total)")
        self._m_client_aborts = m.counter(
            "sched_aborts_total", "requests cancelled via abort() — client "
            "aborts, disconnects, deadline misses, shutdown sheds")
        self._m_deadline = m.counter(
            "sched_deadline_misses_total", "requests aborted past their "
            "deadline_ticks budget")
        self._m_invalid = m.counter(
            "sched_invalid_requests_total", "submissions rejected by "
            "validation (InvalidRequest)")
        self._m_draining = m.gauge(
            "sched_draining", "1 while shutdown() drains (submits shed)")
        self._m_quarantined = m.counter(
            "sched_quarantined_total", "requests quarantined by the NaN/inf "
            "logits watchdog (terminal; pages held for forensics)")
        self._m_tick_retries = m.counter(
            "sched_tick_retries_total", "tick repack+retry passes taken by "
            "the self-healing dispatch loop")
        self._m_dispatch_faults = m.counter(
            "sched_dispatch_faults_total", "serve_step dispatches that "
            "raised (retried up to tick_retries, then re-raised)")

    # ------------------------------------------------------------------
    def _max_new(self, req: Request) -> int:
        sp = req.sampling
        return sp.max_tokens if (sp is not None and sp.max_tokens) \
            else req.max_new_tokens

    def _base_key(self, req: Request) -> np.ndarray:
        if req.sampling is None:
            return np.zeros(2, np.uint32)
        return request_base_key(req.sampling.seed, req.sample_idx)

    def _validate(self, req: Request) -> None:
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1 or len(prompt) < 1:
            raise InvalidRequest(f"request {req.rid}: empty prompt")
        if req.priority not in PRIORITY_RANK:
            raise InvalidRequest(
                f"request {req.rid}: unknown priority {req.priority!r} "
                f"(one of {PRIORITIES})")
        if req.deadline_ticks is not None and req.deadline_ticks < 1:
            raise InvalidRequest(
                f"request {req.rid}: deadline_ticks must be >= 1 "
                f"(got {req.deadline_ticks})")
        num_tasks = self.engine.num_tasks
        if num_tasks is not None and not 0 <= req.task_id < num_tasks:
            raise InvalidRequest(
                f"request {req.rid}: unknown task id {req.task_id} "
                f"(engine fuses {num_tasks} tasks)")
        sp = req.sampling
        if sp is not None:
            try:
                sp.validate()
            except ValueError as e:
                raise InvalidRequest(f"request {req.rid}: {e}") from e
            if sp.n > 1 and not self.paged:
                raise InvalidRequest(
                    f"request {req.rid}: n={sp.n} parallel samples need "
                    "kv_layout='paged' (COW page forking)")
        max_new = self._max_new(req)
        if max_new < 1:
            raise InvalidRequest(
                f"request {req.rid}: max_new_tokens must be >= 1 "
                f"(got {max_new})")
        # the last generated token is emitted without being fed back, so
        # the deepest KV row written is prompt + max_new - 2
        s = len(prompt)
        if s + max_new - 1 > self.max_len:
            raise InvalidRequest(
                f"request {req.rid}: prompt {s} + {max_new} new "
                f"tokens does not fit max_len {self.max_len}")

    def _bucket(self, length: int) -> int:
        b = self.cfg.bucket_min
        while b < length:
            b *= 2
        return min(b, self.max_len)

    def _shed(self, req: Request, reason: str) -> None:
        req.state, req.finish_reason = SHED, reason
        self.shed[req.rid] = req
        self._m_shed.inc()
        self.obs.metrics.counter(
            f"sched_shed_{reason}_total",
            f"submissions shed with reason={reason}").inc()
        self.obs.slo.on_shed(req, self.ticks, reason)
        self.obs.tracer.instant("shed", rid=req.rid, reason=reason,
                                priority=req.priority)
        self.journal.shed(req.rid, reason)

    def submit(self, req: Request) -> None:
        """Validate and enqueue. Raises :class:`InvalidRequest` for a
        malformed request, and :class:`ShedError` while :meth:`shutdown`
        drains or when the bounded queue is full and holds nothing of a
        worse class (the request is then recorded in ``self.shed``). A
        submission that outranks the newest waiter of the worst class
        displaces it instead: that waiter lands in ``self.shed`` with
        reason ``"displaced"``."""
        try:
            self._validate(req)
        except InvalidRequest:
            self._m_invalid.inc()
            raise
        if self._draining:
            self._shed(req, "shutting_down")
            raise ShedError(req.rid, "shutting_down")
        if self.cfg.max_queue and len(self.queue) >= self.cfg.max_queue:
            victim = self.queue.worst()
            if victim is not None and (PRIORITY_RANK[req.priority]
                                       < PRIORITY_RANK[victim.priority]):
                self.queue.remove(victim)
                self._shed(victim, "displaced")
            else:
                self._shed(req, "queue_full")
                raise ShedError(req.rid, "queue_full")
        req.state = QUEUED
        req.finish_reason = ""
        req.submit_tick = self.ticks
        req.t_submit = time.perf_counter()
        self.shed.pop(req.rid, None)    # resubmitted after a shed
        self.queue.append(req)
        self._m_submitted.inc()
        self._m_queue.set(len(self.queue))
        self.obs.slo.on_submit(req, self.ticks)
        self.journal.submit(req, self.ticks)

    def _emit(self, req: Request, tok: int) -> bool:
        """Record one generated token; True when the request is done."""
        if not req.out:
            req.t_first = time.perf_counter()
            if req.parent is not None and req.parent.t_first == 0.0:
                req.parent.t_first = req.t_first
            self.obs.slo.on_first_token(req, self.ticks)
        req.out.append(tok)
        self.tokens_emitted += 1
        self._m_tokens.inc()
        self.journal.emit(req, tok)
        if req.on_token is not None:
            req.on_token(req, tok)
        sp = req.sampling
        return len(req.out) >= self._max_new(req) or (
            req.eos_id is not None and tok == req.eos_id) or (
            sp is not None and tok in sp.stop)

    def _finish(self, req: Request) -> None:
        self.running.pop(req.slot, None)
        self._admit_seq.pop(req.slot, None)
        cache = getattr(self.pool, "prefix_cache", None)
        if cache is not None:
            # the full prompt pages (never generated tokens) stay cached;
            # a forked child's are the shared prompt pages, an LRU touch
            cache.retain(req.task_id, req.prompt, req.slot)
        self.pool.free(req.slot)
        self.slot_temps[req.slot] = 0.0     # freed rows ride along as greedy
        req.state = FINISHED
        req.t_done = time.perf_counter()
        self._m_finished.inc()
        self.obs.slo.on_finish(req, self.ticks)
        self.obs.tracer.instant("finish", rid=req.rid,
                                sample=req.sample_idx, tokens=len(req.out))
        self.journal.finish(req)
        if req.parent is not None:
            self._finish_sample(req)
        else:
            self.finished[req.rid] = req

    def _finish_sample(self, child: Request) -> None:
        """A sample finished; the parent finishes with its last sibling."""
        parent = child.parent
        parent.samples[child.sample_idx] = child.out
        if all(s is not None for s in parent.samples):
            parent.out = list(parent.samples[0])
            parent.state = FINISHED
            parent.t_done = child.t_done
            self.finished[parent.rid] = parent

    # ------------------------------------------------------------------
    # admission (bucketed whole-prompt prefill, or chunked across ticks)
    # ------------------------------------------------------------------
    def _prefill_tokens(self, req: Request) -> np.ndarray:
        """The tokens whose KV must be resident before decode: the prompt,
        or for a preempted request prompt + all but the last generated
        token (the last one is the pending decode input)."""
        if req.out:
            return np.concatenate([req.prompt,
                                   np.asarray(req.out[:-1], np.int32)])
        return req.prompt

    def _alloc_slot(self, req: Request, length: int) -> Optional[int]:
        if self.paged:
            return self.pool.alloc(req.task_id, self.pool.pages_needed(length))
        return self.pool.alloc(req.task_id)

    def _can_admit(self, req: Request) -> bool:
        """Whole-prompt admission counts free pages only (it never runs
        with a prefix cache)."""
        if not self.pool.has_free():
            return False
        if self.paged:
            need = self.pool.pages_needed(len(self._prefill_tokens(req)))
            return self.pool.free_blocks() >= need
        return True

    def _match_prefix(self, req: Request) -> List[bytes]:
        """Cache keys of the request's longest cached full-page prefix ([]
        without a cache or on a miss); a recompute matches too, as its
        prefill tokens begin with the prompt."""
        cache = getattr(self.pool, "prefix_cache", None)
        if cache is None:
            return []
        return cache.match(req.task_id, self._prefill_tokens(req))

    def _can_admit_chunked(self, req: Request) -> bool:
        """Chunked admission holds a prompt's pages for several ticks before
        the request emits anything, so one append page per running decode
        row stays reserved. A prefix hit claims only its uncached pages,
        and its own entries do not count as evictable headroom."""
        if not self.pool.has_free():
            return False
        keys = self._match_prefix(req)
        need = self.pool.pages_needed(
            len(self._prefill_tokens(req))) - len(keys)
        return self.pool.can_claim(need, reserve=len(self.running),
                                   exclude_keys=keys)

    def _first_sample_spec(self, req: Request):
        """Sampling spec of the first-token draw from the prefill logits:
        None (exact argmax) for greedy single requests and for recompute
        installs, whose pending token was already emitted. A fresh n > 1
        parent draws n first tokens from the same logits row, one per
        sample stream (greedy ones too: temperature 0 is the argmax)."""
        sp = req.sampling
        if sp is None or req.out:
            return None
        fresh_parent = req.parent is None and sp.n > 1
        if sp.greedy and not fresh_parent:
            return None
        idxs = list(range(sp.n)) if fresh_parent else [req.sample_idx]
        n = len(idxs)
        return (np.full(n, sp.temperature, np.float32),
                np.full(n, sp.top_k, np.int32),
                np.full(n, sp.top_p, np.float32),
                np.stack([request_base_key(sp.seed, i) for i in idxs]),
                np.zeros(n, np.int32))

    def _make_child(self, parent: Request, i: int) -> Request:
        child = Request(
            rid=parent.rid, prompt=parent.prompt, task_id=parent.task_id,
            max_new_tokens=parent.max_new_tokens, eos_id=parent.eos_id,
            on_token=parent.on_token, sampling=parent.sampling,
            priority=parent.priority, deadline_ticks=parent.deadline_ticks,
            parent=parent, sample_idx=i)
        child.t_submit = parent.t_submit
        child.submit_tick = parent.submit_tick
        return child

    def _install_single(self, req: Request, slot: int, tok: int) -> None:
        """Start one sample decoding from its prefilled slot."""
        req.state, req.slot = RUNNING, slot
        self._seq += 1
        self._admit_seq[slot] = self._seq
        self.running[slot] = req
        sp = req.sampling
        self.slot_temps[slot] = sp.temperature if sp is not None else 0.0
        self.slot_topk[slot] = sp.top_k if sp is not None else 0
        self.slot_topp[slot] = sp.top_p if sp is not None else 1.0
        self.slot_keys[slot] = self._base_key(req)
        if req.out:
            # recompute after preemption: the pending input token was
            # already emitted; feed it back, the stream resumes at
            # fold_in(base_key, len(out))
            self.slot_tokens[slot, 0] = req.out[-1]
        else:
            self.slot_tokens[slot, 0] = tok
            if self._emit(req, tok) and self.running.get(slot) is req:
                self._finish(req)

    def _install(self, req: Request, slot: int, length: int,
                 first: List[int], cache=None) -> None:
        """Publish the prefilled slot and start decoding it. ``cache``
        carries a whole-prompt prefill's contiguous cache to copy into the
        pool; None means the serve step already wrote the KV into the
        slot's pages (the chunked path) and only the depth is committed.
        ``first``: the first token, or a fresh n > 1 parent's n first
        tokens. Such a parent expands here: the slot becomes sample 0 and
        every other sample forks it; a sample with no slot left to fork
        into is requeued as a request of its own (its counter-based stream
        gives the same tokens; only the shared prefill is lost)."""
        if cache is not None:
            self.pool.write_prefill(slot, cache, length)
        else:
            self.pool.commit_prefill(slot, length)
        sp = req.sampling
        if req.out or req.parent is not None or sp is None or sp.n == 1:
            self._install_single(req, slot, first[0])
            return
        req.samples = [None] * sp.n
        req.state = RUNNING
        children = [self._make_child(req, i) for i in range(sp.n)]
        slots = {0: slot}
        pending: List[Request] = []
        for i in range(1, sp.n):        # fork before any child can finish
            forked = self.pool.fork(slot)
            if forked is None:
                pending.append(children[i])
            else:
                slots[i] = forked
                self.obs.tracer.instant("fork", rid=req.rid, sample=i,
                                        slot=forked)
        for i, child in enumerate(children):
            if i in slots:
                if i > 0:       # sample 0 has the parent's admission
                    self.obs.slo.on_admit(child, self.ticks)
                self._install_single(child, slots[i], first[i])
        for child in reversed(pending):
            self.queue.appendleft(child)

    def _admit_whole(self, req: Request) -> None:
        """Whole-prompt path: the entire (bucket-padded) prompt in one
        prefill call, its cache copied into the pool at install."""
        toks_full = self._prefill_tokens(req)
        s = len(toks_full)
        slot = self._alloc_slot(req, s)
        assert slot is not None
        self._m_admitted.inc()
        self.obs.slo.on_admit(req, self.ticks)
        self.journal.admit(req, self.ticks)
        toks = np.zeros((1, self._bucket(s)), np.int32)
        toks[0, :s] = toks_full
        first, cache = self.engine.prefill_request(
            toks, s, req.task_id, sample=self._first_sample_spec(req))
        self._install(req, slot, s, first, cache=cache)

    def _start_chunked(self, req: Request) -> None:
        """Claim a slot and the prompt's pages; the chunks ride later ticks'
        serve_step calls as ragged spans of the packed list. On a prefix
        hit the slot's leading pages alias the cached prefix (pinned until
        the slot frees) and the prefill starts at the first uncached
        token, a page boundary: the chunk reads the cached K/V through the
        block table at the positions a cold prefill would have written."""
        toks = self._prefill_tokens(req)
        cache = getattr(self.pool, "prefix_cache", None)
        keys = self._match_prefix(req)
        if keys:
            slot = self.pool.alloc_cached(
                req.task_id, keys, self.pool.pages_needed(len(toks)))
        else:
            slot = self._alloc_slot(req, len(toks))
        assert slot is not None
        cached = len(keys) * self.cfg.block_size
        if cache is not None:
            cache.record_lookup(cached)
            if cached:
                self.obs.slo.on_prefix_hit(req, self.ticks, cached)
                self.obs.tracer.instant("prefix_hit", rid=req.rid,
                                        tokens=cached)
        self._m_admitted.inc()
        self.obs.slo.on_admit(req, self.ticks)
        self.journal.admit(req, self.ticks)
        self.slot_temps[slot] = 0.0     # draws armed on the final chunk only
        self._prefills.append(_Prefill(req=req, slot=slot,
                                       toks=np.asarray(toks, np.int32),
                                       length=len(toks), done=cached))
        self.peak_prefills = max(self.peak_prefills, len(self._prefills))

    def _arm_first_draw(self, req: Request, slot: int) -> None:
        """Point the slot's sampling vectors at the request's token-0 draw,
        so the final chunk's logits are sampled inside the same call.
        Recomputes and greedy requests take the exact argmax."""
        sp = req.sampling
        if sp is not None and not req.out and not sp.greedy:
            self.slot_temps[slot] = sp.temperature
            self.slot_topk[slot] = sp.top_k
            self.slot_topp[slot] = sp.top_p
        else:
            self.slot_temps[slot] = 0.0
        self.slot_keys[slot] = self._base_key(req)
        self.slot_steps[slot] = 0

    def _preempt_for_admission(self, head: Request) -> bool:
        """A blocked queue head may take pages from a decode row of a
        strictly worse class (worst class, newest admission first), never
        from the oldest admitted row of a class. True if a row was
        preempted (admission should look again)."""
        if not self.paged:
            return False
        rank = PRIORITY_RANK[head.priority]
        protected = self._protected_slots()
        victims = [s for s, req in self.running.items()
                   if PRIORITY_RANK[req.priority] > rank
                   and s not in protected]
        if not victims:
            return False
        self._preempt(max(victims, key=self._victim_key))
        return True

    def _try_compact(self) -> bool:
        """Admission's rescue before a preemption: fold duplicate full
        prompt pages of the running rows together (``PagedKVPool.compact``,
        host bookkeeping only). In-flight prefills are not offered, as
        their pages are still being written. True if pages were freed."""
        if not self.paged or not self.running:
            return False
        freed = self.pool.compact(
            {slot: req.prompt for slot, req in self.running.items()})
        if freed:
            self.obs.tracer.instant("compact", pages_freed=freed)
        return freed > 0

    def _admission_tick(self) -> None:
        if self.cfg.prefill_chunk > 0:
            # starting a chunked prefill is host bookkeeping only; up to
            # max_prefills prompts then chunk through the tick's one call
            while len(self._prefills) < self.cfg.max_prefills and self.queue:
                head = self.queue[0]
                if self._can_admit_chunked(head):
                    self._start_chunked(self.queue.popleft())
                elif self._try_compact() and self._can_admit_chunked(head):
                    self._start_chunked(self.queue.popleft())
                elif not self._preempt_for_admission(head):
                    break
            return
        lim = self.cfg.admit_per_step or self.cfg.num_slots
        admitted = 0
        while self.queue and admitted < lim:
            head = self.queue[0]
            if self._can_admit(head):
                self._admit_whole(self.queue.popleft())
                admitted += 1
            elif not self._preempt_for_admission(head):
                break

    # ------------------------------------------------------------------
    # page backpressure
    # ------------------------------------------------------------------
    def _preempt(self, slot: int) -> None:
        """Free a running request's slot and pages; requeue it at the front
        of its class for recompute."""
        req = self.running.pop(slot)
        self._admit_seq.pop(slot, None)
        self.pool.free(slot)
        self.slot_temps[slot] = 0.0
        req.state, req.slot = QUEUED, -1
        self.queue.appendleft(req)
        self.preemptions += 1
        self._m_preempt.inc()
        self.obs.slo.on_preempt(req, self.ticks)
        self.obs.tracer.instant("preempt", rid=req.rid, slot=slot)

    def _abort_prefill(self) -> None:
        """Abort an in-flight prefill for pages, the newest of the worst
        class present; requeue it at the head of its class."""
        k = max(range(len(self._prefills)),
                key=lambda i: (PRIORITY_RANK[self._prefills[i].req.priority],
                               i))
        pf = self._prefills[k]
        self._prefills = self._prefills[:k] + self._prefills[k + 1:]
        self.pool.free(pf.slot)
        self.slot_temps[pf.slot] = 0.0
        pf.req.state, pf.req.slot = QUEUED, -1
        self.queue.appendleft(pf.req)
        self.preemptions += 1
        self._m_aborts.inc()
        self.obs.slo.on_preempt(pf.req, self.ticks)
        self.obs.tracer.instant("abort_prefill", rid=pf.req.rid,
                                done=pf.done, length=pf.length)

    def _victim_key(self, slot: int):
        """Victim order over running rows: worst class first, newest
        admission within a class."""
        return (PRIORITY_RANK[self.running[slot].priority],
                self._admit_seq[slot])

    def _protected_slots(self) -> set:
        """The oldest admitted row of every class present: the last rows
        to preempt, so that each class always has a row that finishes."""
        oldest: Dict[str, int] = {}
        for s, req in self.running.items():
            c = req.priority
            if c not in oldest or \
                    self._admit_seq[s] < self._admit_seq[oldest[c]]:
                oldest[c] = s
        return set(oldest.values())

    def _ensure_pages(self) -> None:
        """Every running row appends one KV row this tick: map (and hold
        alone, copying a shared page) each row's next page, best class and
        oldest admission first, preempting the worst class's newest rows
        when the pool runs dry. A protected row (:meth:`_protected_slots`)
        is preempted only when no other victim is left."""
        for slot in sorted(self.running, key=self._victim_key):
            if slot not in self.running:
                continue
            while not self.pool.ensure_append_page(slot):
                protected = self._protected_slots()
                victims = [s for s in self.running
                           if s != slot and s not in protected]
                if victims:
                    self._preempt(max(victims, key=self._victim_key))
                elif self._prefills:
                    # a pending prefill (nothing emitted yet) is a cheaper
                    # victim than any decode row
                    self._abort_prefill()
                elif slot not in protected:
                    # every other row is its class's oldest: this one
                    # yields; they keep appending and finish
                    self._preempt(slot)
                    break
                elif len(self.running) > 1:
                    # all rows protected and the pool still dry: the worst
                    # class's row is the last resort
                    worst = max(self.running, key=self._victim_key)
                    self._preempt(worst)
                    if worst == slot:
                        break
                elif self.pool.num_seized():
                    # fault injection seized the free list: even the last
                    # row cannot append, so it waits the fault out as a
                    # queued recompute
                    self._preempt(slot)
                    break
                else:
                    raise RuntimeError(
                        "paged KV pool cannot hold a single request; raise "
                        "num_blocks (needs >= max_len/block_size + 1)")

    # ------------------------------------------------------------------
    # client aborts, quarantine, deadlines, graceful drain
    # ------------------------------------------------------------------
    def _take(self, rid: int, release) -> Tuple[List[Request],
                                                 Optional[Request]]:
        """Remove every live part of request ``rid`` (queued, chunking, or
        decoding; a fork group whole: the parent and every sample),
        calling ``release(slot)`` on each slot it holds. Returns the parts
        and the group's root (the parent of a forked group)."""
        found = [r for r in self.queue if r.rid == rid]
        for r in found:
            self.queue.remove(r)
        live_pfs = [pf for pf in self._prefills if pf.req.rid == rid]
        if live_pfs:
            # rebuilt, not mutated: a tick may be iterating the old list
            self._prefills = [pf for pf in self._prefills
                              if pf.req.rid != rid]
            for pf in live_pfs:
                release(pf.slot)
                found.append(pf.req)
        for slot, r in list(self.running.items()):
            if r.rid == rid:
                self.running.pop(slot)
                self._admit_seq.pop(slot, None)
                release(slot)
                found.append(r)
        if not found:
            return found, None
        root = next((r.parent for r in found if r.parent is not None),
                    None) or found[0]
        t_done = time.perf_counter()
        for r in found + [root]:
            r.slot, r.t_done = -1, t_done
        return found, root

    def _release(self, slot: int) -> None:
        self.pool.free(slot)
        self.slot_temps[slot] = 0.0

    def _quarantine_slot(self, slot: int) -> None:
        """The paged pool holds a poisoned slot's pages back; a contiguous
        slot has nothing to hold and is freed."""
        if self.paged:
            self.pool.quarantine_slot(slot)
        else:
            self.pool.free(slot)
        self.slot_temps[slot] = 0.0

    def abort(self, rid: int, reason: str = "client") -> bool:
        """Cancel request ``rid`` in whatever state it is in (queued,
        preempted, mid-prefill, mid-decode, forked into samples), freeing
        every slot and page it holds; a forked request goes as a whole
        group and its parent is recorded. Safe between ticks and from an
        ``on_token`` callback inside one (the tick re-checks each row's
        owner). Returns False when ``rid`` holds nothing live."""
        found, root = self._take(rid, self._release)
        if not found:
            return False
        for r in found + [root]:
            r.state, r.finish_reason = ABORTED, reason
        self.aborted[rid] = root
        self._m_client_aborts.inc()
        self.obs.metrics.counter(
            f"sched_aborts_{reason}_total",
            f"requests aborted with reason={reason}").inc()
        self.obs.slo.on_abort(root, self.ticks, reason)
        self.obs.tracer.instant("abort", rid=rid, reason=reason,
                                cancelled=len(found))
        self.journal.abort(rid, reason)
        return True

    def quarantine(self, rid: int, reason: str = "nan_logits") -> bool:
        """Terminally remove a poisoned request, the watchdog's answer to
        non-finite logits: as :meth:`abort` (the whole fork group),
        except that its pages go to the pool's quarantine hold (released
        by :meth:`shutdown`) and the record lands in ``self.quarantined``.
        Partial output stays on the request. Returns True if anything
        live was quarantined."""
        found, root = self._take(rid, self._quarantine_slot)
        if not found:
            return False
        for r in found + [root]:
            r.state, r.finish_reason = QUARANTINED, reason
        self.quarantined[rid] = root
        self._m_quarantined.inc()
        self.obs.metrics.counter(
            f"sched_quarantined_{reason}_total",
            f"requests quarantined with reason={reason}").inc()
        self.obs.slo.on_quarantine(root, self.ticks, reason)
        self.obs.tracer.instant("quarantine", rid=rid, reason=reason,
                                cancelled=len(found))
        self.journal.quarantine(rid, reason)
        return True

    def _expire_deadlines(self) -> None:
        """Abort every live request that has had ``deadline_ticks`` full
        ticks since it was submitted."""
        t = self.ticks
        live = (list(self.queue) + [pf.req for pf in self._prefills]
                + list(self.running.values()))
        expired = {r.rid for r in live if r.deadline_ticks is not None
                   and t - r.submit_tick >= r.deadline_ticks}
        for rid in sorted(expired):
            if self.abort(rid, reason="deadline"):
                self.deadline_misses += 1
                self._m_deadline.inc()

    def shutdown(self, grace_ticks: int = 0) -> DrainReport:
        """Graceful drain: shed every new submission (``ShedError``,
        reason ``"shutting_down"``), tick up to ``grace_ticks`` times so
        in-flight and queued work can finish, abort what is left (reason
        ``"shutdown"``, partial output kept), flush the prefix cache
        (nothing is pinned any more, so every cached page goes back),
        release the quarantine hold and sweep the pool (raising on a
        finding when the obs bundle's ``check_leaks`` is set).
        ``grace_ticks`` is checked before anything changes
        (:class:`InvalidConfig`)."""
        grace_ticks = _check_count("grace_ticks", grace_ticks, 0)
        self._draining = True
        self._m_draining.set(1)
        start = self.ticks
        while self.busy() and self.ticks - start < grace_ticks:
            self.step()
        shed_rids = sorted({r.rid for r in self.queue}
                           | {pf.req.rid for pf in self._prefills}
                           | {r.rid for r in self.running.values()})
        for rid in shed_rids:
            self.abort(rid, reason="shutdown")
        cache_released = self.pool.flush_prefix_cache() if self.paged else 0
        released = self.pool.release_quarantined() if self.paged else 0
        findings = self.drain_check()
        if self.obs.check_leaks and findings:
            raise RuntimeError(
                "KV pool leaked at shutdown: " + "; ".join(findings))
        report = DrainReport(
            finished=len(self.finished), shed_rids=shed_rids,
            grace_ticks_used=self.ticks - start, leak_findings=findings,
            cache_pages_released=cache_released,
            quarantined_pages_released=released)
        self.obs.tracer.instant(
            "shutdown", grace=report.grace_ticks_used,
            shed=len(shed_rids), finished=report.finished)
        return report

    # ------------------------------------------------------------------
    # crash recovery (serve.recovery)
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """The host-side request state (queue, prefill progress, each
        running sample's tokens, terminal records) as a JSON-serialisable
        snapshot; KV pages are not kept (``serve.recovery``)."""
        return scheduler_snapshot(self)

    def restore(self, snap: dict, on_token=None) -> Dict[str, int]:
        """Re-admit a snapshot's live requests into this fresh, idle
        scheduler (``serve.recovery.scheduler_restore``); returns the
        count of requests per status."""
        return scheduler_restore(self, snap, on_token=on_token)

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One scheduler tick: expire deadlines, then paged: ONE serve_step
        call over the packed batch of decode tokens and every in-flight
        prefill's chunk (retried on a fault); slots: whole-prompt
        admission, then one decode_mixed call."""
        t0 = time.perf_counter()
        self._expire_deadlines()
        with self.obs.tracer.span("tick", tick=self.ticks):
            if self.paged:
                self._paged_tick()
            else:
                self._slots_tick()
        self.clock += 1
        self.ticks += 1
        self._m_ticks.inc()
        self._m_tick_ms.observe((time.perf_counter() - t0) * 1e3)
        self._m_queue.set(len(self.queue))
        self._m_running.set(len(self.running))
        self._m_inflight_pf.set(len(self._prefills))
        self._m_peak_running.set_max(self.peak_running)
        self._m_peak_pf.set_max(self.peak_prefills)

    def _split_budget(self) -> List[int]:
        """Split the tick's chunk budget across the in-flight prefills: the
        oldest prefill of each class present (best class first) is first
        guaranteed ``budget / max_prefills`` tokens, the rest goes class by
        class, shortest-remaining-first (ties oldest first). With one class
        this is the oldest prefill's guarantee, then shortest first.
        Returns per-prefill token counts aligned with ``self._prefills``."""
        pfs = self._prefills
        shares = [0] * len(pfs)
        budget = self._qw
        guaranteed: List[int] = []      # oldest prefill per class, best first
        for cls in PRIORITIES:
            idx = [i for i in range(len(pfs)) if pfs[i].req.priority == cls]
            if idx:
                guaranteed.append(idx[0])
        for i in guaranteed:
            if budget <= 0:
                break
            shares[i] = min(pfs[i].remaining,
                            max(1, self._qw // self.cfg.max_prefills), budget)
            budget -= shares[i]
        order = sorted(range(len(pfs)),
                       key=lambda i: (PRIORITY_RANK[pfs[i].req.priority],
                                      pfs[i].remaining, i))
        for i in order:
            if budget <= 0:
                break
            take = min(pfs[i].remaining - shares[i], budget)
            shares[i] += take
            budget -= take
        return shares

    def _width(self) -> int:
        """The tick's packed width, one of two static values:
        ``num_slots`` for a decode-only tick, ``num_slots - 1 +
        prefill_chunk`` with a prefill in flight (dead-token padded)."""
        ns = self.cfg.num_slots
        return ns - 1 + self._qw if self._prefills else ns

    def _pack(self):
        """The tick's packed token list (:meth:`_width` wide): decode rows,
        then every in-flight prefill's chunk. Returns the serve_step
        arrays, each slot's committed depth, the per-prefill shares, the
        prefills whose final chunk is packed and the number of real
        tokens."""
        pfs = self._prefills
        ns, T = self.cfg.num_slots, self._width()
        tokens = np.zeros((T, 1), np.int32)
        token_rows = np.zeros(T, np.int32)
        token_pos = np.full(T, -1, np.int32)            # -1 = dead padding
        logit_idx = np.zeros(ns, np.int32)
        committed = self.pool.cur_len.copy()
        finishing: List[_Prefill] = []                  # final chunk lands
        t = 0
        for slot, req in self.running.items():
            tokens[t, 0] = self.slot_tokens[slot, 0]
            token_rows[t] = slot
            token_pos[t] = self.pool.cur_len[slot]
            logit_idx[slot] = t
            self.slot_steps[slot] = len(req.out)
            t += 1
        shares = self._split_budget()
        for pf, n in zip(pfs, shares):
            committed[pf.slot] = pf.done
            if n == 0:          # budget spent by shorter prefills
                continue
            lo = pf.done
            tokens[t:t + n, 0] = pf.toks[lo:lo + n]
            token_rows[t:t + n] = pf.slot
            token_pos[t:t + n] = np.arange(lo, lo + n)
            if lo + n >= pf.length:
                logit_idx[pf.slot] = t + n - 1          # prompt's last token
                self._arm_first_draw(pf.req, pf.slot)
                finishing.append(pf)
            t += n
        return (tokens, token_rows, token_pos, logit_idx, committed, shares,
                finishing, t)

    def _paged_tick(self) -> None:
        """Pack the batch's real tokens into one flat list and dispatch it
        once, in a loop that heals the tick. Copy-on-write of shared
        append pages happens before the loop (``_ensure_pages``), so a
        retry never copies again. A dispatch that raises is repacked and
        retried, up to ``cfg.tick_retries`` times, then re-raised; no host
        state changed, and the write-fresh rule makes the in-place pool as
        good as untouched (the retry's kernels queue behind the failed
        attempt's on the same stream, with no wait). A dispatch that
        reports a non-finite logits row for a live request quarantines
        that request and retries with the survivors, whose tokens are then
        bitwise those of a tick that was never poisoned; the batch shrinks
        every pass, so this path needs no budget. The trace's spans nest
        as the reference's: a retried dispatch is two ``dispatch`` spans
        and a ``dispatch_fault`` instant."""
        tr = self.obs.tracer
        with tr.span("admission", queued=len(self.queue)):
            self._admission_tick()
        if self.running:
            with tr.span("ensure_pages", rows=len(self.running)):
                self._ensure_pages()    # may preempt rows / abort prefills
        faults = 0
        while True:
            pfs = self._prefills
            if not self.running and not pfs:
                return              # nothing live, or all quarantined
            T = self._width()
            with tr.span("pack_budget_split", decode_rows=len(self.running),
                         prefills=len(pfs), width=T):
                (tokens, token_rows, token_pos, logit_idx, committed, shares,
                 finishing, t) = self._pack()
                check_write_fresh(token_rows, token_pos, committed)
                check_write_exclusive(token_rows, token_pos,
                                      self.pool.block_tables, self.pool._refs,
                                      self.cfg.block_size)
            sample = (self.slot_temps, self.slot_topk, self.slot_topp,
                      self.slot_keys, self.slot_steps)
            try:
                with tr.span("dispatch", tokens=int(t), width=T):
                    toks, logits, cache, finite = self.engine.serve_step(
                        tokens, token_rows, token_pos, logit_idx,
                        self.pool.cache, self.pool.block_tables,
                        self.pool.task_id[token_rows], sample)
            except Exception as e:
                self.dispatch_faults += 1
                self._m_dispatch_faults.inc()
                tr.instant("dispatch_fault", error=type(e).__name__)
                faults += 1
                if faults > self.cfg.tick_retries:
                    raise
                self.tick_retries_used += 1
                self._m_tick_retries.inc()
                continue
            # only rows whose logits this tick reports are consulted
            bad = {req.rid for slot, req in self.running.items()
                   if not finite[slot]}
            bad |= {pf.req.rid for pf in finishing if not finite[pf.slot]}
            if not bad:
                break
            for rid in sorted(bad):
                self.quarantine(rid, reason="nan_logits")
            self.tick_retries_used += 1
            self._m_tick_retries.inc()
        self._m_tick_tokens.observe(t)      # real tokens; T - t are dead
        self.pool.cache = cache
        with tr.span("postprocess"):
            active = list(self.running.items())
            if active:
                self.pool.advance([s for s, _ in active])
                self.steps_decoded += 1
                self._emit_rows(active, toks)
            still: List[_Prefill] = []
            for pf, n in zip(pfs, shares):
                if pf.req.state in TERMINAL_STATES:
                    continue        # aborted mid-tick; pages already gone
                if n == 0:
                    still.append(pf)
                    continue
                pf.done += n
                self.prefill_chunks_run += 1
                self._m_chunks.inc()
                if pf.done < pf.length:
                    still.append(pf)
                    continue
                spec = self._first_sample_spec(pf.req)
                if spec is not None and len(spec[0]) > 1:
                    # a fresh n > 1 parent: every sample's first token
                    # from this one logits row, each under its own stream
                    first = self.engine.sample_first(logits[pf.slot], spec)
                else:
                    first = [int(toks[pf.slot])]    # drawn in serve_step
                self._install(pf.req, pf.slot, pf.length, first)
            # an on_token abort during an install rebuilt self._prefills;
            # do not bring an aborted entry back from ``still``
            self._prefills = [pf for pf in still
                              if pf.req.state not in TERMINAL_STATES]
        self.peak_running = max(self.peak_running, len(self.running))
        if tr.enabled:
            tr.counter("pages", used=self.pool.blocks_in_use(),
                       free=self.pool.free_blocks())
            tr.counter("requests", running=len(self.running),
                       queued=len(self.queue), prefills=len(self._prefills))

    def _emit_rows(self, active, toks) -> None:
        """Feed back and emit each decode row's token. A row is skipped
        once an ``on_token`` callback has aborted its request."""
        for slot, req in active:
            if self.running.get(slot) is not req:
                continue        # aborted by an earlier row's callback
            tok = int(toks[slot])
            self.slot_tokens[slot, 0] = tok
            done = self._emit(req, tok)
            if done and self.running.get(slot) is req:
                self._finish(req)

    def _decode_sample_spec(self):
        """Per-slot sampling vectors for this decode step, or None when
        every running request is greedy (the exact-argmax path). Step
        counters come from each request's emitted-token count, so token j
        is always drawn under fold_in(base, j)."""
        stochastic = False
        for slot, req in self.running.items():
            self.slot_steps[slot] = len(req.out)
            sp = req.sampling
            if sp is not None and sp.temperature > 0.0:
                stochastic = True
        if not stochastic:
            return None
        return (self.slot_temps, self.slot_topk, self.slot_topp,
                self.slot_keys, self.slot_steps)

    def _slots_tick(self) -> None:
        """The contiguous-layout tick: bucketed whole-prompt admission,
        then one decode call over every slot."""
        tr = self.obs.tracer
        with tr.span("admission", queued=len(self.queue)):
            self._admission_tick()
        if not self.running:
            return
        sample = self._decode_sample_spec()
        self._m_tick_tokens.observe(len(self.running))
        with tr.span("dispatch", tokens=len(self.running)):
            toks, cache = self.engine.decode_mixed(
                self.slot_tokens, self.pool.cur_len, self.pool.cache,
                self.pool.task_id, sample=sample)
        self.pool.cache = cache
        with tr.span("postprocess"):
            active = list(self.running.items())
            self.peak_running = max(self.peak_running, len(active))
            self.pool.advance([s for s, _ in active])
            self.steps_decoded += 1
            self._emit_rows(active, toks)

    # ------------------------------------------------------------------
    def busy(self) -> bool:
        """Anything left to do: queued, decoding, or mid-prefill."""
        return bool(self.queue or self.running or self._prefills)

    def drain_check(self) -> List[str]:
        """The KV pool's invariant sweep (empty = clean), its finding
        count published as ``kv_leak_findings``."""
        report = self.pool.leak_report()
        self._m_leaks.set(len(report))
        for msg in report:
            self.obs.tracer.instant("kv_leak", finding=msg)
        return report

    def _maybe_check_leaks(self) -> None:
        """With the obs bundle's ``check_leaks`` on, sweep the pool and
        raise on a finding."""
        if not self.obs.check_leaks:
            return
        report = self.drain_check()
        if report:
            raise RuntimeError(
                "KV pool leaked at drain: " + "; ".join(report))

    def run(self) -> Dict[int, Request]:
        """Drain everything currently submitted."""
        while self.busy():
            self.step()
        self._maybe_check_leaks()
        return self.finished

    def run_stream(self, arrivals: List[Tuple[int, Request]]
                   ) -> Dict[int, Request]:
        """Serve a timed stream of ``(arrival_tick, request)`` pairs on the
        scheduler's tick clock; idle gaps fast-forward. A shed submission
        raises :class:`ShedError` (``launch.serve.run_with_retries`` is the
        client loop that retries it)."""
        order = sorted(range(len(arrivals)), key=lambda i: arrivals[i][0])
        i = 0
        while i < len(order) or self.busy():
            if (not self.busy() and i < len(order)
                    and arrivals[order[i]][0] > self.clock):
                self.clock = arrivals[order[i]][0]       # idle: fast-forward
            while i < len(order) and arrivals[order[i]][0] <= self.clock:
                self.submit(arrivals[order[i]][1])
                i += 1
            self.step()
        self._maybe_check_leaks()
        return self.finished
