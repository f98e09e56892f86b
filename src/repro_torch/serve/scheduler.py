"""Continuous-batching scheduler: queue -> admit -> prefill -> decode ->
finish, over a paged or a contiguous (slotted) KV pool.

Counterpart of ``repro.serve.scheduler``. Each request carries its own
task, prompt and ``max_new_tokens``; requests join between ticks.

- ``kv_layout="paged"`` (the default): every tick is ONE
  ``ServeEngine.serve_step`` call over a ragged packed token list, each
  decode row contributing its fed-back token. With ``prefill_chunk > 0``
  each of up to ``max_prefills`` in-flight prefills adds its next prompt
  chunk: the per-tick chunk budget is split shortest-remaining-first, with
  the oldest prefill guaranteed a ``budget / max_prefills`` slice so short
  prompts can never starve it. With ``prefill_chunk = 0`` (the default, as
  in the reference) a prompt is admitted whole: one bucket-padded
  ``prefill_request`` whose cache is scattered into the slot's pages. When
  the pool runs out of pages mid-decode the newest request is preempted
  (freed and requeued) and later recomputed; the counter-based sampling
  streams make the recompute replay the same draws.
- ``kv_layout="slots"``: whole-prompt admission into a contiguous slot,
  then one ``decode_mixed`` call over every slot per tick.

The paged tick heals itself. A dispatch that raises is repacked and
retried, up to ``tick_retries`` times, then re-raised; a request whose
reported logits row is not finite is quarantined (its pages held off the
free list) and the tick is retried with the survivors. The model writes
the pool in place, yet the retry is exact: a tick writes only rows that no
reader trusts yet and rewrites each before reading it (the write-fresh
rule of ``Model.mixed_step``, checked on the host every tick). ``abort``
cancels a request in any state, ``deadline_ticks`` aborts one that has
not finished in time, and ``shutdown`` drains, aborts what is left and
sweeps the pool. ``serve.faults`` drives all of it from a seeded plan.

Not ported yet: priorities and the bounded queue, the journal (so a crash
cannot be recovered), prefix caching, ``n > 1`` samples, observability.
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.models.model import check_write_fresh
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv_pool import PagedKVPool, SlotKVPool
from repro_torch.serve.sampling import SamplingParams, request_base_key

QUEUED, RUNNING, FINISHED = "queued", "running", "finished"
ABORTED, SHED, QUARANTINED = "aborted", "shed", "quarantined"
# every state a request can end in
TERMINAL_STATES = (FINISHED, SHED, ABORTED, QUARANTINED)


class InvalidRequest(ValueError):
    """A malformed submission, rejected at ``submit()``."""


class InvalidConfig(ValueError):
    """A malformed :class:`SchedulerConfig` knob or scheduler argument."""


class ShedError(RuntimeError):
    """The scheduler refused an admissible request: it is draining
    (``reason="shutting_down"``)."""

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


@dataclass
class Request:
    """One serving request. ``on_token`` streams tokens as they decode;
    ``sampling`` None is greedy."""
    rid: int
    prompt: np.ndarray                  # (s,) int32
    task_id: int = 0
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    on_token: Optional[Callable[["Request", int], None]] = None
    sampling: Optional[SamplingParams] = None
    deadline_ticks: Optional[int] = None  # aborted unless finished within
                                          # this many ticks of submission
    # filled in by the scheduler
    out: List[int] = field(default_factory=list)
    state: str = QUEUED
    slot: int = -1
    finish_reason: str = ""             # "" (completed) | deadline | client |
                                        # disconnect | shutdown | nan_logits
                                        # | shutting_down
    submit_tick: int = 0                # scheduler tick at submit
    t_submit: float = 0.0
    t_done: float = 0.0


@dataclass(frozen=True)
class SchedulerConfig:
    num_slots: int = 8                  # batch width (decode rows)
    bucket_min: int = 16                # smallest prefill bucket (doubles up)
    kv_layout: str = "paged"            # "paged" | "slots"
    block_size: int = 16                # KV page size in tokens (paged)
    num_blocks: int = 0                 # physical pages incl. scratch page 0
                                        # (0 = capacity parity with slots)
    prefill_chunk: int = 0              # per-tick prefill TOKEN BUDGET, split
                                        # across in-flight prefills (paged
                                        # only; 0 = whole-prompt admission)
    max_prefills: int = 4               # cap on concurrently chunking prefills
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
    done: int = 0                       # tokens processed so far

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
    quarantined_pages_released: int = 0  # the quarantine hold, freed

    @property
    def clean(self) -> bool:
        return not self.leak_findings


class ContinuousScheduler:
    """Drives a ServeEngine and a KV pool over an online stream."""

    def __init__(self, engine: ServeEngine,
                 cfg: Optional[SchedulerConfig] = None):
        cfg = cfg if cfg is not None else SchedulerConfig()
        for knob, lo in (("num_slots", 1), ("bucket_min", 1),
                         ("block_size", 1), ("num_blocks", 0),
                         ("prefill_chunk", 0), ("max_prefills", 1),
                         ("tick_retries", 0)):
            _check_count(f"SchedulerConfig.{knob}", getattr(cfg, knob), lo)
        if cfg.kv_layout not in ("paged", "slots"):
            raise InvalidConfig(f"SchedulerConfig.kv_layout must be 'paged' "
                                f"or 'slots' (got {cfg.kv_layout!r})")
        if cfg.prefill_chunk > 0 and cfg.kv_layout == "slots":
            raise InvalidConfig(
                "chunked prefill rides the unified paged serve step; "
                "kv_layout='slots' serves whole-prompt prefills only")
        method = engine.peft["method"] if engine.peft else "none"
        if method in ("ptv1", "ptv2"):
            raise InvalidConfig(
                f"{method}: prompt/prefix tuning changes the cache layout "
                "per request; serve it with static batches")
        self.engine = engine
        self.cfg = cfg
        self.max_len = engine.cfg.max_len
        self.paged = cfg.kv_layout == "paged"
        if self.paged:
            self.pool = PagedKVPool(engine.model, cfg.num_slots, self.max_len,
                                    block_size=cfg.block_size,
                                    num_blocks=cfg.num_blocks or None)
        else:
            self.pool = SlotKVPool(engine.model, cfg.num_slots, self.max_len)
        self.queue: deque = deque()
        self.running: Dict[int, Request] = {}        # slot -> request
        self.finished: Dict[int, Request] = {}       # rid -> request
        self.aborted: Dict[int, Request] = {}        # client, disconnect,
                                                     # deadline, shutdown
        self.shed: Dict[int, Request] = {}           # refused at submit
        self.quarantined: Dict[int, Request] = {}    # non-finite logits
        self.deadline_misses = 0
        self.dispatch_faults = 0        # serve_step calls that raised
        self.tick_retries_used = 0      # retry passes of the tick loop
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

    # ------------------------------------------------------------------
    def _max_new(self, req: Request) -> int:
        sp = req.sampling
        return sp.max_tokens if (sp is not None and sp.max_tokens) \
            else req.max_new_tokens

    def _base_key(self, req: Request) -> np.ndarray:
        if req.sampling is None:
            return np.zeros(2, np.uint32)
        return request_base_key(req.sampling.seed, 0)

    def _validate(self, req: Request) -> None:
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1 or len(prompt) < 1:
            raise InvalidRequest(f"request {req.rid}: empty prompt")
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
            if sp.n > 1:
                raise InvalidRequest(
                    f"request {req.rid}: n={sp.n} parallel samples are not "
                    "ported yet")
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

    def submit(self, req: Request) -> None:
        """Validate and enqueue. Raises :class:`InvalidRequest` for a
        malformed request and :class:`ShedError` while :meth:`shutdown`
        drains (the request is then recorded in ``self.shed``)."""
        self._validate(req)
        if self._draining:
            req.state, req.finish_reason = SHED, "shutting_down"
            self.shed[req.rid] = req
            raise ShedError(req.rid, "shutting_down")
        req.state = QUEUED
        req.finish_reason = ""
        req.submit_tick = self.ticks
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _emit(self, req: Request, tok: int) -> bool:
        """Record one generated token; True when the request is done."""
        req.out.append(tok)
        self.tokens_emitted += 1
        if req.on_token is not None:
            req.on_token(req, tok)
        sp = req.sampling
        return len(req.out) >= self._max_new(req) or (
            req.eos_id is not None and tok == req.eos_id) or (
            sp is not None and tok in sp.stop)

    def _finish(self, req: Request) -> None:
        self.running.pop(req.slot, None)
        self._admit_seq.pop(req.slot, None)
        self.pool.free(req.slot)
        self.slot_temps[req.slot] = 0.0     # freed rows ride along as greedy
        req.state = FINISHED
        req.t_done = time.perf_counter()
        self.finished[req.rid] = req

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
        if not self.pool.has_free():
            return False
        if self.paged:
            need = self.pool.pages_needed(len(self._prefill_tokens(req)))
            return self.pool.can_claim(need)
        return True

    def _can_admit_chunked(self, req: Request) -> bool:
        """Chunked admission holds a prompt's pages for several ticks before
        the request emits anything, so one append page per running decode
        row stays reserved."""
        if not self.pool.has_free():
            return False
        need = self.pool.pages_needed(len(self._prefill_tokens(req)))
        return self.pool.can_claim(need, reserve=len(self.running))

    def _first_sample_spec(self, req: Request):
        """Sampling spec of the first-token draw from the prefill logits:
        None (exact argmax) for greedy requests and for recompute installs,
        whose pending token was already emitted."""
        sp = req.sampling
        if sp is None or req.out or sp.greedy:
            return None
        return (np.full(1, sp.temperature, np.float32),
                np.full(1, sp.top_k, np.int32),
                np.full(1, sp.top_p, np.float32),
                request_base_key(sp.seed, 0)[None],
                np.zeros(1, np.int32))

    def _admit_whole(self, req: Request) -> None:
        """Whole-prompt path: the entire (bucket-padded) prompt in one
        prefill call, its cache copied into the pool at install."""
        toks_full = self._prefill_tokens(req)
        s = len(toks_full)
        slot = self._alloc_slot(req, s)
        assert slot is not None
        toks = np.zeros((1, self._bucket(s)), np.int32)
        toks[0, :s] = toks_full
        first, cache = self.engine.prefill_request(
            toks, s, req.task_id, sample=self._first_sample_spec(req))
        self._install(req, slot, s, first[0], cache=cache)

    def _start_chunked(self, req: Request) -> None:
        """Claim a slot and the prompt's pages; the chunks ride later ticks'
        serve_step calls as ragged spans of the packed list."""
        toks = self._prefill_tokens(req)
        slot = self._alloc_slot(req, len(toks))
        assert slot is not None
        self.slot_temps[slot] = 0.0     # draws armed on the final chunk only
        self._prefills.append(_Prefill(req=req, slot=slot,
                                       toks=np.asarray(toks, np.int32),
                                       length=len(toks)))
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

    def _install(self, req: Request, slot: int, length: int, tok: int,
                 cache=None) -> None:
        """Publish the prefilled slot and start decoding it. ``cache``
        carries a whole-prompt prefill's contiguous cache to copy into the
        pool; None means the serve step already wrote the KV into the
        slot's pages (the chunked path) and only the depth is committed."""
        if cache is not None:
            self.pool.write_prefill(slot, cache, length)
        else:
            self.pool.commit_prefill(slot, length)
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

    def _admission_tick(self) -> None:
        if self.cfg.prefill_chunk > 0:
            # starting a chunked prefill is host bookkeeping only; up to
            # max_prefills prompts then chunk through the tick's one call
            while len(self._prefills) < self.cfg.max_prefills and self.queue:
                if not self._can_admit_chunked(self.queue[0]):
                    break
                self._start_chunked(self.queue.popleft())
            return
        while self.queue and self._can_admit(self.queue[0]):
            self._admit_whole(self.queue.popleft())

    # ------------------------------------------------------------------
    # page backpressure
    # ------------------------------------------------------------------
    def _preempt(self, slot: int) -> None:
        """Free a running request's slot and pages; requeue it at the front
        for recompute."""
        req = self.running.pop(slot)
        self._admit_seq.pop(slot, None)
        self.pool.free(slot)
        self.slot_temps[slot] = 0.0
        req.state, req.slot = QUEUED, -1
        self.queue.appendleft(req)
        self.preemptions += 1

    def _abort_prefill(self) -> None:
        """Abort the newest in-flight prefill for pages; requeue it at the
        head of the queue."""
        pf = self._prefills.pop()
        self.pool.free(pf.slot)
        self.slot_temps[pf.slot] = 0.0
        pf.req.state, pf.req.slot = QUEUED, -1
        self.queue.appendleft(pf.req)
        self.preemptions += 1

    def _ensure_pages(self) -> None:
        """Every running row appends one KV row this tick: map each row's
        next page, oldest admission first, preempting the newest rows when
        the pool runs dry. The oldest running row is preempted only when
        nothing else is left, so someone always finishes."""
        for slot in sorted(self.running, key=self._admit_seq.__getitem__):
            if slot not in self.running:
                continue
            while not self.pool.ensure_append_page(slot):
                oldest = min(self.running, key=self._admit_seq.__getitem__)
                victims = [s for s in self.running
                           if s != slot and s != oldest]
                if victims:
                    self._preempt(max(victims,
                                      key=self._admit_seq.__getitem__))
                elif self._prefills:
                    # a pending prefill (nothing emitted yet) is a cheaper
                    # victim than any decode row
                    self._abort_prefill()
                elif slot != oldest:
                    self._preempt(slot)
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
    def _take(self, rid: int, release) -> List[Request]:
        """Remove every live part of request ``rid`` (queued, chunking, or
        decoding), calling ``release(slot)`` on each slot it holds."""
        found = [r for r in self.queue if r.rid == rid]
        if found:
            self.queue = deque(r for r in self.queue if r.rid != rid)
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
        t_done = time.perf_counter()
        for r in found:
            r.slot, r.t_done = -1, t_done
        return found

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
        preempted, mid-prefill, mid-decode), freeing its slot and pages.
        Safe between ticks and from an ``on_token`` callback inside one
        (the tick re-checks each row's owner). Returns False when ``rid``
        holds nothing live (finished, shed, or unknown)."""
        found = self._take(rid, self._release)
        if not found:
            return False
        for r in found:
            r.state, r.finish_reason = ABORTED, reason
        self.aborted[rid] = found[0]
        return True

    def quarantine(self, rid: int, reason: str = "nan_logits") -> bool:
        """Terminally remove a poisoned request, the watchdog's answer to
        non-finite logits: as :meth:`abort`, except that its pages go to
        the pool's quarantine hold (released by :meth:`shutdown`) and the
        record lands in ``self.quarantined``. Partial output stays on the
        request. Returns True if anything live was quarantined."""
        found = self._take(rid, self._quarantine_slot)
        if not found:
            return False
        for r in found:
            r.state, r.finish_reason = QUARANTINED, reason
        self.quarantined[rid] = found[0]
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

    def shutdown(self, grace_ticks: int = 0) -> DrainReport:
        """Graceful drain: shed every new submission (``ShedError``,
        reason ``"shutting_down"``), tick up to ``grace_ticks`` times so
        in-flight and queued work can finish, abort what is left (reason
        ``"shutdown"``, partial output kept), release the quarantine hold
        and sweep the pool. ``grace_ticks`` is checked before anything
        changes (:class:`InvalidConfig`)."""
        grace_ticks = _check_count("grace_ticks", grace_ticks, 0)
        self._draining = True
        start = self.ticks
        while self.busy() and self.ticks - start < grace_ticks:
            self.step()
        shed_rids = sorted({r.rid for r in self.queue}
                           | {pf.req.rid for pf in self._prefills}
                           | {r.rid for r in self.running.values()})
        for rid in shed_rids:
            self.abort(rid, reason="shutdown")
        released = self.pool.release_quarantined() if self.paged else 0
        return DrainReport(
            finished=len(self.finished), shed_rids=shed_rids,
            grace_ticks_used=self.ticks - start,
            leak_findings=self.drain_check(),
            quarantined_pages_released=released)

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One scheduler tick: expire deadlines, then paged: ONE serve_step
        call over the packed batch of decode tokens and every in-flight
        prefill's chunk (retried on a fault); slots: whole-prompt
        admission, then one decode_mixed call."""
        self._expire_deadlines()
        if self.paged:
            self._paged_tick()
        else:
            self._slots_tick()
        self.clock += 1
        self.ticks += 1

    def _split_budget(self) -> List[int]:
        """Split the tick's chunk budget across the in-flight prefills: the
        oldest is first guaranteed ``budget / max_prefills`` tokens, the
        rest goes shortest-remaining-first (ties oldest first). Returns
        per-prefill token counts aligned with ``self._prefills``."""
        pfs = self._prefills
        shares = [0] * len(pfs)
        budget = self._qw
        if pfs:
            shares[0] = min(pfs[0].remaining,
                            max(1, self._qw // self.cfg.max_prefills), budget)
            budget -= shares[0]
        for i in sorted(range(len(pfs)), key=lambda i: (pfs[i].remaining, i)):
            if budget <= 0:
                break
            take = min(pfs[i].remaining - shares[i], budget)
            shares[i] += take
            budget -= take
        return shares

    def _pack(self):
        """The tick's packed token list: decode rows, then every in-flight
        prefill's chunk. The packed width is one of two static values:
        ``num_slots`` for a decode-only tick, ``num_slots - 1 +
        prefill_chunk`` otherwise (dead-token padded). Returns the
        serve_step arrays, each slot's committed depth, the per-prefill
        shares and the prefills whose final chunk is packed."""
        pfs = self._prefills
        ns, qw = self.cfg.num_slots, self._qw
        T = ns - 1 + qw if pfs else ns
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
                finishing)

    def _paged_tick(self) -> None:
        """Pack the batch's real tokens into one flat list and dispatch it
        once, in a loop that heals the tick. A dispatch that raises is
        repacked and retried, up to ``cfg.tick_retries`` times, then
        re-raised; no host state changed, and the write-fresh rule makes
        the in-place pool as good as untouched (the retry's kernels queue
        behind the failed attempt's on the same stream, with no wait). A
        dispatch that reports a non-finite logits row for a live request
        quarantines that request and retries with the survivors, whose
        tokens are then bitwise those of a tick that was never poisoned;
        the batch shrinks every pass, so this path needs no budget."""
        self._admission_tick()
        if self.running:
            self._ensure_pages()    # may preempt rows / abort prefills
        faults = 0
        while True:
            pfs = self._prefills
            if not self.running and not pfs:
                return              # nothing live, or all quarantined
            (tokens, token_rows, token_pos, logit_idx, committed, shares,
             finishing) = self._pack()
            check_write_fresh(token_rows, token_pos, committed)
            sample = (self.slot_temps, self.slot_topk, self.slot_topp,
                      self.slot_keys, self.slot_steps)
            try:
                toks, _, cache, finite = self.engine.serve_step(
                    tokens, token_rows, token_pos, logit_idx,
                    self.pool.cache, self.pool.block_tables,
                    self.pool.task_id[token_rows], sample)
            except Exception:
                self.dispatch_faults += 1
                faults += 1
                if faults > self.cfg.tick_retries:
                    raise
                self.tick_retries_used += 1
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
        self.pool.cache = cache
        active = list(self.running.items())
        if active:
            self.pool.advance([s for s, _ in active])
            self.steps_decoded += 1
            self._emit_rows(active, toks)
        still: List[_Prefill] = []
        for pf, n in zip(pfs, shares):
            if pf.req.state in TERMINAL_STATES:
                continue            # aborted mid-tick; pages already gone
            if n == 0:
                still.append(pf)
                continue
            pf.done += n
            self.prefill_chunks_run += 1
            if pf.done < pf.length:
                still.append(pf)
                continue
            self._install(pf.req, pf.slot, pf.length, int(toks[pf.slot]))
        # an on_token abort during an install rebuilt self._prefills; do
        # not bring an aborted entry back from ``still``
        self._prefills = [pf for pf in still
                          if pf.req.state not in TERMINAL_STATES]
        self.peak_running = max(self.peak_running, len(self.running))

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
        self._admission_tick()
        if not self.running:
            return
        toks, cache = self.engine.decode_mixed(
            self.slot_tokens, self.pool.cur_len, self.pool.cache,
            self.pool.task_id, sample=self._decode_sample_spec())
        self.pool.cache = cache
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
        """The KV pool's invariant sweep (empty = clean)."""
        return self.pool.leak_report()

    def run(self) -> Dict[int, Request]:
        """Drain everything currently submitted."""
        while self.busy():
            self.step()
        return self.finished

    def run_stream(self, arrivals: List[Tuple[int, Request]]
                   ) -> Dict[int, Request]:
        """Serve a timed stream of ``(arrival_tick, request)`` pairs on the
        scheduler's tick clock; idle gaps fast-forward."""
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
        return self.finished
