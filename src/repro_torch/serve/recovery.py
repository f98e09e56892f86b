"""Crash recovery: the request journal, scheduler snapshot / restore,
journal replay.

Counterpart of ``repro.serve.recovery``; the JSON it writes and reads is
the reference's, line for line, so a journal or a snapshot written by
either implementation restores in the other.

- :class:`RequestJournal`: an append-only JSONL log of every lifecycle
  transition (submit, admit, emit, finish, shed, abort, quarantine),
  flushed line by line, so that a process killed between ticks loses
  nothing it acknowledged. A ``submit`` carries everything that fixes the
  request's tokens (prompt, task, ``SamplingParams`` with its seed,
  priority, deadline) and each ``emit`` one generated token.
- :func:`replay_journal` (the crash path) and :func:`scheduler_snapshot`
  (a live scheduler) make the same versioned snapshot. Neither holds a
  KV page: the pages die with the process, and the scheduler's
  preempt-and-recompute path rebuilds a request's KV from ``prompt +
  out[:-1]``.
- :func:`scheduler_restore` re-admits every live request into a fresh
  scheduler with its emitted tokens in place. Admission treats each like
  a preempted request: its prefill recomputes ``prompt + out[:-1]``, the
  last token feeds back, and the counter-based sampling stream resumes at
  ``fold_in(base, len(out))``. With the plain versions (the CPU) the
  recovered streams are bitwise an uninterrupted run's; on the card the
  recompute runs the prefill through the chunk tiles where the run it
  replaces wrote those rows one decode token at a time, so the K/V and
  the tokens after the crash may differ in the last bit.

Not kept across a restore: tick and wall clocks (deadline budgets
restart), the prefix cache (it re-warms) and the SLO stamps of work done
before the crash.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

SNAPSHOT_VERSION = 1

# terminal statuses a snapshot records; "live" requests are re-admitted
TERMINAL_STATUSES = ("finished", "aborted", "shed", "quarantined")


# ---------------------------------------------------------------------------
# request (de)serialisation
# ---------------------------------------------------------------------------
def _sampling_to_dict(sp) -> Optional[dict]:
    if sp is None:
        return None
    return {"temperature": sp.temperature, "top_k": sp.top_k,
            "top_p": sp.top_p, "n": sp.n, "seed": sp.seed,
            "max_tokens": sp.max_tokens, "stop": list(sp.stop)}


def _sampling_from_dict(d: Optional[dict]):
    if d is None:
        return None
    from repro_torch.serve.sampling import SamplingParams
    return SamplingParams(
        temperature=d["temperature"], top_k=d["top_k"], top_p=d["top_p"],
        n=d["n"], seed=d["seed"], max_tokens=d["max_tokens"],
        stop=tuple(d["stop"]))


def _ints(toks) -> List[int]:
    return [int(t) for t in toks]


def request_record(req) -> dict:
    """The JSON payload that fixes a request's token stream: prompt, task,
    budget, end and stop tokens, priority, deadline and ``SamplingParams``.
    ``on_token`` is process-local and is re-attached at restore."""
    return {"rid": int(req.rid),
            "prompt": np.asarray(req.prompt).tolist(),
            "task_id": int(req.task_id),
            "max_new_tokens": int(req.max_new_tokens),
            "eos_id": None if req.eos_id is None else int(req.eos_id),
            "priority": req.priority,
            "deadline_ticks": req.deadline_ticks,
            "sampling": _sampling_to_dict(req.sampling)}


def _request_from_record(rec: dict):
    from repro_torch.serve.scheduler import Request
    return Request(
        rid=rec["rid"], prompt=np.asarray(rec["prompt"], np.int32),
        task_id=rec["task_id"], max_new_tokens=rec["max_new_tokens"],
        eos_id=rec["eos_id"], priority=rec["priority"],
        deadline_ticks=rec["deadline_ticks"],
        sampling=_sampling_from_dict(rec["sampling"]))


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------
class RequestJournal:
    """Append-only JSONL lifecycle journal, one compact JSON object per
    line, each flushed as written: after a hard kill the file holds every
    event up to at worst one torn final line, which :func:`replay_journal`
    tolerates. Opened for appending, so a restarted server journals into
    the same file; restore writes ``submit`` records that carry the tokens
    already emitted, so the file replays across any number of crashes."""

    enabled = True

    def __init__(self, path: str):
        self.path = str(path)
        self._f = open(self.path, "a", encoding="utf-8")
        self.events_written = 0
        self.bytes_written = 0

    def _write(self, rec: dict) -> None:
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        self._f.write(line)
        self._f.flush()
        self.events_written += 1
        self.bytes_written += len(line)

    # -- lifecycle events ----------------------------------------------
    def submit(self, req, tick: int) -> None:
        rec = {"ev": "submit", "tick": int(tick)}
        rec.update(request_record(req))
        self._write(rec)

    def submit_restored(self, req, out: Dict[int, List[int]],
                        done: Dict[int, bool]) -> None:
        """A re-admission at restore: a submit record that also carries
        each sample's emitted tokens (a later submit of a rid supersedes
        an earlier one in replay)."""
        rec = {"ev": "submit", "tick": 0, "restored": True}
        rec.update(request_record(req))
        rec["out"] = {str(i): _ints(v) for i, v in out.items()}
        rec["done"] = {str(i): bool(v) for i, v in done.items()}
        self._write(rec)

    def admit(self, req, tick: int) -> None:
        self._write({"ev": "admit", "rid": int(req.rid), "tick": int(tick)})

    def emit(self, req, tok: int) -> None:
        self._write({"ev": "emit", "rid": int(req.rid),
                     "i": int(req.sample_idx), "t": int(tok)})

    def finish(self, req) -> None:
        self._write({"ev": "finish", "rid": int(req.rid),
                     "i": int(req.sample_idx)})

    def shed(self, rid: int, reason: str) -> None:
        self._write({"ev": "shed", "rid": int(rid), "reason": reason})

    def abort(self, rid: int, reason: str) -> None:
        self._write({"ev": "abort", "rid": int(rid), "reason": reason})

    def quarantine(self, rid: int, reason: str) -> None:
        self._write({"ev": "quarantine", "rid": int(rid), "reason": reason})

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class _NullJournal:
    """The default journal: every hook does nothing."""

    enabled = False
    path = None

    def submit(self, req, tick): pass
    def submit_restored(self, req, out, done): pass
    def admit(self, req, tick): pass
    def emit(self, req, tok): pass
    def finish(self, req): pass
    def shed(self, rid, reason): pass
    def abort(self, rid, reason): pass
    def quarantine(self, rid, reason): pass
    def close(self): pass


NULL_JOURNAL = _NullJournal()


# ---------------------------------------------------------------------------
# replay: journal -> snapshot
# ---------------------------------------------------------------------------
def _sample_count(rec: dict) -> int:
    sp = rec.get("sampling")
    return sp["n"] if sp else 1


def _max_new(rec: dict) -> int:
    sp = rec.get("sampling")
    if sp and sp.get("max_tokens"):
        return sp["max_tokens"]
    return rec["max_new_tokens"]


def _sample_done(rec: dict, out: List[int]) -> bool:
    """Whether a sample is complete by the scheduler's own stop rules, for
    a sample whose ``finish`` line the crash may have lost."""
    if not out:
        return False
    if len(out) >= _max_new(rec):
        return True
    if rec["eos_id"] is not None and out[-1] == rec["eos_id"]:
        return True
    sp = rec.get("sampling")
    return bool(sp and out[-1] in sp["stop"])


def replay_journal(path: str) -> dict:
    """Rebuild a snapshot (as :func:`scheduler_snapshot` makes) from a
    journal. A torn final line is skipped; a malformed line anywhere
    else is corruption and raises ValueError."""
    with open(path, "r", encoding="utf-8") as f:
        lines = f.readlines()
    events: List[dict] = []
    for n, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            if n == len(lines) - 1:
                break               # the crash tore the last line
            raise ValueError(
                f"{path}: corrupt journal line {n + 1} (not the last line)")
    recs: Dict[int, dict] = {}
    order: List[int] = []
    for e in events:
        rid = e["rid"]
        if e["ev"] == "submit":
            if rid not in recs:
                order.append(rid)
            rec = {k: e[k] for k in (
                "rid", "prompt", "task_id", "max_new_tokens", "eos_id",
                "priority", "deadline_ticks", "sampling")}
            rec["status"] = "live"
            rec["reason"] = ""
            rec["out"] = {int(i): list(v)
                          for i, v in e.get("out", {}).items()}
            rec["done"] = {int(i): bool(v)
                           for i, v in e.get("done", {}).items()}
            recs[rid] = rec         # a resubmit supersedes (shed, retry)
        elif e["ev"] == "emit":
            recs[rid]["out"].setdefault(e["i"], []).append(e["t"])
        elif e["ev"] == "finish":
            recs[rid]["done"][e["i"]] = True
        elif e["ev"] == "shed":
            recs[rid]["status"], recs[rid]["reason"] = "shed", e["reason"]
        elif e["ev"] == "abort":
            recs[rid]["status"], recs[rid]["reason"] = "aborted", e["reason"]
        elif e["ev"] == "quarantine":
            recs[rid]["status"] = "quarantined"
            recs[rid]["reason"] = e["reason"]
        # "admit" lines are informational
    for rec in recs.values():
        if rec["status"] != "live":
            continue
        n = _sample_count(rec)
        for i, out in rec["out"].items():
            if _sample_done(rec, out):
                rec["done"][i] = True
        if all(rec["done"].get(i) for i in range(n)):
            rec["status"] = "finished"
    return {"version": SNAPSHOT_VERSION,
            "requests": [recs[rid] for rid in order]}


# ---------------------------------------------------------------------------
# snapshot: live scheduler -> snapshot
# ---------------------------------------------------------------------------
def scheduler_snapshot(sched) -> dict:
    """A scheduler's host-side request state as a JSON-serialisable dict:
    the running rows (oldest admission first), the in-flight prefills
    with their progress, the queue, then every terminal record. Prefix
    cache keys are listed for information (hex); no KV page is kept."""
    by_rid: Dict[int, dict] = {}
    order: List[int] = []

    def rec_for(req) -> dict:
        root = req.parent if req.parent is not None else req
        rec = by_rid.get(root.rid)
        if rec is None:
            rec = request_record(root)
            rec.update(status="live", reason="", out={}, done={})
            if root.samples:
                for i, s in enumerate(root.samples):
                    if s is not None:
                        rec["out"][i] = _ints(s)
                        rec["done"][i] = True
            by_rid[root.rid] = rec
            order.append(root.rid)
        return rec

    def add_live(req, progress: Optional[int] = None) -> None:
        rec = rec_for(req)
        rec["out"][req.sample_idx] = _ints(req.out)
        if progress is not None:
            rec["prefill_done"] = int(progress)

    # restore re-admits in list order: the furthest along first
    for slot in sorted(sched.running,
                       key=lambda s: sched._admit_seq.get(s, 0)):
        add_live(sched.running[slot])
    for pf in sched._prefills:
        add_live(pf.req, progress=pf.done)
    for req in sched.queue:
        add_live(req)

    def add_terminal(req, status: str) -> None:
        rec = rec_for(req)
        rec["status"] = status
        rec["reason"] = req.finish_reason
        if req.samples:
            for i, s in enumerate(req.samples):
                if s is not None:
                    rec["out"][i] = _ints(s)
                    rec["done"][i] = True
        else:
            rec["out"][req.sample_idx] = _ints(req.out)
            rec["done"][req.sample_idx] = True

    for req in sched.finished.values():
        add_terminal(req, "finished")
    for req in sched.aborted.values():
        add_terminal(req, "aborted")
    for req in sched.shed.values():
        add_terminal(req, "shed")
    for req in sched.quarantined.values():
        add_terminal(req, "quarantined")

    snap = {"version": SNAPSHOT_VERSION, "ticks": int(sched.ticks),
            "clock": int(sched.clock),
            "requests": [by_rid[rid] for rid in order]}
    cache = getattr(sched.pool, "prefix_cache", None)
    if cache is not None:            # for information: restore starts cold
        snap["prefix_cache_keys"] = [e.key.hex()
                                     for e in cache._entries.values()]
    return snap


# ---------------------------------------------------------------------------
# restore: snapshot -> fresh scheduler
# ---------------------------------------------------------------------------
def scheduler_restore(sched, snap: dict,
                      on_token: Optional[Callable[[Any, int], None]] = None,
                      ) -> Dict[str, int]:
    """Re-admit a snapshot's live requests into a fresh, idle scheduler,
    their emitted tokens in place, so that admission recomputes each as
    it would a preempted request. Terminal records refill ``finished``,
    ``aborted``, ``shed`` and ``quarantined``. The bounded queue's shed
    check is bypassed: the survivors were admitted once already.
    ``on_token`` is attached to every live request (callbacks do not ride
    the snapshot); only tokens made after the restore reach it. Returns
    the count of requests per status."""
    from repro_torch.serve.scheduler import (ABORTED, FINISHED,
                                             QUARANTINED, SHED)
    if snap.get("version") != SNAPSHOT_VERSION:
        raise ValueError(f"unsupported snapshot version "
                         f"{snap.get('version')!r}")
    if sched.ticks or sched.busy() or sched.finished:
        raise ValueError("restore needs a fresh, idle scheduler")
    counts = {"live": 0, "finished": 0, "aborted": 0, "shed": 0,
              "quarantined": 0}
    terminal_state = {"finished": FINISHED, "aborted": ABORTED,
                      "shed": SHED, "quarantined": QUARANTINED}
    for rec in snap["requests"]:
        out = {int(i): list(v) for i, v in rec["out"].items()}
        done = {int(i): bool(v) for i, v in rec["done"].items()}
        status = rec["status"]
        counts[status] += 1
        req = _request_from_record(rec)
        if status != "live":
            req.state = terminal_state[status]
            req.finish_reason = rec["reason"]
            n = _sample_count(rec)
            if n > 1:
                req.samples = [out.get(i) for i in range(n)]
                req.out = list(req.samples[0] or [])
            else:
                req.out = out.get(0, [])
            getattr(sched, status)[req.rid] = req
            continue
        _readmit(sched, req, out, done, on_token)
    return counts


def _readmit(sched, req, out: Dict[int, List[int]], done: Dict[int, bool],
             on_token) -> None:
    """Queue one live request, or the unfinished samples of an installed
    n > 1 group."""
    from repro_torch.serve.scheduler import RUNNING, Request
    sp = req.sampling
    n = sp.n if sp is not None else 1
    started = any(out.get(i) for i in range(n)) or any(done.values())
    sched.journal.submit_restored(req, out, done)
    if n == 1 or not started:
        # a single carries its emitted tokens; an n > 1 parent that was
        # never installed expands at install like a fresh submission
        req.out = out.get(0, [])
        req.on_token = on_token
        _enqueue_restored(sched, req)
        return
    # an installed n > 1 group: finished samples go to the parent, each
    # unfinished one requeues as a child of its own (the scheduler's
    # requeued-sample path; counter-based streams give the same tokens)
    req.state = RUNNING
    req.samples = [out.get(i) if done.get(i) else None for i in range(n)]
    for i in range(n):
        if done.get(i):
            continue
        child = Request(
            rid=req.rid, prompt=req.prompt, task_id=req.task_id,
            max_new_tokens=req.max_new_tokens, eos_id=req.eos_id,
            on_token=on_token, sampling=sp, priority=req.priority,
            deadline_ticks=req.deadline_ticks, parent=req, sample_idx=i)
        child.out = out.get(i, [])
        _enqueue_restored(sched, child)


def _enqueue_restored(sched, req) -> None:
    """Enqueue directly: validation and the SLO submit stamp apply, the
    bounded queue's and the drain's shed checks do not."""
    from repro_torch.serve.scheduler import QUEUED
    sched._validate(req)
    req.state = QUEUED
    req.slot = -1
    req.finish_reason = ""
    req.submit_tick = sched.ticks       # the deadline budget restarts
    req.t_submit = time.perf_counter()
    sched.queue.append(req)
    sched._m_submitted.inc()
    sched._m_queue.set(len(sched.queue))
    sched.obs.slo.on_submit(req, sched.ticks)


def write_snapshot(snap: dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(snap, f)


def read_snapshot(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        snap = json.load(f)
    # JSON makes the int sample-index keys strings
    for rec in snap.get("requests", ()):
        rec["out"] = {int(i): v for i, v in rec["out"].items()}
        rec["done"] = {int(i): bool(v) for i, v in rec["done"].items()}
    return snap
