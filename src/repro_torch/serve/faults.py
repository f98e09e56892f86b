"""Deterministic fault injection for the serving path.

Counterpart of ``repro.serve.faults``. A :class:`FaultPlan` is a seeded,
precomputed schedule: each ``(tick, kind)`` pair draws from its own
``np.random.default_rng([seed, tick, salt])`` stream (salt = the kind's
index in :data:`FAULT_KINDS`), so a chaos run is a pure function of the
plan, the same plan gives the reference's schedule, and zeroing one rate
never reshuffles another kind. The kinds drive the scheduler's real
machinery, not mocks:

- ``exhaust``: :meth:`PagedKVPool.seize_pages` takes pages off the free
  list for a few ticks (admission backpressure, preemption, prefill
  aborts, and at total exhaustion the last row's self-preemption); pages
  the prefix cache retains stay there, so seizure races retention: a
  claim then evicts cold entries to find its pages;
- ``straggler``: a host-side stall before the tick (wall time degrades,
  tokens must not);
- ``disconnect``: :meth:`ContinuousScheduler.abort` of a live request
  picked by the event's own uniform draw (a forked request's whole
  sample group, which shares its rid);
- ``malformed``: a garbage submission that must bounce off validation with
  ``InvalidRequest``;
- ``nan``: one running slot's logits row poisoned at the next dispatch
  (:meth:`ServeEngine.inject_fault`); the watchdog must quarantine exactly
  that request (its whole sample group) and retry the tick;
- ``alloc_failure``: the next dispatch raises ``DispatchFault``; the tick
  loop must absorb it within ``tick_retries``;
- ``crash``: a simulated process death. :func:`run_chaos`, given a
  ``sched_factory``, abandons the scheduler where it stands, replays its
  request journal and restores a fresh scheduler from it, which serves
  on (the preempt-and-recompute path rebuilds the survivors' KV).

The chaos invariants: the scheduler drains, ``leak_report()`` comes back
empty, and every surviving request's tokens equal a fault-free run's.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.recovery import replay_journal
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import (InvalidRequest, Request,
                                         ShedError)

# Order is load-bearing: a kind's index salts its per-tick streams, so the
# port's schedules equal the reference's only in this order.
FAULT_KINDS = ("exhaust", "straggler", "disconnect", "malformed",
               "nan", "alloc_failure", "crash")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``u`` is the event's own seeded uniform draw,
    used where the fault needs a choice (disconnect victim, malformed
    variant, nan slot)."""
    tick: int
    kind: str                           # one of FAULT_KINDS
    u: float = 0.0
    pages: int = 0                      # exhaust: pages to seize
    dur: int = 0                        # exhaust: ticks until restore


@dataclass
class FaultPlan:
    """Seeded fault schedule over ``horizon`` ticks: each ``(tick, kind)``
    draws ``(fire, u)`` from a generator seeded ``[seed, tick,
    FAULT_KINDS.index(kind)]`` and fires when ``fire < p_kind``."""
    seed: int = 0
    horizon: int = 128
    p_exhaust: float = 0.05
    exhaust_pages: int = 6
    exhaust_ticks: int = 4
    p_straggler: float = 0.04
    straggler_ms: float = 1.0
    p_disconnect: float = 0.03
    p_malformed: float = 0.04
    p_nan: float = 0.0
    p_alloc_failure: float = 0.0
    p_crash: float = 0.0
    _events: Optional[List[FaultEvent]] = field(default=None, repr=False)

    def events(self) -> List[FaultEvent]:
        if self._events is None:
            rates = (self.p_exhaust, self.p_straggler, self.p_disconnect,
                     self.p_malformed, self.p_nan, self.p_alloc_failure,
                     self.p_crash)
            evs: List[FaultEvent] = []
            for t in range(self.horizon):
                for salt, (kind, p) in enumerate(zip(FAULT_KINDS, rates)):
                    if p <= 0.0:
                        continue
                    fire, u = np.random.default_rng(
                        [self.seed, t, salt]).random(2)
                    if fire >= p:
                        continue
                    if kind == "exhaust":
                        evs.append(FaultEvent(t, kind, u=u,
                                              pages=self.exhaust_pages,
                                              dur=self.exhaust_ticks))
                    else:
                        evs.append(FaultEvent(t, kind, u=u))
            self._events = evs
        return self._events


def _malformed_request(rid: int, variant: int) -> Request:
    """A submission that validation must refuse."""
    prompt = np.asarray([1, 2, 3], np.int32)
    if variant == 0:
        return Request(rid=rid, prompt=np.asarray([], np.int32))
    if variant == 1:
        return Request(rid=rid, prompt=prompt, max_new_tokens=0)
    if variant == 2:
        return Request(rid=rid, prompt=prompt, task_id=10 ** 6)
    if variant == 3:
        return Request(rid=rid, prompt=prompt,
                       sampling=SamplingParams(temperature=float("nan")))
    return Request(rid=rid, prompt=prompt, sampling=SamplingParams(n=0))


class FaultInjector:
    """Applies a :class:`FaultPlan` to a scheduler at tick boundaries.

    Call :meth:`before_tick` right before each ``sched.step()`` and
    :meth:`finish` after the drain (it restores the pages a trailing
    exhaustion still holds). ``applied`` counts the events that fired, so
    a run can check that each kind was exercised, not just scheduled.
    The injector counts its own ticks: a restored scheduler's ``ticks``
    start again at 0, and the plan must march on, not replay its start."""

    def __init__(self, sched, plan: FaultPlan):
        self.sched = sched
        self.plan = plan
        self.t = 0                                     # injector's own tick
        self._by_tick: Dict[int, List[FaultEvent]] = {}
        for ev in plan.events():
            self._by_tick.setdefault(ev.tick, []).append(ev)
        self._held: List[Tuple[int, List[int]]] = []   # (release_tick, pages)
        self.applied: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self.disconnected: List[int] = []
        self.malformed_ok = True
        self._bad_rid = -1              # garbage rids, apart from real ones

    def rebind(self, sched) -> None:
        """Point the injector at the scheduler restored after a crash. The
        applied counts and the injector's tick carry over; the seized
        pages do not (they died with the old pool)."""
        self.sched = sched
        self._held = []

    def crash_now(self) -> bool:
        """True if a crash event is scheduled for the current tick, and
        consume it; :func:`run_chaos` performs the crash and the
        restore."""
        evs = self._by_tick.get(self.t, ())
        hit = [ev for ev in evs if ev.kind == "crash"]
        if not hit:
            return False
        self._by_tick[self.t] = [ev for ev in evs if ev.kind != "crash"]
        self.applied["crash"] += len(hit)
        return True

    def before_tick(self) -> None:
        sched = self.sched
        t = self.t
        self.t += 1
        still: List[Tuple[int, List[int]]] = []
        for release, pages in self._held:
            if t >= release:
                sched.pool.restore_pages(pages)
            else:
                still.append((release, pages))
        self._held = still
        for ev in self._by_tick.get(t, ()):
            if ev.kind == "exhaust":
                if not sched.paged:
                    continue        # slots layout: no page pool to squeeze
                pages = sched.pool.seize_pages(ev.pages)
                if pages:
                    self._held.append((t + ev.dur, pages))
                    self.applied["exhaust"] += 1
            elif ev.kind == "straggler":
                time.sleep(self.plan.straggler_ms / 1e3)
                self.applied["straggler"] += 1
            elif ev.kind == "disconnect":
                rid = self._pick_victim(ev.u)
                if rid is not None:
                    sched.abort(rid, reason="disconnect")
                    self.disconnected.append(rid)
                    self.applied["disconnect"] += 1
            elif ev.kind == "malformed":
                req = _malformed_request(self._bad_rid, int(ev.u * 5) % 5)
                self._bad_rid -= 1
                try:
                    sched.submit(req)
                    self.malformed_ok = False          # validation hole
                except InvalidRequest:
                    self.applied["malformed"] += 1
            elif ev.kind == "nan":
                slot = self._pick_slot(ev.u)
                if slot is not None:
                    sched.engine.inject_fault("nan", slot)
                    self.applied["nan"] += 1
            elif ev.kind == "alloc_failure":
                sched.engine.inject_fault("alloc_failure")
                self.applied["alloc_failure"] += 1

    def _pick_victim(self, u: float) -> Optional[int]:
        sched = self.sched
        live = sorted({r.rid for r in sched.queue}
                      | {pf.req.rid for pf in sched._prefills}
                      | {r.rid for r in sched.running.values()})
        if not live:
            return None
        return live[int(u * len(live)) % len(live)]

    def _pick_slot(self, u: float) -> Optional[int]:
        """A running slot: live at the next dispatch."""
        slots = sorted(self.sched.running)
        if not slots:
            return None
        return slots[int(u * len(slots)) % len(slots)]

    def finish(self) -> None:
        for _, pages in self._held:
            self.sched.pool.restore_pages(pages)
        self._held = []
        # disarm a one-shot engine fault that never met a dispatch
        self.sched.engine._pending_fault = None


def crash_restore(sched, sched_factory, on_token=None):
    """Simulate the death of ``sched``'s process: abandon it where it
    stands (no shutdown, no page freed), replay its journal and restore
    ``sched_factory()``, a fresh scheduler journaling to the same path.
    The abandoned pool's device tensors are dropped before the factory
    allocates the new pool. Returns (the new scheduler, the snapshot,
    restore's counts per status)."""
    path = sched.journal.path
    sched.journal.close()           # the dying process's buffers flush
    snap = replay_journal(path)
    sched.pool.cache = None         # the dead pool's K/V
    sched = sched_factory()
    counts = sched.restore(snap, on_token=on_token)
    return sched, snap, counts


def run_chaos(sched, arrivals, plan: FaultPlan, sched_factory=None) -> dict:
    """Serve a timed arrival stream under a fault plan: the arrival clock
    and idle fast-forward of :meth:`ContinuousScheduler.run_stream`, with
    :meth:`FaultInjector.before_tick` at every tick boundary.

    ``crash`` events need ``sched_factory``, a zero-argument callable that
    returns a fresh scheduler journaling to the same path as ``sched``;
    at each one the scheduler is abandoned, its journal replayed and the
    factory's scheduler restored from it (:func:`crash_restore`), and the
    new one serves the rest of the arrivals. Without a factory they are
    inert. Returns ``{"finished", "injector", "shed_rids",
    "leak_findings", "quarantined", "crashes", "sched"}``: ``finished``
    spans every incarnation, ``sched`` is the last."""
    inj = FaultInjector(sched, plan)
    shed_rids: List[int] = []
    crashes = 0
    order = sorted(range(len(arrivals)), key=lambda i: arrivals[i][0])
    i = 0
    while i < len(order) or sched.busy():
        if (not sched.busy() and i < len(order)
                and arrivals[order[i]][0] > sched.clock):
            sched.clock = arrivals[order[i]][0]
        while i < len(order) and arrivals[order[i]][0] <= sched.clock:
            try:
                sched.submit(arrivals[order[i]][1])
            except ShedError:
                shed_rids.append(arrivals[order[i]][1].rid)
            i += 1
        if (sched_factory is not None and sched.journal.enabled
                and inj.crash_now()):
            sched = crash_restore(sched, sched_factory)[0]
            inj.rebind(sched)
            crashes += 1
        inj.before_tick()
        sched.step()
    inj.finish()
    return {"finished": sched.finished, "injector": inj,
            "shed_rids": shed_rids, "leak_findings": sched.drain_check(),
            "quarantined": dict(sched.quarantined), "crashes": crashes,
            "sched": sched}
