"""Request-lifecycle accounting: TTFT / TPOT / e2e percentiles and SLO
attainment.

Counterpart of ``repro.obs.slo``, with the same records, series and
summary keys. The scheduler reports each transition of a request here:
submit, admission, first token, preemption, prefix hit, finish, and the
terminal abort, quarantine and shed. Each is stamped twice, on the
scheduler's tick counter (``ContinuousScheduler.ticks``, real ``step()``
calls only) and on ``time.perf_counter``:

- tick series are load-invariant and immune to the arrival clock's idle
  fast-forward; they are what a CPU run and a card run share;
- wall series (ms) are what a user feels. The port stamps a token after
  ``ServeEngine.serve_step`` has downloaded it, so on the card a wall
  TTFT or TPOT includes the device time of the ticks in between.

TPOT is ``(done - first_token) / (tokens - 1)``, defined for requests
that emitted at least two tokens. SLO attainment is the share of finished
requests within a threshold per metric (``{"ttft_ticks": 4}``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class Lifecycle:
    """One request's (or one n>1 sample child's) transition timestamps."""
    rid: int
    sample_idx: int = 0
    prompt_len: int = 0
    priority: str = "standard"               # request's priority class
    aborted: bool = False                    # cancelled, not completed
    abort_reason: str = ""
    tokens: int = 0
    preemptions: int = 0
    admissions: int = 0                      # > 1 after preempt-recompute
    cached_prefix_tokens: int = 0            # prefill tokens skipped via
                                             # prefix-cache hits (all
                                             # admissions summed)
    submit_tick: int = 0
    submit_wall: float = 0.0
    admit_tick: Optional[int] = None         # first admission only
    admit_wall: Optional[float] = None
    first_tick: Optional[int] = None
    first_wall: Optional[float] = None
    done_tick: Optional[int] = None
    done_wall: Optional[float] = None

    # ------------------------------------------------------------------
    # derived (valid once finished)
    # ------------------------------------------------------------------
    def queue_wait_ticks(self) -> int:
        return self.admit_tick - self.submit_tick

    def ttft_ticks(self) -> int:
        return self.first_tick - self.submit_tick

    def ttft_ms(self) -> float:
        return (self.first_wall - self.submit_wall) * 1e3

    def tpot_ticks(self) -> Optional[float]:
        if self.tokens < 2:
            return None
        return (self.done_tick - self.first_tick) / (self.tokens - 1)

    def tpot_ms(self) -> Optional[float]:
        if self.tokens < 2:
            return None
        return (self.done_wall - self.first_wall) * 1e3 / (self.tokens - 1)

    def e2e_ticks(self) -> int:
        return self.done_tick - self.submit_tick

    def e2e_ms(self) -> float:
        return (self.done_wall - self.submit_wall) * 1e3


def _pctls(vals: List[float], qs=(50, 95, 99)) -> Dict[str, float]:
    if not vals:
        return {f"p{q}": 0.0 for q in qs}
    arr = np.asarray(vals, np.float64)
    return {f"p{q}": round(float(np.percentile(arr, q)), 3) for q in qs}


class SLOTracker:
    """Collects :class:`Lifecycle` records from scheduler hooks.

    Keys are ``(rid, sample_idx)`` so n>1 parallel-sample children each
    get their own record; a child created mid-flight (COW fork or
    requeued sibling) inherits the parent's submit stamp, so its TTFT is
    measured from the original request's submission like the user would.
    Disabled trackers no-op every hook (and hold no state), mirroring the
    null-instrument convention of :mod:`repro_torch.obs.metrics`.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.records: Dict[Tuple[int, int], Lifecycle] = {}
        self.finished: List[Lifecycle] = []
        self.aborted: List[Lifecycle] = []
        self.abort_reasons: Dict[str, int] = {}
        self.quarantined: List[Lifecycle] = []
        self.quarantine_reasons: Dict[str, int] = {}
        self.shed_reasons: Dict[str, int] = {}
        self.shed_by_class: Dict[str, int] = {}
        self._prefix_lookups = False     # any prefix-cache hit reported

    def _rec(self, req, tick: int) -> Lifecycle:
        key = (req.rid, req.sample_idx)
        rec = self.records.get(key)
        if rec is None:
            # an unseen child inherits the parent's submit stamps
            base = self.records.get((req.rid, 0))
            st = base.submit_tick if base is not None else tick
            sw = base.submit_wall if base is not None else time.perf_counter()
            rec = self.records[key] = Lifecycle(
                rid=req.rid, sample_idx=req.sample_idx,
                prompt_len=len(req.prompt),
                priority=getattr(req, "priority", "standard"),
                submit_tick=st, submit_wall=sw)
        return rec

    # ------------------------------------------------------------------
    # scheduler hooks
    # ------------------------------------------------------------------
    def on_submit(self, req, tick: int) -> None:
        if not self.enabled:
            return
        key = (req.rid, req.sample_idx)
        if key not in self.records:
            self.records[key] = Lifecycle(
                rid=req.rid, sample_idx=req.sample_idx,
                prompt_len=len(req.prompt),
                priority=getattr(req, "priority", "standard"),
                submit_tick=tick, submit_wall=time.perf_counter())

    def on_admit(self, req, tick: int) -> None:
        if not self.enabled:
            return
        rec = self._rec(req, tick)
        rec.admissions += 1
        if rec.admit_tick is None:
            rec.admit_tick = tick
            rec.admit_wall = time.perf_counter()

    def on_first_token(self, req, tick: int) -> None:
        if not self.enabled:
            return
        rec = self._rec(req, tick)
        if rec.first_tick is None:
            rec.first_tick = tick
            rec.first_wall = time.perf_counter()

    def on_preempt(self, req, tick: int) -> None:
        if not self.enabled:
            return
        self._rec(req, tick).preemptions += 1

    def on_prefix_hit(self, req, tick: int, cached_tokens: int) -> None:
        """Admission mapped ``cached_tokens`` prefill tokens from the
        shared-prefix page cache instead of recomputing them. Splits the
        TTFT series into warm (any hit) vs cold in :meth:`summary` —
        the cache's whole point is the TTFT gap between the two."""
        if not self.enabled:
            return
        self._prefix_lookups = True
        self._rec(req, tick).cached_prefix_tokens += cached_tokens

    def on_finish(self, req, tick: int) -> None:
        if not self.enabled:
            return
        rec = self._rec(req, tick)
        rec.tokens = len(req.out)
        rec.done_tick = tick
        rec.done_wall = time.perf_counter()
        # a finished request always emitted >= 1 token; a request that
        # finishes on its prefill-install draw stamps first == done here
        if rec.first_tick is None:
            rec.first_tick, rec.first_wall = rec.done_tick, rec.done_wall
        if rec.admit_tick is None:
            rec.admit_tick, rec.admit_wall = rec.first_tick, rec.first_wall
        self.finished.append(rec)

    def on_shed(self, req, tick: int, reason: str) -> None:
        """The bounded queue refused (or displaced) a submission."""
        if not self.enabled:
            return
        self.shed_reasons[reason] = self.shed_reasons.get(reason, 0) + 1
        cls = getattr(req, "priority", "standard")
        self.shed_by_class[cls] = self.shed_by_class.get(cls, 0) + 1

    def on_abort(self, req, tick: int, reason: str) -> None:
        """A live request was cancelled (client abort, disconnect,
        deadline miss, or shutdown) — recorded separately from finishes
        so percentiles only ever aggregate completed requests."""
        if not self.enabled:
            return
        rec = self._rec(req, tick)
        rec.aborted = True
        rec.abort_reason = reason
        rec.done_tick = tick
        rec.done_wall = time.perf_counter()
        self.aborted.append(rec)
        self.abort_reasons[reason] = self.abort_reasons.get(reason, 0) + 1

    def on_quarantine(self, req, tick: int, reason: str) -> None:
        """The watchdog pulled a poisoned request (NaN/inf logits or a
        faulted dispatch pinned on it) out of the batch. Terminal like an
        abort, but tracked separately: quarantines indict the *model or
        device*, not client behaviour, so mixing them into abort counts
        would hide exactly the incidents this hook exists to surface."""
        if not self.enabled:
            return
        rec = self._rec(req, tick)
        rec.aborted = True
        rec.abort_reason = f"quarantine:{reason}"
        rec.done_tick = tick
        rec.done_wall = time.perf_counter()
        self.quarantined.append(rec)
        self.quarantine_reasons[reason] = (
            self.quarantine_reasons.get(reason, 0) + 1)

    # ------------------------------------------------------------------
    # aggregation
    # ------------------------------------------------------------------
    @staticmethod
    def _series(fin: List[Lifecycle]) -> Dict[str, List[float]]:
        return {
            "queue_wait_ticks": [r.queue_wait_ticks() for r in fin],
            "ttft_ticks": [r.ttft_ticks() for r in fin],
            "ttft_ms": [r.ttft_ms() for r in fin],
            "tpot_ticks": [t for r in fin
                           if (t := r.tpot_ticks()) is not None],
            "tpot_ms": [t for r in fin if (t := r.tpot_ms()) is not None],
            "e2e_ticks": [r.e2e_ticks() for r in fin],
            "e2e_ms": [r.e2e_ms() for r in fin],
        }

    @staticmethod
    def _attainment(series: Dict[str, List[float]],
                    targets: Dict[str, float]) -> Dict[str, float]:
        att = {}
        for name, limit in targets.items():
            vals = series.get(name)
            if not vals:
                continue
            ok = sum(1 for v in vals if v <= limit)
            att[f"{name}<={limit:g}"] = round(ok / len(vals), 4)
        return att

    def summary(self, targets: Optional[Dict[str, float]] = None) -> dict:
        """p50/p95/p99 of every lifecycle interval, tick and wall series
        reported side by side but never mixed, plus SLO attainment for
        ``targets`` ({metric_name: threshold}, metric names as in the
        output: ``ttft_ticks``, ``ttft_ms``, ``tpot_ticks``, ``tpot_ms``,
        ``e2e_ticks``, ``e2e_ms``, ``queue_wait_ticks``). When more than
        one priority class finished requests, ``by_class`` repeats the
        tick-series percentiles (and attainment) per class — the
        machine-checkable form of "latency class meets its SLO at
        best-effort's expense, not silently" — and shed/abort counts are
        reported by reason (percentiles only ever aggregate COMPLETED
        requests; aborted and shed work is counted, never averaged in)."""
        fin = self.finished
        series = self._series(fin)
        out: dict = {
            "requests": len(fin),
            "tokens": sum(r.tokens for r in fin),
            "preemptions": sum(r.preemptions for r in fin),
            "readmissions": sum(max(0, r.admissions - 1) for r in fin),
        }
        if self.shed_reasons:
            out["sheds"] = dict(sorted(self.shed_reasons.items()))
            out["sheds_by_class"] = dict(sorted(self.shed_by_class.items()))
        if self.abort_reasons:
            out["aborts"] = dict(sorted(self.abort_reasons.items()))
        if self.quarantine_reasons:
            out["quarantines"] = dict(sorted(self.quarantine_reasons.items()))
        for name, vals in series.items():
            out[name] = _pctls(vals)
        if targets:
            out["slo_attainment"] = self._attainment(series, targets)
        if self._prefix_lookups:
            # warm = admitted through >= 1 prefix-cache hit, cold = never;
            # the TTFT gap between the two series IS the cache's value,
            # reported in the same load-invariant tick units as above
            warm = [r for r in fin if r.cached_prefix_tokens > 0]
            cold = [r for r in fin if r.cached_prefix_tokens == 0]
            out["prefix_cache"] = {
                "warm_requests": len(warm),
                "cold_requests": len(cold),
                "cached_tokens": sum(r.cached_prefix_tokens for r in warm),
                "warm_ttft_ticks": _pctls([r.ttft_ticks() for r in warm]),
                "cold_ttft_ticks": _pctls([r.ttft_ticks() for r in cold]),
                "warm_ttft_ms": _pctls([r.ttft_ms() for r in warm]),
                "cold_ttft_ms": _pctls([r.ttft_ms() for r in cold]),
            }
        # union over finished, shed, and aborted: a class that finished
        # nothing (fully shed under overload) must still show up — its
        # absence from the report is exactly the signal being measured
        classes = sorted({r.priority for r in fin}
                         | set(self.shed_by_class)
                         | {r.priority for r in self.aborted}
                         | {r.priority for r in self.quarantined})
        if (len(classes) > 1 or self.shed_by_class or self.aborted
                or self.quarantined):
            by_class = {}
            for cls in classes:
                cfin = [r for r in fin if r.priority == cls]
                cseries = self._series(cfin)
                entry = {
                    "requests": len(cfin),
                    "tokens": sum(r.tokens for r in cfin),
                    "preemptions": sum(r.preemptions for r in cfin),
                    "aborted": sum(1 for r in self.aborted
                                   if r.priority == cls),
                    "quarantined": sum(1 for r in self.quarantined
                                       if r.priority == cls),
                    "shed": self.shed_by_class.get(cls, 0),
                }
                for name in ("queue_wait_ticks", "ttft_ticks", "tpot_ticks",
                             "e2e_ticks", "ttft_ms", "tpot_ms"):
                    entry[name] = _pctls(cseries[name])
                if targets:
                    entry["slo_attainment"] = self._attainment(
                        cseries, targets)
                by_class[cls] = entry
            out["by_class"] = by_class
        return out
