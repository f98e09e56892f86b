"""Serve-path observability: metrics registry, tick tracing, SLO accounting.

Counterpart of ``repro.obs``: :mod:`repro_torch.obs.metrics` (counters,
gauges, fixed-bucket histograms; JSONL and Prometheus text),
:mod:`repro_torch.obs.tracing` (Chrome trace-event spans per scheduler
tick, plus an opt-in ``torch.profiler`` bracket) and
:mod:`repro_torch.obs.slo` (per-request lifecycles, TTFT / TPOT / e2e
percentiles in ticks and ms, SLO attainment).

:class:`ServeObservability` bundles the three, so that one object is
threaded through: ``ContinuousScheduler(engine, cfg, obs=...)``.
``NULL_OBS`` is the shared disabled bundle a scheduler falls back to:
every hook on it does nothing and it holds no state. No hook reads a
device tensor, so observability on and off give bitwise the same tokens.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry,
    NULL_COUNTER, NULL_GAUGE, NULL_HISTOGRAM)
from repro_torch.obs.slo import Lifecycle, SLOTracker  # noqa: F401
from repro_torch.obs.tracing import NULL_TRACER, TickTracer  # noqa: F401


class ServeObservability:
    """The bundle a scheduler, and the pools and engine under it, report to.

    ``metrics`` and ``trace`` switch the pillars independently (the SLO
    tracker follows ``metrics``); ``profile_dir`` arms the
    ``torch.profiler`` bracket, opened by :meth:`TickTracer.start`;
    ``check_leaks`` makes the scheduler sweep the KV pool's invariants
    when it drains, publish the findings as ``kv_leak_findings`` and
    raise on any."""

    def __init__(self, metrics: bool = True, trace: bool = False,
                 profile_dir: Optional[str] = None,
                 check_leaks: bool = False):
        self.metrics = MetricsRegistry(enabled=metrics)
        self.tracer = (TickTracer(enabled=True, profile_dir=profile_dir)
                       if trace or profile_dir else NULL_TRACER)
        self.slo = SLOTracker(enabled=metrics)
        self.check_leaks = check_leaks

    @property
    def enabled(self) -> bool:
        return self.metrics.enabled or self.tracer.enabled


# the shared disabled bundle: its null instruments swallow every write,
# so one instance serves every scheduler without observability
NULL_OBS = ServeObservability(metrics=False, trace=False)
