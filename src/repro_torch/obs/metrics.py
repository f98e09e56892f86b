"""Serve-path metrics: counters, gauges and fixed-bucket histograms.

Counterpart of ``repro.obs.metrics``, with the same names, buckets and
export formats. The instruments only ever read host scalars that the
scheduler, the pools and the engine already hold between dispatches: no
``.item()``, no ``.cpu()``, no synchronisation. So turning metrics on
adds no device work and no wait on the stream, and cannot change a token.

A disabled :class:`MetricsRegistry` hands out shared null instruments
whose mutators do nothing, so instrumented code calls them unconditionally
(``self._m_ticks.inc()``). Histograms keep fixed bucket counts plus a
bounded ring of recent raw values for exact percentiles: nothing grows
with the length of a run.

Exports: :meth:`MetricsRegistry.snapshot` (one nested dict),
:meth:`prometheus_text` (the Prometheus exposition format) and
:meth:`write_jsonl` (one snapshot line appended per call).
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Union


class Counter:
    """Monotonically increasing count (events, tokens, pages claimed)."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n: Union[int, float] = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time level (free pages, queue depth); ``set_max`` keeps a
    high-water mark."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def set(self, v: Union[int, float]) -> None:
        self.value = v

    def set_max(self, v: Union[int, float]) -> None:
        if v > self.value:
            self.value = v


class Histogram:
    """Fixed-bucket histogram plus a ring of recent raw observations.

    ``buckets`` are inclusive upper bounds, ascending; an implicit +inf
    bucket takes the overflow, so ``bucket_counts`` has ``len(buckets) +
    1`` entries. Bucket counts, ``sum`` and ``count`` cover the whole run
    (Prometheus semantics); percentiles are exact over the last
    ``window`` raw values."""

    __slots__ = ("name", "help", "buckets", "bucket_counts", "count", "sum",
                 "_ring", "_ring_pos", "_window")

    def __init__(self, name: str, buckets: Sequence[float], help: str = "",
                 window: int = 4096):
        assert list(buckets) == sorted(buckets), \
            f"{name}: bucket bounds must ascend ({list(buckets)})"
        assert len(buckets) >= 1, f"{name}: at least one bucket bound"
        self.name = name
        self.help = help
        self.buckets = [float(b) for b in buckets]
        self.bucket_counts = [0] * (len(buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self._window = window
        self._ring: List[float] = []
        self._ring_pos = 0

    def observe(self, v: Union[int, float]) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        i = 0
        for bound in self.buckets:          # short lists: a linear scan
            if v <= bound:
                break
            i += 1
        self.bucket_counts[i] += 1
        if len(self._ring) < self._window:
            self._ring.append(v)
        else:
            self._ring[self._ring_pos] = v
            self._ring_pos = (self._ring_pos + 1) % self._window

    def percentile(self, q: float) -> float:
        """Exact percentile over the retained window (nearest rank)."""
        if not self._ring:
            return 0.0
        vals = sorted(self._ring)
        rank = min(len(vals) - 1,
                   max(0, int(round(q / 100.0 * (len(vals) - 1)))))
        return vals[rank]

    def percentiles(self, qs: Sequence[float] = (50, 95, 99)
                    ) -> Dict[str, float]:
        return {f"p{q:g}": self.percentile(q) for q in qs}


class _NullCounter(Counter):
    def inc(self, n: Union[int, float] = 1) -> None:
        pass


class _NullGauge(Gauge):
    def set(self, v: Union[int, float]) -> None:
        pass

    def set_max(self, v: Union[int, float]) -> None:
        pass


class _NullHistogram(Histogram):
    def __init__(self):
        super().__init__("null", [1.0])

    def observe(self, v: Union[int, float]) -> None:
        pass


# shared no-op instruments, handed out by a disabled registry
NULL_COUNTER = _NullCounter("null")
NULL_GAUGE = _NullGauge("null")
NULL_HISTOGRAM = _NullHistogram()


class MetricsRegistry:
    """Named instruments, registered idempotently: ``counter``, ``gauge``
    and ``histogram`` return the instrument already registered under a
    name (so a pool and a scheduler share one registry without
    coordination), and null instruments when the registry is disabled.
    ``clock`` stamps the JSONL lines (epoch time by default; a test passes
    a fixed one)."""

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.time):
        self.enabled = enabled
        self.clock = clock
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}

    def _get(self, name: str, kind: type):
        m = self._metrics.get(name)
        if m is not None:
            assert isinstance(m, kind), (
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        if not self.enabled:
            return NULL_COUNTER
        m = self._get(name, Counter)
        if m is None:
            m = self._metrics[name] = Counter(name, help)
        return m

    def gauge(self, name: str, help: str = "") -> Gauge:
        if not self.enabled:
            return NULL_GAUGE
        m = self._get(name, Gauge)
        if m is None:
            m = self._metrics[name] = Gauge(name, help)
        return m

    def histogram(self, name: str, buckets: Sequence[float], help: str = "",
                  window: int = 4096) -> Histogram:
        if not self.enabled:
            return NULL_HISTOGRAM
        m = self._get(name, Histogram)
        if m is None:
            m = self._metrics[name] = Histogram(name, buckets, help, window)
        return m

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, dict]:
        """Every instrument in one nested dict (the payload of each JSONL
        line)."""
        out: Dict[str, dict] = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                out[name] = {
                    "type": "histogram", "count": m.count,
                    "sum": round(m.sum, 6), "buckets": m.buckets,
                    "bucket_counts": list(m.bucket_counts),
                    **{k: round(v, 6) for k, v in m.percentiles().items()}}
            elif isinstance(m, Gauge):
                out[name] = {"type": "gauge", "value": m.value}
            else:
                out[name] = {"type": "counter", "value": m.value}
        return out

    def prometheus_text(self) -> str:
        """Prometheus exposition format (text/plain; version 0.0.4)."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            kind = ("histogram" if isinstance(m, Histogram)
                    else "gauge" if isinstance(m, Gauge) else "counter")
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {kind}")
            if isinstance(m, Histogram):
                cum = 0
                for bound, c in zip(m.buckets + [float("inf")],
                                    m.bucket_counts):
                    cum += c
                    le = "+Inf" if bound == float("inf") else f"{bound:g}"
                    lines.append(f'{name}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{name}_sum {m.sum:g}")
                lines.append(f"{name}_count {m.count}")
            else:
                lines.append(f"{name} {m.value:g}")
        return "\n".join(lines) + "\n"

    def write_jsonl(self, path: str, extra: Optional[dict] = None) -> None:
        """Append one snapshot line (timestamp, metrics, extras)."""
        rec = {"ts": self.clock(), "metrics": self.snapshot()}
        if extra:
            rec.update(extra)
        with open(path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
