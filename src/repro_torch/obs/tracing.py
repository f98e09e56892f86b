"""Tick tracing: Chrome trace-event spans for every scheduler tick.

Counterpart of ``repro.obs.tracing``, with the same event schema. A tick
splits into host phases: admission, ``ensure_pages`` (append pages and
copy-on-write), ``pack_budget_split`` (packing the chunk budget and the
write-fresh / write-exclusive checks), the one ``dispatch`` and
``postprocess`` (emit, finish, install). Each is a complete (``X``)
event in microseconds; lifecycle transitions (finish, preempt, fork,
abort, quarantine, ...) are instants (``i``) and per-tick levels counter
samples (``C``), all on ``pid`` 0, ``tid`` 0. :meth:`TickTracer.write`
gives a ``{"traceEvents": [...]}`` object that chrome://tracing and
Perfetto load.

On the card ``ServeEngine.serve_step`` ends by downloading the tick's
tokens, which waits for the device: the ``dispatch`` span holds the
launches and the device time, and every other span is host time alone.
Recording a span reads only the host clock, so tracing adds no device
work and no wait.

The opt-in profiler bracket (:meth:`start` / :meth:`stop`, with a
``profile_dir``) opens ``torch.profiler.profile`` over the CPU and CUDA
activities and marks each span with ``record_function`` while it is open,
so the device's kernels nest under their tick in the exported trace. The
profiler slows the host, so it is off unless asked for.
"""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import List, Optional


class _NullContext:
    """A shared no-op context (``contextlib.nullcontext`` allocates one
    object per ``with``)."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullContext()


class TickTracer:
    """Span / instant / counter recorder in Chrome trace-event format."""

    def __init__(self, enabled: bool = True,
                 profile_dir: Optional[str] = None):
        self.enabled = enabled
        self.events: List[dict] = []
        self.profile_dir = profile_dir
        self._prof = None               # the open torch.profiler.profile
        self._t0 = time.perf_counter()
        if enabled:
            # process metadata, so that viewers label the track
            self.events.append({"ph": "M", "pid": 0, "tid": 0,
                                "name": "process_name",
                                "args": {"name": "serve scheduler"}})

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    # ------------------------------------------------------------------
    # events
    # ------------------------------------------------------------------
    def span(self, name: str, **args):
        """Context manager recording a complete event around its body."""
        if not self.enabled:
            return _NULL_CTX
        return self._span(name, args)

    @contextmanager
    def _span(self, name: str, args: dict):
        mark = None
        if self._prof is not None:
            from torch.profiler import record_function
            mark = record_function(name)
            mark.__enter__()
        t0 = self._now_us()
        try:
            yield None
        finally:
            ev = {"ph": "X", "pid": 0, "tid": 0, "name": name,
                  "ts": t0, "dur": self._now_us() - t0}
            if args:
                ev["args"] = args
            self.events.append(ev)
            if mark is not None:
                mark.__exit__(None, None, None)

    def instant(self, name: str, **args) -> None:
        """A zero-duration lifecycle marker (finish, preempt, fork)."""
        if not self.enabled:
            return
        ev = {"ph": "i", "pid": 0, "tid": 0, "name": name,
              "ts": self._now_us(), "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, **values) -> None:
        """A counter-track sample: per-tick levels (pages, requests)."""
        if not self.enabled:
            return
        self.events.append({"ph": "C", "pid": 0, "tid": 0, "name": name,
                            "ts": self._now_us(), "args": values})

    # ------------------------------------------------------------------
    # the opt-in torch.profiler bracket
    # ------------------------------------------------------------------
    def start(self) -> None:
        """Open the profiler bracket (nothing without a ``profile_dir``)."""
        if self.enabled and self.profile_dir and self._prof is None:
            from torch.profiler import ProfilerActivity, profile
            import torch
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()

    def stop(self) -> Optional[str]:
        """Close the bracket and export its Chrome trace into
        ``profile_dir``; returns the file's path (None if not open)."""
        if self._prof is None:
            return None
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, "torch_trace.json")
        prof.export_chrome_trace(path)
        return path

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def trace_object(self) -> dict:
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        """Write the trace JSON (chrome://tracing, Perfetto)."""
        with open(path, "w") as f:
            json.dump(self.trace_object(), f)
            f.write("\n")


NULL_TRACER = TickTracer(enabled=False)
