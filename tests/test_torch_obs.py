"""The port's serve-path observability (``repro_torch.obs``) against the
reference's (``repro.obs``): the metrics primitives, the SLO tracker, the
tick tracer and the drain-time leak sweep, each held to the contract of
``tests/test_obs.py``; then the same request streams through both
schedulers in this process (``tiny_lm``, f32, the same seeded requests)
with observability on, where every counter, gauge and the packed-tokens
histogram, every trace event per tick (phase, name and arguments;
timestamps aside) and every SLO tick stamp must equal the reference's;
and metrics and trace on against off must give bitwise the same tokens,
greedy and sampled."""
import json
from types import SimpleNamespace

import numpy as np
import pytest

from port_util import jax_tasks, port_lm, port_tables
from repro import obs as jobs
from repro.serve import faults as jfaults
from repro.serve import scheduler as jsched
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.sampling import SamplingParams as JSampling
from repro_torch import obs
from repro_torch.obs.metrics import (Histogram, MetricsRegistry,
                                     NULL_COUNTER, NULL_GAUGE,
                                     NULL_HISTOGRAM)
from repro_torch.obs.slo import Lifecycle, SLOTracker
from repro_torch.obs.tracing import TickTracer
from repro_torch.serve import faults
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.sampling import SamplingParams

MAX_LEN = 48
REF = SimpleNamespace(name="reference", S=jsched, F=jfaults, O=jobs,
                      Sampling=JSampling)
PORT = SimpleNamespace(name="port", S=sched_mod, F=faults, O=obs,
                       Sampling=SamplingParams)
# the one wall-clock instrument: its values differ run to run
WALL = ("sched_tick_wall_ms",)


@pytest.fixture(scope="module")
def engines(tiny_lm):
    cfg, jmodel, jparams = tiny_lm
    tasks = jax_tasks(cfg, jparams, 3)
    jeng = JServeEngine(jmodel, jparams, JServeConfig(max_len=MAX_LEN),
                        fused_tasks=tasks)
    model, params = port_lm(tiny_lm)
    eng = ServeEngine(model, params, ServeConfig(max_len=MAX_LEN),
                      fused_tasks=port_tables(tasks))
    return cfg, {"reference": (REF, jeng), "port": (PORT, eng)}


@pytest.fixture()
def port_engine(engines):
    cfg, sides = engines
    return cfg, sides["port"][1]


def both(engines, scenario, **kw):
    """``scenario(ns, eng, cfg, **kw)`` on the reference and on the port:
    the results must be equal. Returns the port's."""
    cfg, sides = engines
    got = {name: scenario(ns, eng, cfg, **kw)
           for name, (ns, eng) in sides.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def _mk_requests(ns, rng, cfg, n, sampled=False, **kw):
    reqs = []
    for i in range(n):
        plen = int(rng.integers(3, 17))
        sp = None
        if sampled:
            sp = ns.Sampling(temperature=0.8, top_p=0.9, seed=100 + i)
        reqs.append(ns.S.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                       plen).astype(np.int32),
            task_id=int(rng.integers(0, 3)),
            max_new_tokens=int(rng.integers(1, 9)), sampling=sp, **kw))
    return reqs


def _sched(ns, eng, o=None, **kw):
    base = dict(num_slots=3, bucket_min=8, kv_layout="paged", block_size=8,
                prefill_chunk=8)
    base.update(kw)
    return ns.S.ContinuousScheduler(eng, ns.S.SchedulerConfig(**base),
                                    obs=o)


def _serve(ns, eng, reqs, o=None, **sched_kw):
    sched = _sched(ns, eng, o, **sched_kw)
    arrivals = [(i % 5, r) for i, r in enumerate(reqs)]
    return sched, sched.run_stream(arrivals)


# ---------------------------------------------------------------------------
# metrics primitives
# ---------------------------------------------------------------------------

def test_histogram_matches_numpy_oracle(rng):
    bounds = [0.5, 1.0, 2.0, 5.0, 10.0]
    h = Histogram("h", bounds, window=10_000)
    vals = rng.exponential(2.0, size=1000)
    for v in vals:
        h.observe(v)
    # inclusive upper edges: nudge numpy's half-open bins up one step
    edges = [-np.inf] + [np.nextafter(b, np.inf) for b in bounds] + [np.inf]
    want, _ = np.histogram(vals, bins=edges)
    assert h.bucket_counts == want.tolist()
    assert h.count == 1000
    np.testing.assert_allclose(h.sum, vals.sum(), rtol=1e-9)
    svals = sorted(vals)
    for q in (50, 95, 99):
        rank = int(round(q / 100.0 * (len(svals) - 1)))
        assert h.percentile(q) == svals[rank]


def test_histogram_ring_window_bounds_memory():
    h = Histogram("h", [10.0], window=8)
    for v in range(100):
        h.observe(float(v))
    assert len(h._ring) == 8
    assert h.count == 100
    assert sorted(h._ring) == [92.0, 93.0, 94.0, 95.0, 96.0, 97.0, 98.0, 99.0]
    assert h.percentile(50) == 96.0


def test_registry_idempotent_and_typed():
    m = MetricsRegistry()
    assert m.counter("x_total") is m.counter("x_total")
    with pytest.raises(AssertionError):
        m.gauge("x_total")


def test_disabled_registry_hands_out_nulls():
    m = MetricsRegistry(enabled=False)
    c, g, h = m.counter("c"), m.gauge("g"), m.histogram("h", [1.0])
    assert c is NULL_COUNTER and g is NULL_GAUGE and h is NULL_HISTOGRAM
    c.inc(5), g.set(3), h.observe(1.0)
    assert NULL_COUNTER.value == 0 and NULL_GAUGE.value == 0
    assert NULL_HISTOGRAM.count == 0
    assert m.snapshot() == {}


def _fill(registry):
    registry.counter("req_total", "requests").inc(3)
    registry.gauge("depth").set(7)
    h = registry.histogram("lat_ms", [1.0, 10.0], "latency")
    h.observe(0.5), h.observe(5.0), h.observe(100.0)
    return registry


def test_prometheus_text_format():
    text = _fill(MetricsRegistry()).prometheus_text()
    assert "# TYPE req_total counter" in text
    assert "req_total 3" in text
    assert "depth 7" in text
    assert 'lat_ms_bucket{le="1"} 1' in text
    assert 'lat_ms_bucket{le="10"} 2' in text
    assert 'lat_ms_bucket{le="+Inf"} 3' in text
    assert "lat_ms_count 3" in text
    # byte for byte the reference's exposition and snapshot
    ref = _fill(jobs.MetricsRegistry())
    assert text == ref.prometheus_text()
    assert MetricsRegistry().snapshot() == {}
    assert _fill(MetricsRegistry()).snapshot() == ref.snapshot()


def test_jsonl_sink(tmp_path):
    lines = {}
    for name, mod in (("port", obs), ("reference", jobs)):
        m = mod.MetricsRegistry(clock=lambda: 123.0)
        m.counter("a_total").inc()
        path = tmp_path / f"{name}.jsonl"
        m.write_jsonl(str(path), extra={"run": 1})
        m.counter("a_total").inc()
        m.write_jsonl(str(path), extra={"run": 2})
        lines[name] = path.read_text()
    got = [json.loads(line) for line in lines["port"].splitlines()]
    assert [r["run"] for r in got] == [1, 2]
    assert [r["metrics"]["a_total"]["value"] for r in got] == [1, 2]
    assert all(r["ts"] == 123.0 for r in got)
    assert lines["port"] == lines["reference"]


# ---------------------------------------------------------------------------
# SLO accounting
# ---------------------------------------------------------------------------

def test_lifecycle_derived_intervals():
    r = Lifecycle(rid=0, submit_tick=2, submit_wall=1.0)
    r.admit_tick, r.admit_wall = 4, 1.1
    r.first_tick, r.first_wall = 6, 1.25
    r.done_tick, r.done_wall = 10, 1.45
    r.tokens = 5
    assert r.queue_wait_ticks() == 2
    assert r.ttft_ticks() == 4
    assert r.ttft_ms() == pytest.approx(250.0)
    assert r.tpot_ticks() == pytest.approx(1.0)
    assert r.tpot_ms() == pytest.approx(50.0)
    assert r.e2e_ticks() == 8
    assert r.e2e_ms() == pytest.approx(450.0)
    assert Lifecycle(rid=1, tokens=1, submit_tick=0).tpot_ticks() is None


def test_slo_summary_percentiles_match_numpy():
    ttfts = [1, 1, 2, 3, 5, 8, 13, 21]
    summaries = []
    for tracker in (SLOTracker(), jobs.SLOTracker()):
        for i, t in enumerate(ttfts):
            req = SimpleNamespace(rid=i, sample_idx=0, prompt=np.zeros(4),
                                  out=[0, 0])
            tracker.on_submit(req, 0)
            tracker.on_admit(req, 0)
            tracker.on_first_token(req, t)
            tracker.on_finish(req, t + 2)
        summaries.append(tracker.summary(targets={"ttft_ticks": 5}))
    s, ref = summaries
    for q in (50, 95, 99):
        assert s["ttft_ticks"][f"p{q}"] == pytest.approx(
            float(np.percentile(np.asarray(ttfts, float), q)), abs=1e-3)
    assert s["slo_attainment"]["ttft_ticks<=5"] == pytest.approx(5 / 8)
    assert s["requests"] == len(ttfts)
    assert _ticks_only(s) == _ticks_only(ref)


def test_disabled_tracker_holds_no_state():
    tr = SLOTracker(enabled=False)
    req = SimpleNamespace(rid=0, sample_idx=0, prompt=np.zeros(2), out=[1])
    tr.on_submit(req, 0), tr.on_finish(req, 3)
    assert tr.records == {} and tr.finished == []


# ---------------------------------------------------------------------------
# tick tracing
# ---------------------------------------------------------------------------

def _validate_chrome_trace(obj):
    """The trace-event subset chrome://tracing and Perfetto load."""
    assert isinstance(obj, dict) and "traceEvents" in obj
    events = obj["traceEvents"]
    assert isinstance(events, list) and events
    for ev in events:
        assert isinstance(ev["name"], str) and ev["name"]
        assert ev["ph"] in ("X", "B", "E", "i", "I", "C", "M")
        assert ev["pid"] == 0 and ev["tid"] == 0
        if ev["ph"] != "M":
            assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0
        if ev["ph"] == "X":
            assert isinstance(ev["dur"], (int, float)) and ev["dur"] >= 0
        if "args" in ev:
            json.dumps(ev["args"])
    return events


PHASES = {"admission", "ensure_pages", "pack_budget_split", "dispatch",
          "postprocess"}


def test_trace_schema_and_tick_anatomy(rng, port_engine, tmp_path):
    cfg, eng = port_engine
    o = obs.ServeObservability(metrics=True, trace=True)
    sched, fin = _serve(PORT, eng, _mk_requests(PORT, rng, cfg, 6), o)
    assert len(fin) == 6
    path = tmp_path / "trace.json"
    o.tracer.write(str(path))
    events = _validate_chrome_trace(json.loads(path.read_text()))
    ticks = [e for e in events if e["name"] == "tick"]
    assert len(ticks) == sched.ticks
    seen = {e["name"] for e in events}
    assert PHASES <= seen, f"missing phase spans: {PHASES - seen}"
    for ev in events:
        if ev["ph"] == "X" and ev["name"] in PHASES:
            assert any(t["ts"] <= ev["ts"] and
                       ev["ts"] + ev["dur"] <= t["ts"] + t["dur"] + 1e-3
                       for t in ticks), f"{ev['name']} span outside any tick"
    assert len([e for e in events if e["name"] == "finish"]) == 6
    assert {e["name"] for e in events if e["ph"] == "C"} == {"pages",
                                                             "requests"}


def test_disabled_tracer_is_inert():
    tr = TickTracer(enabled=False)
    with tr.span("x", a=1):
        pass
    tr.instant("y")
    tr.counter("z", v=1)
    tr.start()
    assert tr.stop() is None
    assert tr.events == []


def test_profiler_bracket_marks_every_span(tmp_path):
    """``start()`` opens torch.profiler (CPU here), each span runs inside
    a ``record_function`` of its name, ``stop()`` exports the trace."""
    import torch
    tr = TickTracer(profile_dir=str(tmp_path / "prof"))
    tr.start()
    for i in range(2):
        with tr.span("tick", tick=i):
            with tr.span("dispatch", tokens=3):
                torch.ones(4).sum()
    path = tr.stop()
    assert tr.stop() is None                 # closed once
    names = [e["name"] for e in json.load(open(path))["traceEvents"]]
    assert names.count("tick") == 2 and names.count("dispatch") == 2
    assert [e["name"] for e in tr.events if e["ph"] == "X"] == [
        "dispatch", "tick", "dispatch", "tick"]


# ---------------------------------------------------------------------------
# no change to the tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "stochastic"])
def test_observability_does_not_change_tokens(port_engine, sampled):
    """The same stream with metrics, trace and the leak sweep on and with
    observability off gives bitwise the same tokens."""
    cfg, eng = port_engine
    o = obs.ServeObservability(metrics=True, trace=True, check_leaks=True)
    _, fin_on = _serve(PORT, eng, _mk_requests(
        PORT, np.random.default_rng(5), cfg, 8, sampled), o)
    _, fin_off = _serve(PORT, eng, _mk_requests(
        PORT, np.random.default_rng(5), cfg, 8, sampled))
    assert len(fin_on) == len(fin_off) == 8
    for rid in fin_off:
        assert list(fin_on[rid].out) == list(fin_off[rid].out), rid
    snap = o.metrics.snapshot()
    assert snap["sched_requests_finished_total"]["value"] == 8
    assert snap["sched_ticks_total"]["value"] > 0
    assert o.slo.summary()["requests"] == 8


def test_null_obs_is_shared_and_stateless(rng, port_engine):
    cfg, eng = port_engine
    sched, _ = _serve(PORT, eng, _mk_requests(PORT, rng, cfg, 3))
    assert sched.obs is obs.NULL_OBS
    assert obs.NULL_OBS.metrics.snapshot() == {}
    assert obs.NULL_OBS.tracer.events == []
    assert obs.NULL_OBS.slo.records == {}


# ---------------------------------------------------------------------------
# drain-time leak sweep
# ---------------------------------------------------------------------------

def test_drain_leak_check_clean(rng, port_engine):
    cfg, eng = port_engine
    o = obs.ServeObservability(metrics=True, check_leaks=True)
    _, fin = _serve(PORT, eng, _mk_requests(PORT, rng, cfg, 5), o)
    assert len(fin) == 5
    assert o.metrics.snapshot()["kv_leak_findings"]["value"] == 0


def test_drain_leak_check_fires_on_injected_leak(rng, port_engine):
    cfg, eng = port_engine
    o = obs.ServeObservability(metrics=True, check_leaks=True)
    sched = _sched(PORT, eng, o)
    for r in _mk_requests(PORT, rng, cfg, 3):
        sched.submit(r)
    sched.pool._free_blocks.pop()       # a page lost from the free list
    with pytest.raises(RuntimeError, match="leaked"):
        sched.run()
    assert o.metrics.snapshot()["kv_leak_findings"]["value"] >= 1
    assert any("leaked pages" in msg for msg in sched.drain_check())
    with pytest.raises(RuntimeError, match="leaked at shutdown"):
        sched.shutdown()


def test_leak_report_refcount_desync(rng, port_engine):
    cfg, eng = port_engine
    sched, _ = _serve(PORT, eng, _mk_requests(PORT, rng, cfg, 3))
    pool = sched.pool
    assert pool.leak_report() == []
    pool._refs[1] += 1
    assert any("refcounts out of sync" in m for m in pool.leak_report())
    pool._refs[1] -= 1
    assert pool.leak_report() == []


# ---------------------------------------------------------------------------
# scheduler-level accounting
# ---------------------------------------------------------------------------

def test_pool_gauges_track_pages(rng, port_engine):
    cfg, eng = port_engine
    o = obs.ServeObservability(metrics=True)
    sched, _ = _serve(PORT, eng, _mk_requests(PORT, rng, cfg, 6), o)
    snap = o.metrics.snapshot()
    assert snap["kv_pages_used"]["value"] == 0
    assert (snap["kv_pages_claimed_total"]["value"]
            == snap["kv_pages_freed_total"]["value"] > 0)
    assert snap["kv_pages_peak"]["value"] == sched.pool.peak_pages > 0
    assert snap["kv_pages_free"]["value"] == sched.pool.free_blocks()
    assert (snap["engine_dispatch_serve_step_total"]["value"]
            == snap["sched_ticks_total"]["value"])


def test_slo_ttft_matches_external_measurement(rng, port_engine):
    """The tracker's TTFT in ticks equals submit-tick / first-token-tick
    bookkeeping done outside the scheduler."""
    cfg, eng = port_engine
    o = obs.ServeObservability(metrics=True)
    sched = _sched(PORT, eng, o)
    submit_tick, first_tick = {}, {}
    reqs = _mk_requests(PORT, rng, cfg, 6)
    for r in reqs:
        r.on_token = lambda req, tok: first_tick.setdefault(req.rid,
                                                            sched.ticks)
    for r in reqs:
        submit_tick[r.rid] = sched.ticks
        sched.submit(r)
    sched.run()
    want = sorted(first_tick[rid] - submit_tick[rid] for rid in first_tick)
    assert sorted(r.ttft_ticks() for r in o.slo.finished) == want


# ---------------------------------------------------------------------------
# the port's observations against the reference's, on the same streams
# ---------------------------------------------------------------------------

def _ticks_only(summary):
    """An SLO summary without its wall-clock (``*_ms``) series."""
    if isinstance(summary, dict):
        return {k: _ticks_only(v) for k, v in summary.items()
                if not k.endswith("_ms")}
    return summary


def _trace_ticks(events):
    """The trace as (phase, name, args) per tick, timestamps aside; a
    ``tick`` span closes its tick."""
    ticks, cur = [], []
    for ev in events:
        cur.append((ev["ph"], ev["name"], ev.get("args")))
        if ev["ph"] == "X" and ev["name"] == "tick":
            ticks.append(cur)
            cur = []
    return ticks + [cur]


def _observed(ns, sched, o, fin):
    """Everything the two implementations must share after a run."""
    snap = {k: v for k, v in o.metrics.snapshot().items() if k not in WALL}
    recs = sorted(
        (r.rid, r.sample_idx, r.prompt_len, r.priority, r.aborted,
         r.abort_reason, r.tokens, r.preemptions, r.admissions,
         r.cached_prefix_tokens, r.submit_tick, r.admit_tick, r.first_tick,
         r.done_tick) for r in o.slo.records.values())
    return dict(metrics=snap, trace=_trace_ticks(o.tracer.events),
                slo=_ticks_only(o.slo.summary(targets={"ttft_ticks": 3})),
                records=recs,
                tokens={rid: list(map(int, r.out)) for rid, r in fin.items()},
                ticks=sched.ticks)


def _stream(ns, eng, cfg, kind):
    o = ns.O.ServeObservability(metrics=True, trace=True)
    rng = np.random.default_rng(7)
    if kind == "slots":
        sched, fin = _serve(ns, eng, _mk_requests(ns, rng, cfg, 6), o,
                            kv_layout="slots", prefill_chunk=0)
    elif kind == "whole_prompt":
        sched, fin = _serve(ns, eng, _mk_requests(ns, rng, cfg, 6), o,
                            prefill_chunk=0)
    elif kind == "pressure":
        # a small pool: preemptions and prefill aborts for pages
        reqs = _mk_requests(ns, rng, cfg, 8)
        for r in reqs:
            r.max_new_tokens = 8
        sched, fin = _serve(ns, eng, reqs, o, num_blocks=7)
    else:
        sampled = kind == "sampled"
        sched, fin = _serve(ns, eng, _mk_requests(ns, rng, cfg, 8, sampled),
                            o)
    return _observed(ns, sched, o, fin)


def _shared(ns, eng, cfg):
    """A shared prompt with the prefix cache, n = 2 forks and priorities."""
    o = ns.O.ServeObservability(metrics=True, trace=True)
    rng = np.random.default_rng(8)
    system = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    classes = ("latency", "standard", "best_effort")
    arrivals = []
    for i in range(8):
        tail = rng.integers(0, cfg.vocab_size,
                            int(rng.integers(2, 9))).astype(np.int32)
        sp = (ns.Sampling(temperature=0.8, top_k=20, seed=50 + i, n=2)
              if i % 3 == 0 else None)
        arrivals.append((i // 2, ns.S.Request(
            rid=i, prompt=np.concatenate([system, tail]), task_id=i % 2,
            max_new_tokens=int(rng.integers(2, 7)), sampling=sp,
            priority=classes[i % 3])))
    sched = _sched(ns, eng, o, num_slots=4, prefix_cache_pages=8)
    fin = sched.run_stream(arrivals)
    return _observed(ns, sched, o, fin)


def _overload(ns, eng, cfg):
    """A bounded queue (queue_full and displaced sheds), an invalid
    submission, a client abort, a deadline miss and a shutdown with work
    still live."""
    o = ns.O.ServeObservability(metrics=True, trace=True)
    rng = np.random.default_rng(9)
    classes = ("best_effort", "standard", "latency")
    sched = _sched(ns, eng, o, num_slots=2, max_queue=2)
    reqs = _mk_requests(ns, rng, cfg, 9)
    for i, r in enumerate(reqs):
        r.priority = classes[i % 3]
        r.max_new_tokens = 6
    reqs[2].deadline_ticks = 2
    for r in reqs[:6]:
        try:
            sched.submit(r)
        except ns.S.ShedError:
            pass
    with pytest.raises(ns.S.InvalidRequest):
        sched.submit(ns.S.Request(rid=99, prompt=np.asarray([], np.int32)))
    for _ in range(3):
        sched.step()
    assert sched.abort(min(r.rid for r in sched.running.values()))
    for r in reqs[6:]:
        try:
            sched.submit(r)
        except ns.S.ShedError:
            pass
    sched.step()
    report = sched.shutdown(grace_ticks=2)
    assert report.clean and report.shed_rids
    return _observed(ns, sched, o, sched.finished)


def _chaos(ns, eng, cfg):
    """Every fault kind but crash: retried dispatches, quarantines, seized
    pages, disconnects and malformed submissions."""
    o = ns.O.ServeObservability(metrics=True, trace=True)
    rng = np.random.default_rng(10)
    arrivals = [(int(rng.integers(0, 10)), r)
                for r in _mk_requests(ns, rng, cfg, 10)]
    plan = ns.F.FaultPlan(seed=0, horizon=40, p_exhaust=0.12,
                          exhaust_pages=8, exhaust_ticks=3, p_straggler=0.0,
                          p_disconnect=0.08, p_malformed=0.15, p_nan=0.1,
                          p_alloc_failure=0.1)
    sched = _sched(ns, eng, o, num_blocks=14)
    res = ns.F.run_chaos(sched, arrivals, plan)
    assert res["quarantined"] and sched.dispatch_faults
    sched.shutdown()
    return _observed(ns, sched, o, res["finished"])


STREAMS = ("greedy", "sampled", "slots", "whole_prompt", "pressure")


@pytest.mark.parametrize("kind", STREAMS)
def test_observations_equal_reference(engines, kind):
    """Counters, gauges, the packed-tokens histogram, the trace events of
    every tick and the SLO tick series and stamps: the reference's."""
    got = both(engines, _stream, kind=kind)
    m = got["metrics"]
    assert m["sched_tick_packed_tokens"]["count"] == got["ticks"]
    assert len(got["trace"]) == got["ticks"] + 1
    if kind == "pressure":
        assert m["sched_preemptions_total"]["value"] > 0


@pytest.mark.parametrize("scenario", ["shared", "overload", "chaos"])
def test_observations_equal_reference_under_policy_and_faults(engines,
                                                              scenario):
    """The same, through prefix hits, forks, compaction-free priorities,
    sheds, aborts, deadlines, shutdown, retries and quarantines."""
    run = {"shared": _shared, "overload": _overload, "chaos": _chaos}
    got = both(engines, run[scenario])
    names = {name for tick in got["trace"] for _, name, _ in tick}
    want = {"shared": {"prefix_hit", "fork", "finish"},
            "overload": {"shed", "abort", "shutdown"},
            "chaos": {"dispatch_fault", "quarantine", "abort"}}[scenario]
    assert want <= names, want - names
    if scenario == "overload":
        m = got["metrics"]
        for name in ("sched_shed_queue_full_total",
                     "sched_shed_displaced_total", "sched_aborts_client_total",
                     "sched_aborts_deadline_total",
                     "sched_aborts_shutdown_total",
                     "sched_invalid_requests_total"):
            assert m[name]["value"] > 0, name
