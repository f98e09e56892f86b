"""The port's crash recovery (``repro_torch.serve.recovery``) against the
reference's: the request journal, journal replay, ``snapshot()`` /
``restore()`` and crash events in ``run_chaos`` and the launcher's client
loop. Each scenario runs on both schedulers in this process (``tiny_lm``,
f32, the same seeded requests).

- The port's journal file equals the reference's line for line for the
  same stream, and ``replay_journal`` of either file gives the same
  snapshot in either implementation.
- ``snapshot()`` equals the reference's after every tick.
- A stream killed at a tick and restored from its journal, or restored
  from a live snapshot written to JSON, is bitwise the uninterrupted
  stream, greedy and stochastic (n > 1 included), with the pool leak-free
  and the drain clean. Tier-1 kills at a few ticks; the every-tick soak
  carries the ``soak`` mark, as the reference's does.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest

from port_util import jax_tasks, port_lm, port_tables
from repro import obs as jobs
from repro.serve import faults as jfaults
from repro.serve import recovery as jrec
from repro.serve import scheduler as jsched
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.sampling import SamplingParams as JSampling
from repro_torch import obs
from repro_torch.launch import serve as launcher
from repro_torch.serve import faults
from repro_torch.serve import recovery as rec
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.sampling import SamplingParams

MAX_LEN = 48
REF = SimpleNamespace(name="reference", S=jsched, F=jfaults, R=jrec, O=jobs,
                      Sampling=JSampling)
PORT = SimpleNamespace(name="port", S=sched_mod, F=faults, R=rec, O=obs,
                       Sampling=SamplingParams)


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
def port_side(engines):
    cfg, sides = engines
    return (cfg,) + sides["port"]


def both(engines, scenario, **kw):
    """``scenario(ns, eng, cfg, **kw)`` on the reference and on the port:
    the results must be equal. Returns the port's."""
    cfg, sides = engines
    got = {name: scenario(ns, eng, cfg, **kw)
           for name, (ns, eng) in sides.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def _sched(ns, eng, journal=None, o=None, **kw):
    base = dict(num_slots=3, bucket_min=8, kv_layout="paged", block_size=8,
                prefill_chunk=8, num_blocks=14)
    base.update(kw)
    return ns.S.ContinuousScheduler(eng, ns.S.SchedulerConfig(**base),
                                    obs=o, journal=journal)


def _req(ns, cfg, rng, rid, plen=None, max_new=None, **kw):
    plen = plen if plen is not None else int(rng.integers(3, 17))
    max_new = max_new if max_new is not None else int(rng.integers(2, 9))
    return ns.S.Request(
        rid=rid, prompt=rng.integers(0, cfg.vocab_size,
                                     plen).astype(np.int32),
        task_id=int(rng.integers(0, 3)), max_new_tokens=max_new, **kw)


def _wl(ns, cfg, seed, n=8, stochastic=False):
    """The reference test's workload: arrivals rebuilt from the seed for
    every run that is compared (every sixth request n = 2 when
    stochastic)."""
    rng = np.random.default_rng(seed)
    arrivals = []
    for i in range(n):
        plen = int(rng.integers(3, 17))
        sp = None
        if stochastic and i % 3 == 0:
            sp = ns.Sampling(temperature=0.8, top_k=20, seed=100 + i,
                             n=2 if i % 6 == 0 else 1)
        arrivals.append((int(rng.integers(0, n)), ns.S.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                       plen).astype(np.int32),
            task_id=int(rng.integers(0, 3)),
            max_new_tokens=int(rng.integers(3, 9)), sampling=sp)))
    return arrivals


def _streams(fin):
    """Every request's tokens, and each sample's for n > 1."""
    return {rid: (list(map(int, r.out)),
                  None if r.samples is None
                  else [list(map(int, s)) for s in r.samples])
            for rid, r in sorted(fin.items())}


def _lines(path):
    return open(path).read().splitlines()


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------

def _journaled(ns, eng, cfg, tmp_path, stochastic):
    path = str(tmp_path / f"{ns.name}_{int(stochastic)}.jsonl")
    sched = _sched(ns, eng, journal=ns.R.RequestJournal(path))
    fin = sched.run_stream(_wl(ns, cfg, seed=40, n=6, stochastic=stochastic))
    sched.journal.close()
    return _lines(path), _streams(fin), sched.journal.events_written


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["greedy", "stochastic"])
def test_journal_records_full_lifecycle(engines, tmp_path, stochastic):
    """Every transition is journaled, one emit per token, and the file is
    the reference's line for line; replay marks the drained stream
    finished."""
    lines, fin, written = both(engines, _journaled, tmp_path=tmp_path,
                               stochastic=stochastic)
    events = [json.loads(line) for line in lines]
    assert written == len(events)
    assert {"submit", "admit", "emit", "finish"} <= {e["ev"] for e in events}
    emitted = sum(1 for e in events if e["ev"] == "emit")
    assert emitted == sum(len(s) for _, samples in fin.values()
                          for s in (samples or [_]))
    subs = [e for e in events if e["ev"] == "submit"]
    assert {e["rid"] for e in subs} == set(fin)
    for e in subs:
        assert e["prompt"] and "task_id" in e and "max_new_tokens" in e
    path = tmp_path / "port_{}.jsonl".format(int(stochastic))
    snap = rec.replay_journal(str(path))
    assert all(r["status"] == "finished" for r in snap["requests"])


def test_journal_tolerates_torn_tail(port_side, tmp_path):
    """A torn final line is skipped; a bad line elsewhere raises."""
    cfg, ns, eng = port_side
    path = str(tmp_path / "torn.jsonl")
    sched = _sched(ns, eng, journal=rec.RequestJournal(path))
    sched.run_stream(_wl(ns, cfg, seed=41, n=3))
    sched.journal.close()
    with open(path, "a") as f:
        f.write('{"ev": "emit", "rid": 0, "i": 0, "t"')
    for mod in (rec, jrec):
        snap = mod.replay_journal(path)
        assert all(r["status"] == "finished" for r in snap["requests"])
    lines = _lines(path)
    lines[1] = "#### not json ####"
    bad = str(tmp_path / "corrupt.jsonl")
    with open(bad, "w") as f:
        f.write("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="corrupt"):
        rec.replay_journal(bad)


def _killed_journal(ns, eng, cfg, tmp_path, kill_tick, stochastic):
    """The journal of a stream abandoned after ``kill_tick`` ticks."""
    path = str(tmp_path / f"kill_{ns.name}.jsonl")
    sched = _sched(ns, eng, journal=ns.R.RequestJournal(path))
    arrivals = _wl(ns, cfg, 51, stochastic=stochastic)
    for _, r in sorted(arrivals, key=lambda a: a[0]):
        sched.submit(r)
    for _ in range(kill_tick):
        sched.step()
    sched.journal.close()
    return path


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["greedy", "stochastic"])
def test_replay_gives_equal_snapshots_across_implementations(
        engines, tmp_path, stochastic):
    """Each implementation's journal of a killed stream replays to the
    same snapshot in both implementations."""
    _, sides = engines
    paths = {name: _killed_journal(ns, eng, engines[0], tmp_path, 5,
                                   stochastic)
             for name, (ns, eng) in sides.items()}
    assert _lines(paths["port"]) == _lines(paths["reference"])
    snaps = [mod.replay_journal(p) for p in paths.values()
             for mod in (rec, jrec)]
    assert all(s == snaps[0] for s in snaps[1:])
    assert any(r["status"] == "live" for r in snaps[0]["requests"])


# ---------------------------------------------------------------------------
# snapshot() after every tick
# ---------------------------------------------------------------------------

def _snapshots(ns, eng, cfg, stochastic, layout):
    kw = ({} if layout == "paged"
          else dict(kv_layout="slots", prefill_chunk=0, num_blocks=0))
    if layout == "prefix":
        kw = dict(prefix_cache_pages=6)
    sched = _sched(ns, eng, **kw)
    arrivals = _wl(ns, cfg, 52, stochastic=stochastic and layout != "slots")
    snaps = [sched.snapshot()]
    step = sched.step

    def traced():
        step()
        snaps.append(sched.snapshot())
    sched.step = traced
    sched.run_stream(arrivals)
    json.dumps(snaps)                   # serialisable as it stands
    return snaps


@pytest.mark.parametrize("stochastic,layout", [
    (False, "paged"), (True, "paged"), (False, "slots"), (True, "prefix")])
def test_snapshot_equals_reference_every_tick(engines, stochastic, layout):
    snaps = both(engines, _snapshots, stochastic=stochastic, layout=layout)
    assert len(snaps) > 4
    assert any(r["status"] == "live" for s in snaps[1:-1]
               for r in s["requests"])


# ---------------------------------------------------------------------------
# kill at a tick, restore from the journal: bitwise
# ---------------------------------------------------------------------------

def _serve_killed(ns, eng, cfg, arrivals, path, kill_tick, o=None):
    """Drive a journaled scheduler and abandon it after ``kill_tick`` ticks
    (no shutdown, no page freed); restore a fresh one from the journal,
    give it the arrivals the old one never saw and drain it. None if the
    stream drained first."""
    sched = _sched(ns, eng, journal=ns.R.RequestJournal(str(path)))
    order = sorted(range(len(arrivals)), key=lambda i: arrivals[i][0])
    i, killed = 0, False
    while i < len(order) or sched.busy():
        if (not sched.busy() and i < len(order)
                and arrivals[order[i]][0] > sched.clock):
            sched.clock = arrivals[order[i]][0]
        while i < len(order) and arrivals[order[i]][0] <= sched.clock:
            sched.submit(arrivals[order[i]][1])
            i += 1
        sched.step()
        if sched.ticks >= kill_tick and sched.busy():
            killed = True
            break
    sched.journal.close()
    if not killed:
        return None
    snap = ns.R.replay_journal(str(path))
    sched2 = _sched(ns, eng, journal=ns.R.RequestJournal(str(path)), o=o)
    counts = sched2.restore(snap)
    for j in order[i:]:
        sched2.submit(arrivals[j][1])
    fin = sched2.run()
    return fin, sched2, counts


def _kill_restore(ns, eng, cfg, tmp_path, stochastic, wl_seed, kill_tick):
    baseline = _sched(ns, eng).run_stream(
        _wl(ns, cfg, wl_seed, stochastic=stochastic))
    path = tmp_path / f"kill_{ns.name}_{wl_seed}_{kill_tick}.jsonl"
    got = _serve_killed(ns, eng, cfg, _wl(ns, cfg, wl_seed,
                                          stochastic=stochastic),
                        path, kill_tick)
    assert got is not None, "the stream drained before the kill tick"
    fin, sched2, counts = got
    assert _streams(fin) == _streams(baseline)
    assert sched2.pool.leak_report() == []
    report = sched2.shutdown(grace_ticks=4)
    assert report.clean
    return _streams(fin), counts, _lines(path)


@pytest.mark.parametrize("stochastic,wl_seed,kill_tick", [
    (False, 50, 2), (False, 50, 4), (False, 50, 9),
    (True, 51, 3), (True, 51, 5), (True, 51, 8)])
def test_restore_midstream_parity(engines, tmp_path, stochastic, wl_seed,
                                  kill_tick):
    """Killed at a tick and restored from the journal: every stream (each
    sample of n = 2 too) bitwise the uninterrupted run's, leak-free, a
    clean drain; the restore counts and the journal across the crash
    equal the reference's."""
    _, counts, _ = both(engines, _kill_restore, tmp_path=tmp_path,
                        stochastic=stochastic, wl_seed=wl_seed,
                        kill_tick=kill_tick)
    assert counts["live"] > 0


@pytest.mark.soak
@pytest.mark.parametrize("stochastic,wl_seed", [(False, 60), (True, 61)])
def test_kill_at_every_tick_soak(port_side, tmp_path, stochastic, wl_seed):
    """Kill at every tick of the stream, restore from the journal: every
    recovered stream bitwise, leak-free, a clean drain."""
    cfg, ns, eng = port_side
    baseline = _sched(ns, eng).run_stream(
        _wl(ns, cfg, wl_seed, stochastic=stochastic))
    k = 1
    while True:
        got = _serve_killed(ns, eng, cfg,
                            _wl(ns, cfg, wl_seed, stochastic=stochastic),
                            tmp_path / f"soak_{wl_seed}_{k}.jsonl", k)
        if got is None:
            break
        fin, sched2, _ = got
        assert _streams(fin) == _streams(baseline), k
        assert sched2.pool.leak_report() == [], k
        assert sched2.shutdown(grace_ticks=4).clean
        k += 1
    assert k > 3, "the soak never killed mid-flight"


# ---------------------------------------------------------------------------
# live snapshot -> JSON -> restore
# ---------------------------------------------------------------------------

def _live(ns, eng, cfg, tmp_path, layout, cross):
    stochastic = layout == "paged"
    kw = ({} if layout == "paged"
          else dict(kv_layout="slots", prefill_chunk=0, num_blocks=0))
    baseline = _sched(ns, eng, **kw).run_stream(
        _wl(ns, cfg, 62, stochastic=stochastic))
    sched = _sched(ns, eng, **kw)
    for _, req in _wl(ns, cfg, 62, stochastic=stochastic):
        sched.submit(req)
    for _ in range(4):
        sched.step()
    assert sched.busy()
    path = str(tmp_path / f"snap_{ns.name}_{layout}.json")
    ns.R.write_snapshot(sched.snapshot(), path)
    # ``cross``: the other implementation reads the file
    reader = (jrec if ns is PORT else rec) if cross else ns.R
    snap = reader.read_snapshot(path)
    assert "kv" not in snap and "cache" not in snap
    sched2 = _sched(ns, eng, **kw)
    counts = sched2.restore(snap)
    fin = sched2.run()
    assert _streams(fin) == _streams(baseline)
    assert sched2.pool.leak_report() == []
    return open(path).read(), counts, _streams(fin)


@pytest.mark.parametrize("layout,cross", [
    ("paged", False), ("slots", False), ("paged", True)])
def test_live_snapshot_restore_parity(engines, tmp_path, layout, cross):
    """snapshot() / restore() mid-stream without a journal, through a JSON
    file (the reference's bytes; read by either implementation): bitwise
    the uninterrupted streams; ``slots`` re-admits whole prompts."""
    text, counts, _ = both(engines, _live, tmp_path=tmp_path, layout=layout,
                           cross=cross)
    assert counts["live"] > 0 and json.loads(text)["version"] == 1


def test_restore_requires_fresh_scheduler(port_side):
    cfg, ns, eng = port_side
    rng = np.random.default_rng(0)
    sched = _sched(ns, eng)
    sched.submit(_req(ns, cfg, rng, 0, plen=8, max_new=4))
    snap = sched.snapshot()
    sched.step()
    with pytest.raises(ValueError, match="fresh"):
        sched.restore(snap)
    sched.run()
    bad = dict(snap)
    bad["version"] = 999
    with pytest.raises(ValueError, match="version"):
        _sched(ns, eng).restore(bad)


# ---------------------------------------------------------------------------
# crashes through the chaos harness and the launcher's client loop
# ---------------------------------------------------------------------------

def _crash_chaos(ns, eng, cfg, tmp_path, wl_seed, stochastic):
    baseline = _sched(ns, eng).run_stream(
        _wl(ns, cfg, wl_seed, n=10, stochastic=stochastic))
    path = str(tmp_path / f"crash_{ns.name}_{wl_seed}.jsonl")
    o = ns.O.ServeObservability(metrics=True)

    def factory():
        return _sched(ns, eng, journal=ns.R.RequestJournal(path), o=o)

    plan = ns.F.FaultPlan(seed=21, horizon=40, p_crash=0.25, p_exhaust=0.0,
                          p_straggler=0.0, p_disconnect=0.0, p_malformed=0.0)
    res = ns.F.run_chaos(factory(), _wl(ns, cfg, wl_seed, n=10,
                                        stochastic=stochastic),
                         plan, sched_factory=factory)
    assert res["crashes"] >= 1, "no crash fired"
    assert not res["leak_findings"], res["leak_findings"]
    assert _streams(res["finished"]) == _streams(baseline)
    assert res["sched"].shutdown(grace_ticks=4).clean
    snap = o.metrics.snapshot()
    counters = {k: v["value"] for k, v in snap.items()
                if v["type"] == "counter"}
    return res["crashes"], _lines(path), counters


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["greedy", "stochastic"])
def test_crash_restart_chaos_parity(engines, tmp_path, stochastic):
    """p_crash abandons the scheduler inside run_chaos; the factory's
    scheduler restores from the shared journal. Every stream bitwise the
    crash-free run's; crashes, the journal across all incarnations and
    every counter equal the reference's."""
    crashes, _, counters = both(engines, _crash_chaos, tmp_path=tmp_path,
                                wl_seed=64 + int(stochastic),
                                stochastic=stochastic)
    assert crashes >= 1 and counters["sched_requests_submitted_total"] > 10


def test_crash_restore_drops_the_dead_pool(port_side, tmp_path):
    """The abandoned scheduler's pool tensors are released before the
    replacement allocates its own."""
    cfg, ns, eng = port_side
    path = str(tmp_path / "drop.jsonl")
    old = _sched(ns, eng, journal=rec.RequestJournal(path))
    for _, r in _wl(ns, cfg, 53):
        old.submit(r)
    old.step()
    seen = {}

    def factory():
        seen["cache"] = old.pool.cache
        return _sched(ns, eng, journal=rec.RequestJournal(path))
    new, snap, counts = faults.crash_restore(old, factory)
    assert seen["cache"] is None and new.pool.cache is not None
    assert counts["live"] == len(snap["requests"]) > 0
    new.run()
    assert new.pool.leak_report() == []


def _launcher_crash(ns, eng, cfg, tmp_path, crash_at):
    path = str(tmp_path / f"launch_{ns.name}_{crash_at}.jsonl")
    arrivals = _wl(ns, cfg, 66, n=10, stochastic=True)

    def make():
        return _sched(ns, eng, journal=ns.R.RequestJournal(path),
                      max_queue=3)
    if ns is PORT:
        gave_up, retries, _, sched = launcher.run_with_retries(
            make(), arrivals, crash_at_tick=crash_at, make_sched=make)
    else:
        from repro.launch import serve as jlaunch
        gave_up, retries, _, sched = jlaunch.run_with_retries(
            make(), arrivals, grace_ticks=-1, max_retries=4, backoff=2,
            crash_at_tick=crash_at, make_sched=make)
    assert sched.pool.leak_report() == [] and not sched.busy()
    sched.journal.close()
    return gave_up, retries, sched.ticks, _streams(sched.finished), \
        _lines(path)


@pytest.mark.parametrize("crash_at", [3, 7])
def test_launcher_crash_at_tick_matches_reference(engines, tmp_path,
                                                  crash_at):
    """The launcher's client loop with a crash at a global tick (and a
    bounded queue, so sheds and retries cross it): gave-up rids, retries,
    the ticks of the last incarnation, the streams and the whole journal
    equal the reference launcher's."""
    gave_up, retries, ticks, fin, lines = both(
        engines, _launcher_crash, tmp_path=tmp_path, crash_at=crash_at)
    assert sum('"restored":true' in line for line in lines) > 0


def test_quarantine_terminal_in_journal_and_slo(engines, tmp_path):
    """A quarantine is terminal: journaled (replay keeps it out of the
    re-admission), counted in the SLOs, refilled by restore."""
    def scenario(ns, eng, cfg):
        rng = np.random.default_rng(1)
        path = str(tmp_path / f"q_{ns.name}.jsonl")
        o = ns.O.ServeObservability(metrics=True)
        sched = _sched(ns, eng, journal=ns.R.RequestJournal(path), o=o)
        reqs = [_req(ns, cfg, rng, rid, plen=8, max_new=5)
                for rid in range(2)]
        for r in reqs:
            sched.submit(r)
        while len(sched.running) < 2:
            sched.step()
        sched.quarantine(reqs[0].rid, reason="nan_logits")
        sched.run()
        sched.journal.close()
        events = [json.loads(line) for line in _lines(path)]
        assert any(e["ev"] == "quarantine" and e["rid"] == 0
                   for e in events)
        snap = ns.R.replay_journal(path)
        by_rid = {r["rid"]: r for r in snap["requests"]}
        assert by_rid[0]["status"] == "quarantined"
        assert by_rid[1]["status"] == "finished"
        sched2 = _sched(ns, eng)
        counts = sched2.restore(snap)
        assert counts["live"] == 0
        assert counts["quarantined"] == 1 and counts["finished"] == 1
        assert 0 in sched2.quarantined and 1 in sched2.finished
        assert o.slo.summary()["quarantines"] == {"nan_logits": 1}
        return _lines(path), counts
    both(engines, scenario)


def test_launcher_main_crashes_and_restores_on_the_cpu(tmp_path, capsys):
    """``--journal --crash-at-tick`` through the launcher's ``main`` with
    metrics, the trace and the leak sweep on: the stream finishes as the
    uninterrupted run's, the trace loads, the SLO summary prints; then
    ``--restore-from`` of the finished journal serves nothing new."""
    base = ["--device", "cpu", "--reduced", "--demo", "--tasks", "3",
            "--requests", "6", "--quiet"]
    plain = launcher.main(base)
    journal = str(tmp_path / "j.jsonl")
    trace = str(tmp_path / "trace.json")
    sched = launcher.main(base + ["--metrics", "--check-leaks",
                                  "--journal", journal, "--crash-at-tick",
                                  "6", "--trace-out", trace])
    out = capsys.readouterr().out
    assert "simulated crash at tick 6" in out and "SLO summary" in out
    assert _streams(sched.finished) == _streams(plain.finished)
    events = json.load(open(trace))["traceEvents"]
    assert any(e["name"] == "dispatch" for e in events)
    again = launcher.main(base[:-3] + ["--requests", "0", "--quiet",
                                       "--restore-from", journal])
    assert _streams(again.finished) == _streams(plain.finished)
    with pytest.raises(SystemExit):
        launcher.main(base + ["--crash-at-tick", "3"])
