"""The port's self-healing serving tick against the JAX reference's: submit
validation, ``abort`` in every state, deadlines, ``shutdown``, the paged
pool's seize / restore / quarantine bookkeeping, the NaN watchdog and its
quarantine, dispatch retries, and seeded chaos through ``serve.faults``.

Each scenario runs on both schedulers in this process (``tiny_lm``, f32,
the same requests from the same seeds) and must give the same counters
and the same tokens; survivors must also equal a fault-free run. The
write-fresh rule (``Model.mixed_step``) is held by raising in the middle
of a chunk tick's forward, after the pool was written in place, and by
the plain attention versions ignoring NaN past each row's length."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_util import jax_tasks, port_lm, port_tables
from repro.serve import faults as jfaults
from repro.serve import scheduler as jsched
from repro.serve.engine import DispatchFault as JDispatchFault
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.kv_pool import PagedKVPool as JPool
from repro.serve.sampling import SamplingParams as JSampling
from repro_torch.kernels import decode_attention as da
from repro_torch.models import layers as port_layers
from repro_torch.models.model import check_write_fresh
from repro_torch.serve import faults
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.engine import DispatchFault, ServeConfig, ServeEngine
from repro_torch.serve.kv_pool import PagedKVPool
from repro_torch.serve.sampling import SamplingParams

MAX_LEN = 48
REF = SimpleNamespace(name="reference", S=jsched, F=jfaults,
                      Sampling=JSampling, DispatchFault=JDispatchFault)
PORT = SimpleNamespace(name="port", S=sched_mod, F=faults,
                       Sampling=SamplingParams, DispatchFault=DispatchFault)


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


def both(engines, scenario, **kw):
    """Run ``scenario(ns, eng, cfg, **kw)`` on the reference and on the
    port; their results must be equal. Returns the port's."""
    cfg, sides = engines
    got = {name: scenario(ns, eng, cfg, **kw)
           for name, (ns, eng) in sides.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def _req(ns, cfg, rng, rid, plen=None, max_new=None, **kw):
    plen = plen if plen is not None else int(rng.integers(3, 17))
    max_new = max_new if max_new is not None else int(rng.integers(2, 9))
    return ns.S.Request(
        rid=rid, prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
        task_id=int(rng.integers(0, 3)), max_new_tokens=max_new, **kw)


def _ref(eng, req):
    """The fault-free stream: the engine's own static batch of one."""
    return eng.generate(req.prompt[None], req.max_new_tokens,
                        np.asarray([req.task_id], np.int32))[0].tolist()


def _sched(ns, eng, **kw):
    base = dict(num_slots=3, bucket_min=8, kv_layout="paged", block_size=8,
                prefill_chunk=8)
    base.update(kw)
    return ns.S.ContinuousScheduler(eng, ns.S.SchedulerConfig(**base))


def _clean(sched):
    assert sched.pool.leak_report() == []


def _outs(reqs):
    return {r.rid: list(map(int, r.out)) for r in reqs}


# ---------------------------------------------------------------------------
# submit() validation
# ---------------------------------------------------------------------------

def _invalid_variants(ns):
    p = np.asarray([1, 2, 3], np.int32)
    R, SP = ns.S.Request, ns.Sampling
    return {
        "empty_prompt": R(rid=0, prompt=np.asarray([], np.int32)),
        "2d_prompt": R(rid=0, prompt=np.zeros((2, 3), np.int32)),
        "zero_max_new": R(rid=0, prompt=p, max_new_tokens=0),
        "zero_max_tokens": R(rid=0, prompt=p, sampling=SP(max_tokens=0)),
        "n_zero": R(rid=0, prompt=p, sampling=SP(n=0)),
        "unknown_task": R(rid=0, prompt=p, task_id=99),
        "negative_task": R(rid=0, prompt=p, task_id=-1),
        "nan_temperature": R(rid=0, prompt=p,
                             sampling=SP(temperature=float("nan"))),
        "nan_top_p": R(rid=0, prompt=p,
                       sampling=SP(temperature=0.7, top_p=float("nan"))),
        "bad_deadline": R(rid=0, prompt=p, deadline_ticks=0),
        "does_not_fit": R(rid=0, prompt=p, max_new_tokens=1000),
    }


def _invalid(ns, eng, cfg, variant):
    sched = _sched(ns, eng, num_slots=2)
    with pytest.raises(ns.S.InvalidRequest) as ei:
        sched.submit(_invalid_variants(ns)[variant])
    assert len(sched.queue) == 0 and not sched.running
    _clean(sched)
    return isinstance(ei.value, ValueError)


@pytest.mark.parametrize("variant", sorted(_invalid_variants(PORT)))
def test_invalid_request_rejected(engines, variant):
    """Every malformed submission bounces with InvalidRequest (a
    ValueError) and leaves nothing queued and the pool clean."""
    assert both(engines, _invalid, variant=variant)


def test_invalid_request_is_value_error(engines):
    _, sides = engines
    for ns, eng in sides.values():
        sched = _sched(ns, eng, num_slots=2)
        with pytest.raises(ValueError, match="does not fit"):
            sched.submit(ns.S.Request(rid=1, prompt=np.asarray([1, 2],
                                                               np.int32),
                                      max_new_tokens=1000))


# ---------------------------------------------------------------------------
# abort() in every lifecycle state
# ---------------------------------------------------------------------------

def _abort_queued(ns, eng, cfg):
    rng = np.random.default_rng(0)
    sched = _sched(ns, eng, num_slots=2, num_blocks=7)
    keeper = _req(ns, cfg, rng, 0, plen=16, max_new=6)
    victim = _req(ns, cfg, rng, 1, plen=33, max_new=6)  # 5 pages: no co-fit
    sched.submit(keeper)
    sched.submit(victim)
    sched.step()
    assert victim.state == "queued" and len(sched.queue) == 1
    assert sched.abort(1, reason="client")
    assert victim.state == ns.S.ABORTED and victim.finish_reason == "client"
    assert not sched.abort(1), "a second abort is a no-op"
    fin = sched.run()
    _clean(sched)
    assert sorted(fin) == [0] and 1 in sched.aborted
    assert list(fin[0].out) == _ref(eng, keeper)
    return _outs([keeper, victim]), sched.ticks


def test_abort_queued(engines):
    both(engines, _abort_queued)


def _abort_mid_prefill(ns, eng, cfg):
    rng = np.random.default_rng(0)
    sched = _sched(ns, eng)
    keeper = _req(ns, cfg, rng, 0, plen=6, max_new=6)
    victim = _req(ns, cfg, rng, 1, plen=16, max_new=6)  # 2 chunk ticks
    sched.submit(keeper)
    sched.submit(victim)
    sched.step()
    assert any(pf.req.rid == 1 for pf in sched._prefills)
    assert sched.abort(1)
    assert not any(pf.req.rid == 1 for pf in sched._prefills)
    fin = sched.run()
    _clean(sched)
    assert sorted(fin) == [0]
    assert list(fin[0].out) == _ref(eng, keeper)
    return _outs([keeper, victim]), sched.ticks


def test_abort_mid_prefill(engines):
    both(engines, _abort_mid_prefill)


def _abort_mid_decode(ns, eng, cfg):
    rng = np.random.default_rng(0)
    sched = _sched(ns, eng)
    keeper = _req(ns, cfg, rng, 0, plen=8, max_new=8)
    victim = _req(ns, cfg, rng, 1, plen=8, max_new=8)
    sched.submit(keeper)
    sched.submit(victim)
    for _ in range(3):
        sched.step()
    assert victim.state == "running" and victim.out
    assert sched.abort(1)
    assert 1 not in {r.rid for r in sched.running.values()}
    fin = sched.run()
    _clean(sched)
    assert sorted(fin) == [0]
    assert list(fin[0].out) == _ref(eng, keeper)
    return _outs([keeper, victim]), sched.ticks


def test_abort_mid_decode(engines):
    both(engines, _abort_mid_decode)


def _abort_from_callback(ns, eng, cfg):
    """An on_token callback that aborts its own request and another one
    mid-tick: the tick skips both rows, the third stream is unchanged."""
    rng = np.random.default_rng(1)
    sched = _sched(ns, eng)

    def on_token(req, tok):
        if req.rid == 0 and len(req.out) == 3:
            sched.abort(0, reason="client")
            sched.abort(2, reason="client")
    reqs = [_req(ns, cfg, rng, i, plen=8, max_new=8, on_token=on_token)
            for i in range(3)]
    for r in reqs:
        sched.submit(r)
    fin = sched.run()
    _clean(sched)
    assert sorted(fin) == [1] and sorted(sched.aborted) == [0, 2]
    assert list(fin[1].out) == _ref(eng, reqs[1])
    return _outs(reqs), sched.ticks


def test_abort_from_on_token_callback(engines):
    both(engines, _abort_from_callback)


def test_abort_unknown_rid(engines):
    _, sides = engines
    for ns, eng in sides.values():
        assert not _sched(ns, eng).abort(12345)


# ---------------------------------------------------------------------------
# deadlines and graceful drain
# ---------------------------------------------------------------------------

def _deadline_abort(ns, eng, cfg):
    rng = np.random.default_rng(0)
    sched = _sched(ns, eng, num_slots=2, num_blocks=7)
    keeper = _req(ns, cfg, rng, 0, plen=16, max_new=10)
    doomed = _req(ns, cfg, rng, 1, plen=16, max_new=6, deadline_ticks=3)
    sched.submit(keeper)
    sched.submit(doomed)           # queues behind the keeper's pages
    fin = sched.run()
    _clean(sched)
    assert sorted(fin) == [0]
    assert doomed.state == ns.S.ABORTED and doomed.finish_reason == "deadline"
    assert sched.deadline_misses == 1 and 1 in sched.aborted
    assert list(fin[0].out) == _ref(eng, keeper)
    return _outs([keeper, doomed]), sched.ticks


def test_deadline_abort_frees_pages(engines):
    both(engines, _deadline_abort)


def _deadline_met(ns, eng, cfg):
    rng = np.random.default_rng(0)
    sched = _sched(ns, eng)
    req = _req(ns, cfg, rng, 0, plen=8, max_new=4, deadline_ticks=50)
    sched.submit(req)
    fin = sched.run()
    _clean(sched)
    assert sched.deadline_misses == 0
    assert list(fin[0].out) == _ref(eng, req)
    return _outs([req]), sched.ticks


def test_deadline_met_is_untouched(engines):
    both(engines, _deadline_met)


def _report(rep):
    return (rep.finished, rep.shed_rids, rep.grace_ticks_used,
            rep.leak_findings, rep.quarantined_pages_released, rep.clean)


def _shutdown_graceful(ns, eng, cfg):
    rng = np.random.default_rng(0)
    sched = _sched(ns, eng)
    reqs = [_req(ns, cfg, rng, i, plen=8, max_new=4) for i in range(3)]
    for r in reqs:
        sched.submit(r)
    report = sched.shutdown(grace_ticks=100)
    assert report.clean and not report.shed_rids
    assert report.finished == 3 and sorted(sched.finished) == [0, 1, 2]
    late = _req(ns, cfg, rng, 9)
    with pytest.raises(ns.S.ShedError) as ei:
        sched.submit(late)
    assert ei.value.reason == "shutting_down" and 9 in sched.shed
    assert late.state == ns.S.SHED
    _clean(sched)
    for r in reqs:
        assert list(r.out) == _ref(eng, r)
    return _outs(reqs), _report(report)


def test_shutdown_graceful_finishes_inflight(engines):
    both(engines, _shutdown_graceful)


def _shutdown_short_grace(ns, eng, cfg):
    rng = np.random.default_rng(0)
    sched = _sched(ns, eng)
    reqs = [_req(ns, cfg, rng, i, plen=16, max_new=8) for i in range(4)]
    for r in reqs:
        sched.submit(r)
    with pytest.raises(ns.S.InvalidConfig):
        sched.shutdown(grace_ticks=-1)
    report = sched.shutdown(grace_ticks=2)
    assert report.clean, report.leak_findings
    assert report.shed_rids and report.grace_ticks_used == 2
    assert set(sched.finished) | set(report.shed_rids) == {0, 1, 2, 3}
    for rid in report.shed_rids:
        assert sched.aborted[rid].finish_reason == "shutdown"
    _clean(sched)
    return _outs(reqs), _report(report)


def test_shutdown_short_grace_sheds_rest(engines):
    both(engines, _shutdown_short_grace)


# ---------------------------------------------------------------------------
# the paged pool: seize / restore / quarantine bookkeeping
# ---------------------------------------------------------------------------

def _pool_state(pool):
    return (pool.block_tables.tolist(), pool._refs.tolist(),
            list(pool._free_blocks), list(pool._free_slots),
            pool.cur_len.tolist(), pool.task_id.tolist(),
            pool.blocks_in_use(), pool.free_blocks(), pool.num_seized(),
            pool.num_quarantined(), sorted(pool._seized),
            sorted(pool._quarantined), pool.leak_report())


def test_pool_bookkeeping_with_faults_matches_reference(engines):
    """``test_torch_serve``'s bookkeeping sequence, extended to
    seize_pages, restore_pages, quarantine_slot and release_quarantined:
    every return value and every piece of state equals the reference's."""
    _, sides = engines
    jeng, eng = sides["reference"][1], sides["port"][1]
    mine = PagedKVPool(eng.model, 3, 24, block_size=4, num_blocks=12)
    ref = JPool(jeng.model, 3, 24, block_size=4, num_blocks=12)
    ops = [("alloc", 1, 2), ("seize_pages", 3), ("alloc", 2, 3),
           ("commit_prefill", 0, 7), ("ensure_append_page", 0),
           ("advance", [0]), ("ensure_append_page", 0),
           ("commit_prefill", 1, 12), ("ensure_append_page", 1),
           ("alloc", 0, 6),                              # short: None
           ("quarantine_slot", 1), ("alloc", 0, 1),
           ("seize_pages", 9),                           # none left: []
           ("advance", [0, 0, 0, 0]),
           ("ensure_append_page", 0),                    # dry: False
           ("free", 0), ("release_quarantined",), ("quarantine_slot", 1)]
    seized = {}
    for k, (op, *args) in enumerate(ops):
        got = getattr(mine, op)(*args)
        want = getattr(ref, op)(*args)
        assert got == want, (op, args)
        assert _pool_state(mine) == _pool_state(ref), (op, args)
        if op == "seize_pages":
            seized[k] = got
    assert any("still seized" in f for f in mine.leak_report())
    for pages in seized.values():
        mine.restore_pages(pages)
        ref.restore_pages(pages)
        assert _pool_state(mine) == _pool_state(ref)
    with pytest.raises(ValueError, match="was not seized"):
        mine.restore_pages(seized[1])
    # a quarantine hold is accounted, not a finding
    assert mine.num_quarantined() > 0 and mine.leak_report() == []
    assert mine.release_quarantined() == ref.release_quarantined() > 0
    assert _pool_state(mine) == _pool_state(ref)
    assert mine.leak_report() == [] and mine.blocks_in_use() == 0


def _seize_restore(ns, eng, cfg):
    sched = _sched(ns, eng, num_blocks=14)
    pages = sched.pool.seize_pages(4)
    assert len(pages) == 4 and sched.pool.num_seized() == 4
    report = sched.pool.leak_report()
    assert any("seized" in f for f in report)
    sched.pool.restore_pages(pages)
    _clean(sched)
    return pages, report


def test_pool_seize_restore_accounting(engines):
    both(engines, _seize_restore)


def _total_exhaustion(ns, eng, cfg):
    rng = np.random.default_rng(0)
    sched = _sched(ns, eng, num_blocks=14)
    req = _req(ns, cfg, rng, 0, plen=8, max_new=10)
    sched.submit(req)
    for _ in range(3):
        sched.step()
    assert req.state == "running"
    pages = sched.pool.seize_pages(sched.pool.free_blocks())
    for _ in range(8):             # decode reaches position 16: no page
        sched.step()
    sched.pool.restore_pages(pages)
    fin = sched.run()
    _clean(sched)
    assert sched.preemptions >= 1
    assert list(fin[0].out) == _ref(eng, req)
    return _outs([req]), sched.ticks, sched.preemptions


def test_total_exhaustion_self_preempts_not_crashes(engines):
    """With every free page seized, the sole running row parks itself in
    the queue instead of raising, and resumes exactly."""
    both(engines, _total_exhaustion)


# ---------------------------------------------------------------------------
# the self-healing tick: NaN watchdog, dispatch retries
# ---------------------------------------------------------------------------

def _nan_quarantine(ns, eng, cfg):
    rng = np.random.default_rng(0)
    sched = _sched(ns, eng, num_blocks=14)
    reqs = [_req(ns, cfg, rng, rid, plen=9, max_new=6) for rid in range(3)]
    for r in reqs:
        sched.submit(r)
    while len(sched.running) < 3:
        sched.step()
    victim = sorted(sched.running)[1]
    victim_rid = sched.running[victim].rid
    eng.inject_fault("nan", victim)
    sched.step()
    assert victim_rid in sched.quarantined
    assert sched.quarantined[victim_rid].state == ns.S.QUARANTINED
    assert sched.quarantined[victim_rid].finish_reason == "nan_logits"
    assert sched.pool.num_quarantined() > 0
    assert sched.tick_retries_used >= 1
    fin = sched.run()
    for r in reqs:
        if r.rid == victim_rid:
            assert r.rid not in fin
        else:
            assert list(fin[r.rid].out) == _ref(eng, r)
    _clean(sched)          # the hold is accounted, not a leak
    report = sched.shutdown()
    assert report.quarantined_pages_released > 0 and report.clean
    assert sched.pool.num_quarantined() == 0
    _clean(sched)
    return _outs(reqs), _report(report), sched.tick_retries_used


def test_nan_quarantines_poisoned_request_only(engines):
    both(engines, _nan_quarantine)


def _wl(ns, cfg, seed, n=10, stochastic=False):
    """Deterministic arrivals, rebuilt for every run that is compared."""
    rng = np.random.default_rng(seed)
    arrivals = []
    for i in range(n):
        plen = int(rng.integers(3, 17))
        sp = None
        if stochastic and i % 3 == 0:
            sp = ns.Sampling(temperature=0.8, top_k=20, seed=100 + i)
        arrivals.append((int(rng.integers(0, n)), ns.S.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                       plen).astype(np.int32),
            task_id=int(rng.integers(0, 3)),
            max_new_tokens=int(rng.integers(3, 9)), sampling=sp)))
    return arrivals


def _chaos_sched(ns, eng):
    return _sched(ns, eng, num_blocks=14)


def _nan_chaos(ns, eng, cfg):
    baseline = _chaos_sched(ns, eng).run_stream(_wl(ns, cfg, 63))
    plan = ns.F.FaultPlan(seed=9, horizon=40, p_nan=0.22, p_exhaust=0.0,
                          p_straggler=0.0, p_disconnect=0.0,
                          p_malformed=0.0)
    res = ns.F.run_chaos(_chaos_sched(ns, eng), _wl(ns, cfg, 63), plan)
    assert res["injector"].applied["nan"] > 0
    assert res["quarantined"], "no request was quarantined"
    assert not res["leak_findings"], res["leak_findings"]
    survivors = set(res["finished"])
    assert survivors == set(baseline) - set(res["quarantined"])
    for rid in survivors:
        assert list(res["finished"][rid].out) == list(baseline[rid].out)
    sched = res["sched"]
    assert sched.shutdown().quarantined_pages_released > 0
    _clean(sched)
    return (_outs(res["finished"].values()), sorted(res["quarantined"]),
            sched.tick_retries_used)


def test_nan_chaos_plan_quarantines_and_survivors_hold(engines):
    both(engines, _nan_chaos)


def _alloc_failure(ns, eng, cfg):
    rng = np.random.default_rng(0)
    sched = _sched(ns, eng, num_blocks=14)
    req = _req(ns, cfg, rng, 0, plen=8, max_new=6)
    sched.submit(req)
    for _ in range(2):
        sched.step()
    d0 = eng.dispatches
    eng.inject_fault("alloc_failure")
    fin = sched.run()
    assert sched.dispatch_faults == 1 and sched.tick_retries_used == 1
    assert eng.dispatches - d0 == sched.ticks - 2, "the fault dispatched"
    assert list(fin[0].out) == _ref(eng, req)
    _clean(sched)
    return _outs([req]), sched.ticks


def test_alloc_failure_is_retried_transparently(engines):
    both(engines, _alloc_failure)


@pytest.mark.parametrize("retries", [0, 1, 2])
def test_dispatch_fault_exhausts_retries(engines, monkeypatch, retries):
    """A dispatch that faults every time is tried ``1 + tick_retries``
    times, then re-raised; nothing was emitted or committed."""
    cfg, sides = engines
    for ns, eng in sides.values():
        sched = _sched(ns, eng, num_blocks=14, tick_retries=retries)
        req = _req(ns, cfg, np.random.default_rng(0), 0, plen=8, max_new=4)
        sched.submit(req)
        calls = []

        def boom(*a, **kw):
            calls.append(1)
            raise ns.DispatchFault("persistent device fault")
        monkeypatch.setattr(eng, "serve_step", boom)
        with pytest.raises(ns.DispatchFault):
            sched.step()
        monkeypatch.undo()
        assert len(calls) == 1 + retries, ns.name
        assert sched.dispatch_faults == 1 + retries
        assert sched.tick_retries_used == retries
        assert req.out == [] and sched._prefills[0].done == 0


def test_engine_refuses_unknown_fault_kind(engines):
    _, sides = engines
    with pytest.raises(ValueError, match="unknown injected fault"):
        sides["port"][1].inject_fault("meltdown")


# ---------------------------------------------------------------------------
# in-place KV writes against a retried tick (the write-fresh rule)
# ---------------------------------------------------------------------------

def _streams(ns, eng, cfg, arm=None):
    """Serve ``_wl(..., 5)`` (greedy); ``arm(sched)`` may arm a fault
    before each tick."""
    sched = _chaos_sched(ns, eng)
    arrivals = _wl(ns, cfg, 5, n=8)
    order = sorted(arrivals, key=lambda a: a[0])
    i = 0
    while i < len(order) or sched.busy():
        if not sched.busy() and order[i][0] > sched.clock:
            sched.clock = order[i][0]
        while i < len(order) and order[i][0] <= sched.clock:
            sched.submit(order[i][1])
            i += 1
        if arm is not None:
            arm(sched)
        sched.step()
    _clean(sched)
    return sched, {rid: list(r.out) for rid, r in sched.finished.items()}


def test_mid_forward_exception_is_retried_bitwise(engines, monkeypatch):
    """A one-shot exception raised after the first layer of a chunk tick,
    when that layer has already written K/V into the pool in place: the
    tick is retried and every stream is bitwise the fault-free run's."""
    cfg, sides = engines
    ns, eng = sides["port"]
    _, twin = _streams(ns, eng, cfg)
    model = eng.model
    block = model._block
    state = {"armed": False, "fired": 0, "before": None, "wrote": False}

    def hooked(lp, h, sincos, attend, peft, i, aot):
        if state["armed"] and i == 1:
            state["armed"] = False
            state["fired"] += 1
            cache = state["sched"].pool.cache
            state["wrote"] = any(not torch.equal(cache[n], state["before"][n])
                                 for n in ("k", "v"))
            raise RuntimeError("injected fault between layers")
        return block(lp, h, sincos, attend, peft, i, aot)
    monkeypatch.setattr(model, "_block", hooked)

    def arm(sched):
        if not state["fired"] and sched._prefills and sched.running:
            state["armed"], state["sched"] = True, sched
            state["before"] = {n: c.clone()
                               for n, c in sched.pool.cache.items()}
    sched, got = _streams(ns, eng, cfg, arm)
    assert state["fired"] == 1 and state["wrote"], \
        "the raised attempt never wrote the pool"
    assert sched.dispatch_faults == 1 and sched.tick_retries_used == 1
    assert got == twin


def test_write_fresh_rule_is_checked_before_dispatch(engines, monkeypatch):
    """``check_write_fresh`` refuses a live token below its slot's
    committed depth (dead tokens pass), and the scheduler runs it on every
    tick's packed arrays before the dispatch."""
    rows = np.asarray([0, 1, 1, 0], np.int32)
    check_write_fresh(rows, np.asarray([5, 2, 3, -1], np.int32),
                      np.asarray([5, 2], np.int32))
    with pytest.raises(ValueError, match="slot 1 writes position 2 below"):
        check_write_fresh(rows, np.asarray([5, 2, 3, -1], np.int32),
                          np.asarray([5, 3], np.int32))
    cfg, sides = engines
    ns, eng = sides["port"]
    seen = []

    def spy(token_rows, token_pos, committed):
        seen.append((token_pos.copy(), committed.copy()))
        check_write_fresh(token_rows, token_pos, committed)
    monkeypatch.setattr(sched_mod, "check_write_fresh", spy)
    sched = _sched(ns, eng, num_blocks=14)
    d0 = eng.dispatches
    sched.run_stream(_wl(ns, cfg, 5, n=4))
    assert len(seen) == eng.dispatches - d0 == sched.ticks


def _nan_inputs(gen, b=3, S=32, kvh=2, g=3, hd=8, bs=4):
    """Random q and contiguous caches with per-row lengths, the positions
    past each row's length given as a mask."""
    q = torch.from_numpy(gen.normal(size=(b, kvh * g, hd))).float()
    k = torch.from_numpy(gen.normal(size=(b, S, kvh, hd))).float()
    v = torch.from_numpy(gen.normal(size=(b, S, kvh, hd))).float()
    lens = np.asarray([0, 5, 19][:b], np.int32)
    past = torch.arange(S)[None, :] >= torch.from_numpy(lens)[:, None]
    return q, k, v, lens, past


def _poison(x, where, fill):
    return torch.where(where[..., None, None], torch.full_like(x, fill), x)


def test_plain_decode_ignores_nan_past_each_row(engines):
    """The plain decode versions give bitwise the same output with NaN or
    zeros past each row's length (the CUDA walks stage zeros there)."""
    q, k, v, lens, past = _nan_inputs(np.random.default_rng(0))
    lt = torch.from_numpy(lens)
    outs = [da.decode_attention_plain(q, _poison(k, past, f),
                                      _poison(v, past, f), lt)
            for f in (0.0, float("nan"))]
    assert torch.isfinite(outs[1]).all()
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0][0], torch.zeros_like(outs[0][0]))
    # the reference's XLA layout (a cur_len-0 row still averages the
    # whole cache, as the reference's does, so rows 1-2 only)
    outs = [port_layers.attention_decode(q[1:, None], _poison(k, past, f)[1:],
                                         _poison(v, past, f)[1:], lt[1:])
            for f in (0.0, float("nan"))]
    assert torch.isfinite(outs[1]).all()
    assert torch.equal(outs[0], outs[1])


def _paged(k, v, bs):
    """Pages 1.. of a contiguous (b, S) cache, each row's table in order;
    page 0 is scratch."""
    b, S = k.shape[:2]
    npages = S // bs
    kp = torch.zeros((1 + b * npages, bs) + k.shape[2:])
    vp = torch.zeros_like(kp)
    kp[1:] = k.reshape((b * npages, bs) + k.shape[2:])
    vp[1:] = v.reshape((b * npages, bs) + v.shape[2:])
    bt = torch.arange(1, 1 + b * npages, dtype=torch.int32).view(b, npages)
    return kp, vp, bt


@pytest.mark.parametrize("entry", ["paged", "ragged", "layers_paged"])
def test_plain_paged_ignores_nan_past_length_and_on_page_0(engines, entry):
    """Paged and ragged plain versions: NaN past each row's length, on
    scratch page 0, and in the table entries past the length that point at
    page 0 give bitwise the output of zeros there."""
    bs = 4
    q, k, v, lens, past = _nan_inputs(np.random.default_rng(1), bs=bs)
    lt = torch.from_numpy(lens)
    outs = []
    for fill in (0.0, float("nan")):
        kp, vp, bt = _paged(_poison(k, past, fill), _poison(v, past, fill),
                            bs)
        kp[0], vp[0] = fill, fill
        bt = bt.clone()
        bt[0, 2:] = 0                   # unmapped entries of row 0 (len 0)
        bt[1, 3:] = 0                   # row 1: length 5 -> pages 0-1 read
        if entry == "paged":
            out = da.paged_decode_attention_plain(q, kp, vp, bt, lt)
        elif entry == "layers_paged":
            out = port_layers.paged_attention_decode(q[1:, None], kp, vp,
                                                     bt[1:], lt[1:])
        else:
            # each row's last position as a decode token, plus dead tokens
            rows = torch.tensor([1, 2, 0, 2], dtype=torch.int32)
            pos = torch.tensor([4, 18, -1, -1], dtype=torch.int32)
            qq = torch.cat([q, q[:1]])
            out = da.ragged_paged_attention_plain(qq, kp, vp, bt, rows, pos)
        outs.append(out)
    assert torch.isfinite(outs[1]).all()
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# the fault plan and the chaos harness against the reference
# ---------------------------------------------------------------------------

PLANS = {
    "defaults": dict(seed=0),
    "busy": dict(seed=3, horizon=40, p_exhaust=0.12, exhaust_pages=8,
                 exhaust_ticks=3, p_straggler=0.18, straggler_ms=0.5,
                 p_disconnect=0.10, p_malformed=0.18),
    "every_kind": dict(seed=11, horizon=64, p_exhaust=0.2, p_straggler=0.2,
                       p_disconnect=0.2, p_malformed=0.2, p_nan=0.2,
                       p_alloc_failure=0.2, p_crash=0.2),
    "nan_only": dict(seed=9, horizon=40, p_nan=0.22, p_exhaust=0.0,
                     p_straggler=0.0, p_disconnect=0.0, p_malformed=0.0),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_fault_plan_events_equal_reference(plan):
    mine = faults.FaultPlan(**PLANS[plan]).events()
    ref = jfaults.FaultPlan(**PLANS[plan]).events()
    assert faults.FAULT_KINDS == jfaults.FAULT_KINDS
    assert len(mine) == len(ref) > 0
    for a, b in zip(mine, ref):
        assert (a.tick, a.kind, a.u, a.pages, a.dur) == \
            (b.tick, b.kind, b.u, b.pages, b.dur)


def _chaos(ns, eng, cfg, stochastic, plan, wl_seed, kinds):
    """The reference's chaos parity: drains, leak-free, every named kind
    fired, survivors bitwise the fault-free twin's."""
    baseline = _chaos_sched(ns, eng).run_stream(
        _wl(ns, cfg, wl_seed, stochastic=stochastic))
    sched = _chaos_sched(ns, eng)
    res = ns.F.run_chaos(sched, _wl(ns, cfg, wl_seed, stochastic=stochastic),
                         ns.F.FaultPlan(**plan))
    inj = res["injector"]
    assert not res["leak_findings"], res["leak_findings"]
    assert not sched.busy() and inj.malformed_ok
    for kind in kinds:
        assert inj.applied[kind] > 0, f"{kind} never fired: {inj.applied}"
    survivors = set(res["finished"])
    assert survivors
    assert survivors == (set(baseline) - set(inj.disconnected)
                         - set(res["quarantined"]))
    for rid in survivors:
        assert list(res["finished"][rid].out) == list(baseline[rid].out), rid
    report = sched.shutdown()
    assert report.clean
    return dict(ticks=sched.ticks, preemptions=sched.preemptions,
                dispatch_faults=sched.dispatch_faults,
                retries=sched.tick_retries_used, applied=dict(inj.applied),
                finished=_outs(res["finished"].values()),
                aborted=sorted(sched.aborted),
                quarantined=sorted(res["quarantined"]),
                disconnected=inj.disconnected,
                released=report.quarantined_pages_released)


BASIC = ("exhaust", "straggler", "disconnect", "malformed")
ALL = BASIC + ("nan", "alloc_failure")


@pytest.mark.parametrize("stochastic", [False, True])
def test_chaos_parity(engines, stochastic):
    """The reference's ``chaos_parity_greedy`` / ``_stochastic`` (n = 1):
    page exhaustion, stragglers, disconnects and malformed submits."""
    both(engines, _chaos, stochastic=stochastic, plan=PLANS["busy"],
         wl_seed=int(stochastic), kinds=BASIC)


ALL_KINDS = dict(seed=0, horizon=40, p_exhaust=0.12, exhaust_pages=8,
                 exhaust_ticks=3, p_straggler=0.15, straggler_ms=0.5,
                 p_disconnect=0.08, p_malformed=0.15, p_nan=0.1,
                 p_alloc_failure=0.1)


@pytest.mark.parametrize("stochastic", [False, True])
def test_run_chaos_every_kind_equals_reference(engines, stochastic):
    """Every kind but crash in one plan: the port's run_chaos equals the
    reference's counter for counter and token for token."""
    got = both(engines, _chaos, stochastic=stochastic, plan=ALL_KINDS,
               wl_seed=2 + int(stochastic), kinds=ALL)
    assert got["dispatch_faults"] > 0 and got["quarantined"]


def test_run_chaos_refuses_crash_recovery(engines):
    _, sides = engines
    ns, eng = sides["port"]
    with pytest.raises(NotImplementedError, match="journal"):
        faults.run_chaos(_chaos_sched(ns, eng), [], faults.FaultPlan(),
                         sched_factory=lambda: None)
