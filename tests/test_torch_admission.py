"""The port's n > 1 samples and admission policy against the JAX
reference's: fork and copy-on-write in the paged pool, forked samples
(chunked and whole-prompt), fork then preempt, a fork group aborted or
quarantined whole, strict-priority admission, a latency request
preempting best-effort rows, no starvation of an admitted best-effort
request, the bounded queue (``queue_full``, ``displaced``),
``admit_per_step``, and the launcher's arrivals and client loop.

Each scenario runs on both schedulers in this process (``tiny_lm``, f32,
the same requests from the same seeds): equal token streams, and equal
pool bookkeeping and scheduler state after every tick
(``port_util.sched_state``). On the CPU a forked sample's logits are
bitwise those of the same sample decoded without a fork."""
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_util import LogitsTap, jax_tasks, pool_state, port_lm, port_tables
from port_util import both_sides as both
from port_util import trace_ticks
from repro.serve import faults as jfaults
from repro.serve import scheduler as jsched
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.kv_pool import PagedKVPool as JPool
from repro.serve.sampling import SamplingParams as JSampling
from repro_torch import configs
from repro_torch.launch import serve as launcher
from repro_torch.serve import faults
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.kv_pool import PagedKVPool
from repro_torch.serve.sampling import SamplingParams

MAX_LEN = 48
REF = SimpleNamespace(name="reference", S=jsched, F=jfaults,
                      Sampling=JSampling, Pool=JPool)
PORT = SimpleNamespace(name="port", S=sched_mod, F=faults,
                       Sampling=SamplingParams, Pool=PagedKVPool)


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


def _sched(ns, eng, **kw):
    base = dict(num_slots=3, bucket_min=8, kv_layout="paged", block_size=8,
                prefill_chunk=8)
    base.update(kw)
    sched = ns.S.ContinuousScheduler(eng, ns.S.SchedulerConfig(**base))
    ns.made.append(trace_ticks(sched))
    return sched


def _req(ns, cfg, rng, rid, plen=None, max_new=None, **kw):
    plen = plen if plen is not None else int(rng.integers(3, 17))
    max_new = max_new if max_new is not None else int(rng.integers(2, 9))
    return ns.S.Request(
        rid=rid, prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
        task_id=int(rng.integers(0, 3)), max_new_tokens=max_new, **kw)


def _ref(eng, req):
    return eng.generate(req.prompt[None], req.max_new_tokens,
                        np.asarray([req.task_id], np.int32))[0].tolist()


def _clean(sched):
    assert sched.pool.leak_report() == []


def _outs(reqs):
    return {r.rid: list(map(int, r.out)) for r in reqs}


def _samples(req):
    return [list(map(int, s)) for s in req.samples]


# ---------------------------------------------------------------------------
# fork and copy-on-write in the pool
# ---------------------------------------------------------------------------

POOL_OPS = {
    # two forks of a half-full tail page, then each append copies it but
    # the last holder's, which writes in place; frees return shared pages
    # only at refcount zero
    "fork_cow": (dict(num_slots=4, max_len=32, block_size=8, num_blocks=12),
                 [("alloc", 1, 2), ("commit_prefill", 0, 12), ("fork", 0),
                  ("fork", 0), ("ensure_append_page", 0),
                  ("ensure_append_page", 1), ("ensure_append_page", 2),
                  ("free", 0), ("free", 1), ("free", 2)]),
    # no slot left to fork into; a fork of a free slot raises
    "fork_out_of_slots": (dict(num_slots=2, max_len=16, block_size=8,
                               num_blocks=6),
                          [("alloc", 0, 1), ("fork", 0), ("fork", 0),
                           ("fork", 7)]),
    # a shared tail with no free page cannot be copied (False); once the
    # sharer frees, the survivor appends in place
    "cow_backpressure": (dict(num_slots=3, max_len=16, block_size=8,
                              num_blocks=3),
                         [("alloc", 0, 2), ("commit_prefill", 0, 12),
                          ("fork", 0), ("ensure_append_page", 0),
                          ("free", 1), ("ensure_append_page", 0)]),
}


@pytest.mark.parametrize("case", sorted(POOL_OPS))
def test_pool_fork_and_cow_match_reference(engines, case):
    """Every return value and every piece of pool state equals the
    reference pool's after each op."""
    _, sides = engines
    kw, ops = POOL_OPS[case]
    pools = [ns.Pool(eng.model, **kw) for ns, eng in sides.values()]
    for op, *args in ops:
        got = []
        for pool in pools:
            try:
                got.append(getattr(pool, op)(*args))
            except ValueError as e:
                got.append(("ValueError", "not allocated" in str(e)))
        assert got[0] == got[1], (op, args)
        assert pool_state(pools[0]) == pool_state(pools[1]), (op, args)
    assert pools[1].leak_report() == []


# ---------------------------------------------------------------------------
# n > 1 samples
# ---------------------------------------------------------------------------

def _nreq(ns, prompt, n=4, temperature=0.8, rid=0, task=1, max_new=6):
    return ns.S.Request(rid=rid, prompt=prompt, task_id=task,
                        max_new_tokens=max_new,
                        sampling=ns.Sampling(temperature=temperature,
                                             top_p=0.9, seed=21, n=n))


def _fork_vs_independent(ns, eng, cfg, chunk, temperature):
    """n = 4 samples forked from one prefill equal the same samples
    decoded without a fork (one slot: each sample requeued and prefilled
    on its own)."""
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 10).astype(np.int32)
    forked = _nreq(ns, prompt, temperature=temperature)
    s1 = _sched(ns, eng, num_slots=6, prefill_chunk=chunk)
    s1.submit(forked)
    s1.run()
    assert s1.pool.forks == 3 and s1.pool.cow_copies > 0
    indep = _nreq(ns, prompt, temperature=temperature)
    s2 = _sched(ns, eng, num_slots=1, prefill_chunk=chunk)
    s2.submit(indep)
    s2.run()
    assert s2.pool.forks == 0
    assert _samples(forked) == _samples(indep)
    assert forked.out == forked.samples[0]
    if temperature > 0:
        assert len({tuple(s) for s in forked.samples}) > 1
    _clean(s1)
    _clean(s2)
    return _samples(forked), s1.pool.cow_copies


@pytest.mark.parametrize("chunk,temperature", [(8, 0.8), (0, 0.8), (8, 0.0)])
def test_fork_divergence_parity_vs_independent(engines, chunk, temperature):
    both(engines, _fork_vs_independent, chunk=chunk, temperature=temperature)


def _fork_shares_pages(ns, eng, cfg):
    """n = 4 costs the prompt's pages once plus one copied tail each."""
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, 38).astype(np.int32)

    def peak(n):
        sched = _sched(ns, eng, num_slots=6, block_size=4, prefill_chunk=0)
        sched.submit(ns.S.Request(rid=0, prompt=prompt, max_new_tokens=3,
                                  sampling=ns.Sampling(temperature=0.7,
                                                       seed=3, n=n)))
        most = 0
        while sched.busy():
            sched.step()
            most = max(most, sched.pool.blocks_in_use())
        _clean(sched)
        return most
    p1, p4 = peak(1), peak(4)
    assert p4 < 1.5 * p1
    return p1, p4


def test_fork_shares_prompt_pages(engines):
    both(engines, _fork_shares_pages)


def _fork_then_preempt(ns, eng, cfg):
    """An n = 3 parent forks, then page pressure preempts forked children
    mid-decode; they recompute on their own. Refcounts reconcile, and
    every sample equals a roomy pool's."""
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, 18).astype(np.int32)

    def serve(num_blocks):
        req = ns.S.Request(rid=0, prompt=prompt, task_id=1,
                           max_new_tokens=10,
                           sampling=ns.Sampling(temperature=0.9, top_p=0.9,
                                                seed=13, n=3))
        sched = _sched(ns, eng, num_slots=4, prefill_chunk=0,
                       num_blocks=num_blocks)
        sched.submit(req)
        sched.run()
        _clean(sched)
        return req, sched
    roomy, _ = serve(0)
    tight, sched = serve(7)
    assert sched.pool.forks > 0 and sched.preemptions > 0
    assert sched.pool.free_blocks() == 6
    assert _samples(tight) == _samples(roomy)
    return _samples(tight), sched.preemptions


def test_fork_then_preempt_lineage_no_leaks(engines):
    both(engines, _fork_then_preempt)


def _n_requires_paged(ns, eng, cfg):
    sched = ns.S.ContinuousScheduler(eng, ns.S.SchedulerConfig(
        num_slots=2, kv_layout="slots"))
    with pytest.raises(ns.S.InvalidRequest, match="paged"):
        sched.submit(_nreq(ns, np.asarray([1, 2, 3, 4], np.int32), n=2))
    return True


def test_n_gt_1_requires_paged_layout(engines):
    both(engines, _n_requires_paged)


def _group_teardown(ns, eng, cfg, how):
    """Aborting (or quarantining, through a NaN on one sample's row) a
    forked rid takes the whole sample group; the keeper is untouched and
    every page comes back."""
    rng = np.random.default_rng(3)
    sched = _sched(ns, eng, num_slots=4)
    keeper = _req(ns, cfg, rng, 0, plen=8, max_new=8)
    victim = _req(ns, cfg, rng, 1, plen=8, max_new=8,
                  sampling=ns.Sampling(temperature=0.8, top_k=20, seed=7,
                                       n=3))
    sched.submit(keeper)
    sched.submit(victim)
    for _ in range(4):
        sched.step()
    live = sorted(s for s, r in sched.running.items() if r.rid == 1)
    assert len(live) >= 2
    if how == "abort":
        assert sched.abort(1, reason="disconnect")
        root = sched.aborted[1]
    else:
        eng.inject_fault("nan", live[-1])
        sched.step()
        root = sched.quarantined[1]
    assert root is victim and not any(r.rid == 1
                                      for r in sched.running.values())
    sched.run()
    _clean(sched)
    assert sorted(sched.finished) == [0]
    assert list(keeper.out) == _ref(eng, keeper)
    return (_outs([keeper]), victim.state, victim.finish_reason,
            sched.pool.num_quarantined())


@pytest.mark.parametrize("how", ["abort", "quarantine"])
def test_fork_group_torn_down_whole(engines, how):
    both(engines, _group_teardown, how=how)


def _private_fork(pool):
    """Make ``pool.fork`` claim fresh pages and copy the source's into
    them: the samples then share nothing, on the same schedule."""
    def fork(slot):
        new = pool.alloc(int(pool.task_id[slot]), len(pool._pages[slot]))
        if new is not None:
            for a, b in zip(pool._pages[slot], pool._pages[new]):
                pool._copy_page(a, b)
            pool.cur_len[new] = pool.cur_len[slot]
        return new
    pool.fork = fork


def test_forked_sample_equals_unforked_bitwise_on_the_cpu(engines):
    """Each forked sample's logits at every step are bitwise those of the
    same schedule in which every sample holds a private copy of the
    prefill's pages: sharing pages (and copying a shared tail on its
    first append) changes no bit."""
    cfg, sides = engines
    eng = sides["port"][1]
    prompt = np.random.default_rng(4).integers(
        0, cfg.vocab_size, 13).astype(np.int32)
    rows, pools = [], []
    for shared in (True, False):
        sched = sched_mod.ContinuousScheduler(eng, sched_mod.SchedulerConfig(
            num_slots=6, bucket_min=8, block_size=8, prefill_chunk=8))
        if not shared:
            _private_fork(sched.pool)
        sched.submit(_nreq(PORT, prompt, max_new=5))
        with LogitsTap(sched) as tap:
            sched.run()
        assert sched.pool.leak_report() == []
        rows.append(tap.rows)
        pools.append((sched.pool.forks, sched.pool.cow_copies))
    assert pools == [(3, 3), (0, 0)] and len(rows[0]) == 1 + 4 * 4
    assert set(rows[0]) == set(rows[1])
    for k in rows[0]:
        assert torch.equal(rows[0][k], rows[1][k]), k


# ---------------------------------------------------------------------------
# priority classes and the bounded queue
# ---------------------------------------------------------------------------

def _priority_order(ns, eng, cfg):
    """Strict priority: submitted worst class first, admitted and finished
    best class first."""
    rng = np.random.default_rng(5)
    sched = _sched(ns, eng, num_slots=1, prefill_chunk=0)
    reqs = [_req(ns, cfg, rng, i, plen=8, max_new=4, priority=p)
            for i, p in enumerate(("best_effort", "standard", "latency"))]
    for r in reqs:
        sched.submit(r)
    fin = sched.run()
    _clean(sched)
    assert list(fin) == [2, 1, 0]
    for r in reqs:
        assert list(r.out) == _ref(eng, r)
    return list(fin), _outs(reqs)


def test_priority_admission_order(engines):
    both(engines, _priority_order)


def _latency_preempts(ns, eng, cfg):
    """A latency arrival short of pages takes them from the newest
    best-effort row; the oldest best-effort row keeps its pages, and the
    preempted one recomputes to the same stream."""
    rng = np.random.default_rng(6)
    sched = _sched(ns, eng, num_blocks=9)
    be = [_req(ns, cfg, rng, i, plen=16, max_new=10, priority="best_effort")
          for i in range(2)]
    for r in be:
        sched.submit(r)
    for _ in range(4):
        sched.step()
    oldest = min(sched.running, key=sched._admit_seq.__getitem__)
    lat = _req(ns, cfg, rng, 9, plen=16, max_new=4, priority="latency")
    sched.submit(lat)
    sched.step()
    assert sched.preemptions >= 1 and oldest in sched.running
    sched.run()
    _clean(sched)
    assert sorted(sched.finished) == [0, 1, 9]
    for r in be + [lat]:
        assert list(r.out) == _ref(eng, r)
    return _outs(be + [lat]), sched.preemptions


def test_latency_preempts_best_effort_for_pages(engines):
    both(engines, _latency_preempts)


def _no_starvation(ns, eng, cfg):
    """An admitted best-effort request finishes while a latency request
    arrives every tick and wants its pages."""
    rng = np.random.default_rng(7)
    sched = _sched(ns, eng, num_blocks=10)
    be = _req(ns, cfg, rng, 0, plen=16, max_new=12, priority="best_effort")
    lats = [_req(ns, cfg, rng, 1 + i, plen=8, max_new=4, priority="latency")
            for i in range(12)]
    fin = sched.run_stream([(0, be)] + [(1 + i, r)
                                        for i, r in enumerate(lats)])
    _clean(sched)
    assert 0 in fin and list(be.out) == _ref(eng, be)
    for r in lats:
        assert list(r.out) == _ref(eng, r)
    return _outs([be] + lats), sched.preemptions


def test_sustained_latency_cannot_starve_admitted_best_effort(engines):
    both(engines, _no_starvation)


def _queue_full(ns, eng, cfg):
    rng = np.random.default_rng(8)
    sched = _sched(ns, eng, num_slots=1, prefill_chunk=0, max_queue=2)
    reqs = [_req(ns, cfg, rng, i, plen=8, max_new=4) for i in range(4)]
    sched.submit(reqs[0])
    sched.step()
    sched.submit(reqs[1])
    sched.submit(reqs[2])
    with pytest.raises(ns.S.ShedError) as ei:
        sched.submit(reqs[3])
    assert (ei.value.reason, ei.value.rid) == ("queue_full", 3)
    assert reqs[3].state == "shed" and 3 in sched.shed
    fin = sched.run()
    _clean(sched)
    assert sorted(fin) == [0, 1, 2]
    return _outs(reqs)


def test_queue_full_sheds_with_reason(engines):
    both(engines, _queue_full)


def _displaced(ns, eng, cfg):
    """A latency submission into a full queue displaces the newest
    best-effort waiter instead of being refused."""
    rng = np.random.default_rng(9)
    sched = _sched(ns, eng, num_slots=1, prefill_chunk=0, max_queue=2)
    r0 = _req(ns, cfg, rng, 0, plen=8, max_new=4)
    sched.submit(r0)
    sched.step()
    be = [_req(ns, cfg, rng, 1 + i, plen=8, max_new=4, priority="best_effort")
          for i in range(2)]
    for r in be:
        sched.submit(r)
    lat = _req(ns, cfg, rng, 3, plen=8, max_new=4, priority="latency")
    sched.submit(lat)
    assert sched.shed[2].finish_reason == "displaced" and len(sched.queue) == 2
    fin = sched.run()
    _clean(sched)
    assert sorted(fin) == [0, 1, 3]
    return _outs([r0] + be + [lat])


def test_higher_class_displaces_queued_best_effort(engines):
    both(engines, _displaced)


def _admit_per_step(ns, eng, cfg):
    """Whole-prompt admission takes at most ``admit_per_step`` prompts a
    tick."""
    rng = np.random.default_rng(10)
    sched = _sched(ns, eng, num_slots=4, prefill_chunk=0, admit_per_step=1)
    reqs = [_req(ns, cfg, rng, i, plen=6, max_new=5) for i in range(4)]
    for r in reqs:
        sched.submit(r)
    sched.step()
    assert len(sched.running) == 1
    sched.run()
    _clean(sched)
    for r in reqs:
        assert list(r.out) == _ref(eng, r)
    return _outs(reqs), sched.ticks


def test_admit_per_step_limits_admissions(engines):
    both(engines, _admit_per_step)


@pytest.mark.parametrize("knob", ["admit_per_step", "prefix_cache_pages",
                                  "max_queue"])
def test_new_knobs_refuse_negative_counts(engines, knob):
    _, sides = engines
    for ns, eng in sides.values():
        with pytest.raises(ns.S.InvalidConfig, match=knob):
            ns.S.ContinuousScheduler(eng, ns.S.SchedulerConfig(**{knob: -1}))


def test_prefix_cache_needs_chunked_paged_layout(engines):
    _, sides = engines
    eng = sides["port"][1]
    for kw in (dict(prefill_chunk=0), dict(kv_layout="slots")):
        with pytest.raises(sched_mod.InvalidConfig, match="prefix cache"):
            sched_mod.ContinuousScheduler(eng, sched_mod.SchedulerConfig(
                prefix_cache_pages=4, **kw))


def test_unknown_priority_is_refused(engines):
    _, sides = engines
    for ns, eng in sides.values():
        sched = ns.S.ContinuousScheduler(eng, ns.S.SchedulerConfig())
        with pytest.raises(ns.S.InvalidRequest, match="priority"):
            sched.submit(ns.S.Request(rid=0, prompt=np.asarray([1, 2]),
                                      priority="extreme"))


# ---------------------------------------------------------------------------
# the launcher: arrivals draw for draw, the client loop
# ---------------------------------------------------------------------------

FLAGS = [["--system-prompt", "9", "--priority-mix",
          "latency=0.25,standard=0.5,best_effort=0.25", "--samples", "3"],
         ["--temperature", "0.7", "--top-p", "0.8", "--seed", "5"],
         []]


class _Captured(Exception):
    pass


def _reference_arrivals(monkeypatch, flags):
    """The reference launcher's requests for ``flags``: its ``main`` runs
    until it hands them to ``run_with_retries``."""
    from repro.launch import serve as jlaunch

    def capture(sched, arrivals, **kw):
        raise _Captured(arrivals, sched.cfg)
    monkeypatch.setattr(jlaunch, "run_with_retries", capture)
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    with pytest.raises(_Captured) as ei:
        jlaunch.main()
    return ei.value.args


@pytest.mark.parametrize("k", range(len(FLAGS)))
def test_make_arrivals_draws_the_reference_requests(monkeypatch, k):
    base = ["--reduced", "--demo", "--tasks", "3", "--requests", "9",
            "--rate", "1.5", "--prompt", "12", "--steps", "6",
            "--max-len", "64", "--max-queue", "3", "--quiet"]
    flags = base + FLAGS[k]
    ref, ref_cfg = _reference_arrivals(monkeypatch, flags)
    args = launcher.parser().parse_args(flags + ["--device", "cpu"])
    vocab = configs.reduced(configs.get("smollm-360m"), repeats=2).vocab_size
    mine = launcher.make_arrivals(args, vocab, 3)
    assert len(mine) == len(ref)
    for (t, a), (u, b) in zip(mine, ref):
        assert (t, a.rid, a.task_id, a.max_new_tokens, a.priority) == \
            (u, b.rid, b.task_id, b.max_new_tokens, b.priority)
        assert np.array_equal(a.prompt, b.prompt)
        assert (a.sampling is None) == (b.sampling is None)
        if a.sampling is not None:
            assert a.sampling.__dict__ == b.sampling.__dict__
    assert (args.slots, args.prefill_chunk, args.prefix_cache_pages,
            args.max_queue) == (ref_cfg.num_slots, ref_cfg.prefill_chunk,
                                ref_cfg.prefix_cache_pages,
                                ref_cfg.max_queue)


def _client_loop(ns, eng, cfg):
    """The client loop against the bounded queue: sheds, retries with
    backoff, displacements, and the streams of what was served."""
    rng = np.random.default_rng(11)
    classes = ("latency", "standard", "best_effort")
    arrivals = [(int(i // 3), _req(ns, cfg, rng, i, plen=int(rng.integers(
        4, 14)), max_new=4, priority=classes[int(rng.integers(0, 3))]))
        for i in range(12)]
    sched = _sched(ns, eng, num_slots=2, num_blocks=7, max_queue=2)
    if ns is PORT:
        gave_up, retries, _, _ = launcher.run_with_retries(
            sched, arrivals, max_retries=2, backoff=2)
    else:
        from repro.launch import serve as jlaunch
        gave_up, retries, _, _ = jlaunch.run_with_retries(
            sched, arrivals, grace_ticks=-1, max_retries=2, backoff=2)
    _clean(sched)
    assert retries > 0 and not sched.busy()
    assert set(sched.finished) | set(gave_up) == set(range(12))
    return (sorted(gave_up), retries, _outs(sched.finished.values()),
            sorted((r, q.finish_reason) for r, q in sched.shed.items()))


def test_run_with_retries_matches_reference(engines):
    both(engines, _client_loop)
