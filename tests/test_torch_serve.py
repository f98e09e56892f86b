"""The port's serving stack against the JAX reference's: the paged KV pool's
bookkeeping, the continuous scheduler's token streams (greedy and
stochastic, on a workload that splits the multi-prefill budget and forces
preempt-and-recompute), one dispatch per tick, and the launcher."""
import numpy as np
import pytest

from port_util import jax_tasks, port_lm, port_tables
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.kv_pool import PagedKVPool as JPool
from repro.serve.sampling import SamplingParams as JSampling
from repro.serve.scheduler import ContinuousScheduler as JScheduler
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import SchedulerConfig as JSchedulerConfig
from repro_torch.launch import serve as launcher
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.kv_pool import PagedKVPool
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import (ContinuousScheduler, Request,
                                         SchedulerConfig)

MAX_LEN = 48
SCHED = dict(num_slots=3, block_size=4, num_blocks=14, prefill_chunk=8,
             max_prefills=3)


@pytest.fixture(scope="module")
def engines(tiny_lm):
    cfg, jmodel, jparams = tiny_lm
    tasks = jax_tasks(cfg, jparams, 3)
    jeng = JServeEngine(jmodel, jparams, JServeConfig(max_len=MAX_LEN),
                        fused_tasks=tasks)
    model, params = port_lm(tiny_lm)
    eng = ServeEngine(model, params, ServeConfig(max_len=MAX_LEN),
                      fused_tasks=port_tables(tasks))
    return cfg, jeng, eng


def _pool_state(pool):
    return (pool.block_tables.tolist(), pool._refs.tolist(),
            list(pool._free_blocks), list(pool._free_slots),
            pool.cur_len.tolist(), pool.task_id.tolist(),
            pool.blocks_in_use(), pool.leak_report())


def test_pool_bookkeeping_matches_reference(engines):
    _, jeng, eng = engines
    mine = PagedKVPool(eng.model, 3, 24, block_size=4, num_blocks=12)
    ref = JPool(jeng.model, 3, 24, block_size=4, num_blocks=12)
    ops = [("alloc", 1, 2), ("alloc", 2, 3), ("commit_prefill", 0, 7),
           ("ensure_append_page", 0), ("advance", [0]),
           ("ensure_append_page", 0), ("commit_prefill", 1, 12),
           ("ensure_append_page", 1), ("alloc", 0, 6),   # short: None
           ("free", 1), ("alloc", 0, 4), ("advance", [0]),
           ("ensure_append_page", 0), ("free", 0), ("free", 1)]
    for op, *args in ops:
        got = getattr(mine, op)(*args)
        want = getattr(ref, op)(*args)
        assert got == want, (op, args)
        assert _pool_state(mine) == _pool_state(ref), (op, args)
    assert mine.leak_report() == [] and mine.blocks_in_use() == 0
    assert mine.peak_pages == ref.peak_pages


def _workload(cfg, cls, sampling_cls, stochastic):
    rr = np.random.default_rng(7)
    reqs = []
    for i in range(7):
        sp = None
        if stochastic:
            sp = sampling_cls(temperature=0.8, top_p=0.9,
                              top_k=5 if i % 2 else 0, seed=40 + i)
        reqs.append(cls(
            rid=i, prompt=rr.integers(0, cfg.vocab_size,
                                      int(rr.integers(3, 21))).astype(np.int32),
            task_id=int(rr.integers(0, 3)),
            max_new_tokens=int(rr.integers(2, 11)), sampling=sp))
    return reqs


@pytest.mark.parametrize("stochastic", [False, True])
def test_token_streams_equal_reference(engines, stochastic):
    cfg, jeng, eng = engines
    jreqs = _workload(cfg, JRequest, JSampling, stochastic)
    jsched = JScheduler(jeng, JSchedulerConfig(kv_layout="paged",
                                               bucket_min=8, **SCHED))
    for r in jreqs:
        jsched.submit(r)
    jsched.run()
    reqs = _workload(cfg, Request, SamplingParams, stochastic)
    sched = ContinuousScheduler(eng, SchedulerConfig(**SCHED))
    d0 = eng.dispatches
    for r in reqs:
        sched.submit(r)
    sched.run()
    assert sched.drain_check() == []
    assert sched.preemptions > 0, "workload never ran out of pages"
    assert sched.peak_prefills >= 2, "prefills never shared the budget"
    assert eng.dispatches - d0 == sched.ticks, "one dispatch per tick"
    assert (sched.ticks, sched.preemptions, sched.prefill_chunks_run) == (
        jsched.ticks, jsched.preemptions, jsched.prefill_chunks_run)
    for mine, ref in zip(reqs, jreqs):
        assert mine.out == ref.out, f"request {mine.rid} diverged"
    # preempt-and-recompute is exact: ample pages give the same streams
    roomy = _workload(cfg, Request, SamplingParams, stochastic)
    sched = ContinuousScheduler(eng, SchedulerConfig(
        **dict(SCHED, num_blocks=0)))
    for r in roomy:
        sched.submit(r)
    sched.run()
    assert sched.preemptions == 0
    assert [r.out for r in roomy] == [r.out for r in reqs]


def test_launcher_demo_on_cpu():
    sched = launcher.main(["--device", "cpu", "--reduced", "--demo",
                           "--tasks", "2", "--requests", "5", "--rate", "0.7",
                           "--slots", "2", "--prompt", "12", "--steps", "5",
                           "--max-len", "32", "--prefill-chunk", "8",
                           "--quiet"])
    assert len(sched.finished) == 5
    assert sched.engine.dispatches == sched.ticks
    assert all(2 <= len(r.out) <= 5 for r in sched.finished.values())
