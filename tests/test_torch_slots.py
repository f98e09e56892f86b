"""The port's whole-prompt serving against the JAX reference's: the slotted
KV pool, the paged pool's prefill install, the scheduler's ``kv_layout=
"slots"`` stream and its paged ``prefill_chunk=0`` stream (greedy and
sampled, per-request tokens and dispatch counts equal to the reference
scheduler's), the reference's config defaults, and the launcher's
``--layout slots`` and ``--static``."""
import dataclasses

import jax
import numpy as np
import pytest

from port_util import jax_tasks, np32, port_lm, port_tables
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.kv_pool import PagedKVPool as JPagedPool
from repro.serve.kv_pool import SlotKVPool as JSlotPool
from repro.serve.sampling import SamplingParams as JSampling
from repro.serve.scheduler import ContinuousScheduler as JScheduler
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import SchedulerConfig as JSchedulerConfig
from repro_torch import bridge
from repro_torch.launch import serve as launcher
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.kv_pool import PagedKVPool, SlotKVPool
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import (ContinuousScheduler, InvalidConfig,
                                         Request, SchedulerConfig)

MAX_LEN = 48


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


def test_scheduler_config_defaults_match_reference():
    mine, ref = SchedulerConfig(), JSchedulerConfig()
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert (mine.kv_layout, mine.prefill_chunk, mine.bucket_min) == (
        "paged", 0, 16)


@pytest.mark.parametrize("knobs,match", [
    (dict(kv_layout="slots", prefill_chunk=8), "whole-prompt"),
    (dict(kv_layout="rings"), "kv_layout"),
    (dict(bucket_min=0), "bucket_min")])
def test_scheduler_refuses_bad_layouts(engines, knobs, match):
    _, _, eng = engines
    with pytest.raises(InvalidConfig, match=match):
        ContinuousScheduler(eng, SchedulerConfig(**knobs))


def _prefill_cache(jeng, cfg, length, task):
    rr = np.random.default_rng(length)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :length] = rr.integers(0, cfg.vocab_size, length)
    _, cache = jeng.prefill_request(toks, length, task)
    return cache


def test_slot_pool_matches_reference(engines):
    cfg, jeng, eng = engines
    mine = SlotKVPool(eng.model, 3, MAX_LEN)
    ref = JSlotPool(jeng.model, 3, MAX_LEN)
    cache = _prefill_cache(jeng, cfg, 11, 1)
    ops = [("alloc", 1), ("alloc", 2), ("write_prefill", 1, 11),
           ("advance", [1]), ("alloc", 0), ("alloc", 0), ("free", 0),
           ("advance", [1, 2]), ("free", 2), ("alloc", 1)]
    for op, *args in ops:
        if op == "write_prefill":
            mine.write_prefill(args[0], bridge.cache_from_jax(
                cfg, jax.device_get(cache), device="cpu"), args[1])
            ref.write_prefill(args[0], cache, args[1])
            continue
        assert getattr(mine, op)(*args) == getattr(ref, op)(*args), op
        assert (mine.cur_len.tolist(), mine.task_id.tolist(),
                list(mine._free), mine.leak_report()) == (
            ref.cur_len.tolist(), ref.task_id.tolist(), list(ref._free),
            ref.leak_report()), (op, args)
    want = bridge.cache_from_jax(cfg, jax.device_get(ref.cache), device="cpu")
    for name in ("k", "v"):
        np.testing.assert_array_equal(np32(mine.cache[name]),
                                      np32(want[name]))


def test_paged_write_prefill_matches_reference(engines):
    cfg, jeng, eng = engines
    mine = PagedKVPool(eng.model, 2, 24, block_size=4, num_blocks=12)
    ref = JPagedPool(jeng.model, 2, 24, block_size=4, num_blocks=12)
    for pool in (mine, ref):
        pool.alloc(0, 1)
        pool.alloc(2, 3)            # a prompt of 10 needs 3 pages
    cache = _prefill_cache(jeng, cfg, 10, 2)
    mine.write_prefill(1, bridge.cache_from_jax(
        cfg, jax.device_get(cache), device="cpu"), 10)
    ref.write_prefill(1, cache, 10)
    assert mine.cur_len.tolist() == ref.cur_len.tolist() == [0, 10]
    for name in ("k", "v"):
        np.testing.assert_array_equal(np32(mine.cache[name]),
                                      np32(ref.cache[0]["b0"][name]))


def _workload(cfg, cls, sampling_cls, stochastic):
    rr = np.random.default_rng(17)
    reqs = []
    for i in range(7):
        sp = None
        if stochastic:
            sp = sampling_cls(temperature=0.8, top_p=0.9,
                              top_k=5 if i % 2 else 0, seed=60 + i)
        reqs.append(cls(
            rid=i, prompt=rr.integers(0, cfg.vocab_size,
                                      int(rr.integers(3, 21))).astype(np.int32),
            task_id=int(rr.integers(0, 3)),
            max_new_tokens=int(rr.integers(2, 11)), sampling=sp))
    return reqs


LAYOUTS = {
    "slots": dict(kv_layout="slots", num_slots=3, bucket_min=8),
    # whole prompts into a paged pool tight enough to preempt
    "paged_whole": dict(kv_layout="paged", num_slots=3, bucket_min=8,
                        block_size=4, num_blocks=14, prefill_chunk=0),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["greedy", "sampled"])
def test_whole_prompt_streams_equal_reference(engines, layout, stochastic):
    cfg, jeng, eng = engines
    knobs = LAYOUTS[layout]
    jreqs = _workload(cfg, JRequest, JSampling, stochastic)
    jsched = JScheduler(jeng, JSchedulerConfig(**knobs))
    jd0 = jeng.dispatches
    for r in jreqs:
        jsched.submit(r)
    jsched.run()
    reqs = _workload(cfg, Request, SamplingParams, stochastic)
    sched = ContinuousScheduler(eng, SchedulerConfig(**knobs))
    d0 = eng.dispatches
    for r in reqs:
        sched.submit(r)
    sched.run()
    assert sched.drain_check() == []
    assert (sched.ticks, sched.preemptions, sched.steps_decoded) == (
        jsched.ticks, jsched.preemptions, jsched.steps_decoded)
    assert eng.dispatches - d0 == jeng.dispatches - jd0
    if layout == "paged_whole":
        assert sched.preemptions > 0, "workload never ran out of pages"
    for mine, ref in zip(reqs, jreqs):
        assert mine.out == ref.out, f"request {mine.rid} diverged"


def test_launcher_slots_and_static_on_cpu():
    base = ["--device", "cpu", "--reduced", "--demo", "--tasks", "2",
            "--requests", "5", "--rate", "0.7", "--slots", "2", "--prompt",
            "12", "--steps", "5", "--max-len", "32", "--quiet"]
    sched = launcher.main(base + ["--layout", "slots"])
    assert not sched.paged and sched.cfg.prefill_chunk == 0
    assert len(sched.finished) == 5 and sched.drain_check() == []
    whole = launcher.main(base + ["--prefill-chunk", "0"])
    assert whole.paged and len(whole.finished) == 5
    assert [r.out for _, r in sorted(whole.finished.items())] == \
        [r.out for _, r in sorted(sched.finished.items())]
    out = launcher.main(base + ["--static"])
    assert out.shape == (5, 5) and out.dtype == np.int32
