"""The port's page sharing against the JAX reference's: the prefix cache
(hits greedy and stochastic, the full-prompt hit that recomputes its last
token, another task's miss, hit then preempt, abort releasing pins, LRU
that never evicts a pinned entry, the warm leak report, shutdown's
flush, an allocator sweep against a refcount oracle, seizure racing
retention), compaction, copy-on-write on the device, and the
write-exclusive check.

Each scenario runs on both schedulers in this process (``tiny_lm``, f32,
the same requests from the same seeds). Their token streams must be equal,
and so must the pool's and the cache's bookkeeping after every tick
(``port_util.sched_state``). The port's own invariants hold bitwise on
the CPU: a warm request's logits and K/V equal the same request served
cold."""
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
from repro_torch.models.model import check_write_exclusive
from repro_torch.serve import faults
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.kv_pool import PagedKVPool, chain_keys
from repro_torch.serve.sampling import SamplingParams

MAX_LEN = 48
BS = 8          # a short system prompt spans several full pages
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
    base = dict(num_slots=4, bucket_min=8, kv_layout="paged", block_size=BS,
                prefill_chunk=16, prefix_cache_pages=16)
    base.update(kw)
    sched = ns.S.ContinuousScheduler(eng, ns.S.SchedulerConfig(**base))
    ns.made.append(trace_ticks(sched))
    return sched


def _preq(ns, rid, prompt, task=0, max_new=6, sampling=None):
    return ns.S.Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                        task_id=task, max_new_tokens=max_new,
                        sampling=sampling)


def _tokens(rng, n):
    return rng.integers(0, 128, n).astype(np.int32)


def _ref(eng, req):
    """The cold greedy stream: the engine's own static batch of one."""
    return eng.generate(req.prompt[None], req.max_new_tokens,
                        np.asarray([req.task_id], np.int32))[0].tolist()


def _clean(sched):
    assert sched.pool.leak_report() == []


def _outs(reqs):
    return {r.rid: list(map(int, r.out)) for r in reqs}


def _cache(sched):
    c = sched.pool.prefix_cache
    return (c.hits, c.misses, c.hit_tokens, c.retained_pages,
            c.evicted_pages, len(c))


# ---------------------------------------------------------------------------
# hits: warm streams equal cold ones
# ---------------------------------------------------------------------------

def _hit_greedy(ns, eng, cfg):
    """Three requests share a 3-page system prefix: the first misses and
    retains, the next two hit; each equals the cold stream."""
    rng = np.random.default_rng(0)
    sched = _sched(ns, eng)
    sys_p = _tokens(rng, 3 * BS)
    reqs = [_preq(ns, i, np.concatenate([sys_p, _tokens(rng, 3 + 2 * i)]),
                  task=1) for i in range(3)]
    for r in reqs:
        sched.submit(r)
        sched.run()
        assert list(r.out) == _ref(eng, r)
    c = sched.pool.prefix_cache
    assert (c.misses, c.hits, c.hit_tokens) == (1, 2, 2 * 3 * BS)
    _clean(sched)
    return _outs(reqs), _cache(sched)


def test_cache_hit_greedy(engines):
    both(engines, _hit_greedy)


def _full_prompt_hit(ns, eng, cfg):
    """A duplicate prompt of exactly 4 full pages maps only 3: its last
    token is recomputed, since its logits seed the first decode step."""
    rng = np.random.default_rng(1)
    sched = _sched(ns, eng)
    prompt = _tokens(rng, 4 * BS)
    r1, r2 = _preq(ns, 0, prompt, task=2), _preq(ns, 1, prompt, task=2)
    for r in (r1, r2):
        sched.submit(r)
        sched.run()
    c = sched.pool.prefix_cache
    assert len(c) == 4 and c.hit_tokens == 3 * BS
    assert list(r2.out) == list(r1.out) == _ref(eng, r2)
    _clean(sched)
    return _outs([r1, r2]), _cache(sched)


def test_full_prompt_hit_recomputes_last_token(engines):
    both(engines, _full_prompt_hit)


def _hit_stochastic(ns, eng, cfg):
    """Sampled requests hitting the cache draw what a cold scheduler
    draws (counter-based streams, equal K/V)."""
    rng = np.random.default_rng(2)
    sys_p = _tokens(rng, 3 * BS)
    tails = [_tokens(rng, 3 + i) for i in range(4)]

    def reqs():
        return [_preq(ns, i, np.concatenate([sys_p, tails[i]]), max_new=8,
                      sampling=ns.Sampling(temperature=0.8, top_k=20,
                                           top_p=0.9, seed=100 + i))
                for i in range(4)]
    cold = _sched(ns, eng, prefix_cache_pages=0, prefill_chunk=16)
    cold_reqs = reqs()
    for r in cold_reqs:
        cold.submit(r)
    cold.run()
    warm = _sched(ns, eng)
    warm_reqs = reqs()
    for r in warm_reqs:         # one after another: each hits the last
        warm.submit(r)
        warm.run()
    assert warm.pool.prefix_cache.hits >= 3
    assert _outs(warm_reqs) == _outs(cold_reqs)
    _clean(cold)
    _clean(warm)
    return _outs(warm_reqs), _cache(warm)


def test_cache_hit_stochastic(engines):
    both(engines, _hit_stochastic)


def _other_task(ns, eng, cfg):
    """The key chains from the task id: the same tokens under another task
    miss, under the same task hit."""
    rng = np.random.default_rng(3)
    sched = _sched(ns, eng)
    prompt = np.concatenate([_tokens(rng, 3 * BS), _tokens(rng, 5)])
    reqs = [_preq(ns, 0, prompt, task=0), _preq(ns, 1, prompt, task=1),
            _preq(ns, 2, prompt, task=0)]
    for r in reqs:
        sched.submit(r)
        sched.run()
        assert list(r.out) == _ref(eng, r)
    c = sched.pool.prefix_cache
    assert (c.misses, c.hits) == (2, 1)
    _clean(sched)
    return _outs(reqs), _cache(sched)


def test_same_tokens_other_task_misses(engines):
    both(engines, _other_task)


# ---------------------------------------------------------------------------
# pins across preempt, abort and shutdown
# ---------------------------------------------------------------------------

def _hit_preempt(ns, eng, cfg):
    """hit -> preempt -> recompute: seizing every free page preempts the
    hitting request mid-decode; its pins go with the slot, the recompute
    hits again, and its stream is the cold one."""
    rng = np.random.default_rng(4)
    sched = _sched(ns, eng, num_slots=3, num_blocks=20, prefill_chunk=8)
    cache = sched.pool.prefix_cache
    sys_p = _tokens(rng, 3 * BS)
    warmer = _preq(ns, 0, np.concatenate([sys_p, _tokens(rng, 4)]),
                   max_new=4)
    sched.submit(warmer)
    sched.run()
    assert len(cache) == 3
    victim = _preq(ns, 1, np.concatenate([sys_p, _tokens(rng, 6)]),
                   max_new=12)
    sched.submit(victim)
    for _ in range(4):
        sched.step()
    assert victim.state == "running" and cache.pinned_entries() == 3
    pages = sched.pool.seize_pages(sched.pool.free_blocks())
    for _ in range(8):
        sched.step()
    assert sched.preemptions >= 1 and cache.pinned_entries() == 0
    sched.pool.restore_pages(pages)
    sched.run()
    _clean(sched)
    assert cache.hits >= 2
    assert list(victim.out) == _ref(eng, victim)
    return _outs([warmer, victim]), _cache(sched), sched.preemptions


def test_hit_then_preempt(engines):
    both(engines, _hit_preempt)


def _hit_abort(ns, eng, cfg):
    """hit -> abort mid-decode: the pins go, the entries stay warm, and
    the next request of the prefix still hits."""
    rng = np.random.default_rng(5)
    sched = _sched(ns, eng)
    cache = sched.pool.prefix_cache
    sys_p = _tokens(rng, 3 * BS)
    first = _preq(ns, 0, np.concatenate([sys_p, _tokens(rng, 4)]))
    sched.submit(first)
    sched.run()
    n = len(cache)
    doomed = _preq(ns, 1, np.concatenate([sys_p, _tokens(rng, 5)]),
                   max_new=10)
    sched.submit(doomed)
    for _ in range(3):
        sched.step()
    assert doomed.state == "running" and cache.pinned_entries() > 0
    assert sched.abort(1, reason="disconnect")
    assert cache.pinned_entries() == 0 and len(cache) == n
    _clean(sched)
    again = _preq(ns, 2, np.concatenate([sys_p, _tokens(rng, 7)]))
    sched.submit(again)
    sched.run()
    assert cache.hits >= 2 and list(again.out) == _ref(eng, again)
    _clean(sched)
    return _outs([first, doomed, again]), _cache(sched)


def test_hit_abort_releases_pins(engines):
    both(engines, _hit_abort)


def _lru_pinned(ns, eng, cfg):
    """Capacity and reclaim pressure evict cold unpinned leaves, never a
    pinned entry or a chain's interior (host surgery on the pool)."""
    rng = np.random.default_rng(6)
    sched = _sched(ns, eng, prefix_cache_pages=4)
    pool, cache = sched.pool, sched.pool.prefix_cache
    pA, pB, pC = (_tokens(rng, 17) for _ in range(3))   # 2 full pages each
    steps = []
    for prompt in (pA, pB):
        slot = pool.alloc(0, 3)
        cache.retain(0, prompt, slot)
        pool.free(slot)
    steps.append(pool_state(pool))
    keys_a = cache.match(0, pA)
    slot_a = pool.alloc_cached(0, keys_a, 3)            # pins A
    assert slot_a is not None and cache.pinned_entries() == 2
    slot_c = pool.alloc(0, 3)
    cache.retain(0, pC, slot_c)     # over capacity: evicts B, never A
    pool.free(slot_c)
    steps.append(pool_state(pool))
    assert cache.evicted_pages == 2 and cache.match(0, pB) == []
    assert all(k in cache._entries for k in keys_a)
    assert cache.evictable_free() == 2
    assert not pool._reclaim(pool.free_blocks() + 3)
    assert len(cache) == 2 and cache.pinned_entries() == 2
    steps.append(pool_state(pool))
    pool.free(slot_a)
    assert cache.pinned_entries() == 0
    assert pool.flush_prefix_cache() == 2 and len(cache) == 0
    steps.append(pool_state(pool))
    assert pool.leak_report() == []
    return steps


def test_lru_never_evicts_pinned(engines):
    both(engines, _lru_pinned)


def _warm_leak_report(ns, eng, cfg):
    """Cache-retained pages are their own category: a warm cache at drain
    is clean, a lost page or a drifting refcount is still a finding."""
    rng = np.random.default_rng(7)
    sched = _sched(ns, eng)
    pool, cache = sched.pool, sched.pool.prefix_cache
    sched.submit(_preq(ns, 0, _tokens(rng, 3 * BS + 4)))
    sched.run()
    assert len(cache) == 3 and pool.leak_report() == []
    page = pool._free_blocks.pop()
    lost = pool.leak_report()
    pool._free_blocks.append(page)
    ent = next(iter(cache._entries.values()))
    pool._refs[ent.page] += 1
    drift = pool.leak_report()
    pool._refs[ent.page] -= 1
    assert any("leaked pages" in f for f in lost)
    assert any("refcounts out of sync" in f for f in drift)
    _clean(sched)
    return lost, drift


def test_leak_report_warm_cache_is_clean(engines):
    both(engines, _warm_leak_report)


def _shutdown_flush(ns, eng, cfg, grace):
    """shutdown with a warm cache (and, with no grace, a hitting request
    in flight): every cached page released, clean."""
    rng = np.random.default_rng(8)
    sched = _sched(ns, eng)
    cache = sched.pool.prefix_cache
    sys_p = _tokens(rng, 3 * BS)
    sched.submit(_preq(ns, 0, np.concatenate([sys_p, _tokens(rng, 4)])))
    sched.run()
    sched.submit(_preq(ns, 1, np.concatenate([sys_p, _tokens(rng, 6)]),
                       max_new=12))
    for _ in range(3):
        sched.step()
    assert cache.pinned_entries() > 0
    rep = sched.shutdown(grace_ticks=grace)
    assert rep.clean, rep.leak_findings
    assert rep.cache_pages_released == 3 and len(cache) == 0
    assert rep.shed_rids == ([1] if grace == 0 else [])
    assert sched.pool.blocks_in_use() == 0
    return (rep.finished, rep.shed_rids, rep.grace_ticks_used,
            rep.cache_pages_released, rep.clean)


@pytest.mark.parametrize("grace", [0, 100])
def test_shutdown_flushes_warm_cache(engines, grace):
    both(engines, _shutdown_flush, grace=grace)


# ---------------------------------------------------------------------------
# the allocator against a refcount oracle, and seizure racing retention
# ---------------------------------------------------------------------------

def _allocator_sweep(ns, eng, cfg, seed, n_ops):
    """A seeded sequence of alloc / alloc_cached / fork / append (with
    COW) / retain / free / seize / restore / flush on a bare pool, a plain
    dict oracle of every page's refcount held after every op; the state
    after each op is returned for the other side's."""
    rng = np.random.default_rng(seed)
    pool = ns.Pool(eng.model, num_slots=6, max_len=MAX_LEN, block_size=BS,
                   num_blocks=32)
    cache = pool.enable_prefix_cache(10)
    sys_p = {t: _tokens(rng, 2 * BS) for t in range(3)}
    live, refs, seized, states = {}, {}, [], []

    def snap():
        return {k: e.page for k, e in cache._entries.items()}

    def fold(pre):
        post = snap()
        for k, p in pre.items():
            if k not in post:
                refs[p] -= 1
        for k, p in post.items():
            if k not in pre:
                refs[p] = refs.get(p, 0) + 1

    def check(op):
        got = {p: int(pool._refs[p]) for p in range(pool.num_blocks)
               if pool._refs[p]}
        want = {p: c for p, c in refs.items() if c}
        assert got == want, op
        assert pool.free_blocks() == \
            pool.num_blocks - 1 - len(want) - len(seized), op
        assert [f for f in pool.leak_report()
                if "still seized" not in f] == [], op
        states.append(pool_state(pool))

    def admit():
        t = int(rng.integers(0, 3))
        if rng.random() < 0.75:
            prompt = np.concatenate([sys_p[t],
                                     _tokens(rng, int(rng.integers(1, 16)))])
        else:
            prompt = _tokens(rng, int(rng.integers(3, 41)))
        npages = pool.pages_needed(len(prompt))
        keys = cache.match(t, prompt)
        if keys:
            shared = cache.pages(keys)
            slot = pool.alloc_cached(t, keys, npages)
        else:
            shared, slot = [], pool.alloc(t, npages)
        if slot is None:
            return
        for p in shared:
            refs[p] += 1
        for p in pool._pages[slot][len(shared):]:
            refs[p] = refs.get(p, 0) + 1
        pool.commit_prefill(slot, len(prompt))
        live[slot] = (t, prompt)

    def append():
        slot = int(rng.choice(list(live)))
        if pool.cur_len[slot] >= pool.max_len:
            return
        before = list(pool._pages[slot])
        if not pool.ensure_append_page(slot):
            return
        after = pool._pages[slot]
        if len(after) > len(before):
            refs[after[-1]] = refs.get(after[-1], 0) + 1
        for a, b in zip(before, after):
            if a != b:                      # copied on write
                refs[a] -= 1
                refs[b] = refs.get(b, 0) + 1
        pool.advance([slot])

    def fork():
        src = int(rng.choice(list(live)))
        new = pool.fork(src)
        if new is not None:
            for p in pool._pages[new]:
                refs[p] += 1
            live[new] = live[src]

    def release(retain):
        slot = int(rng.choice(list(live)))
        t, prompt = live.pop(slot)
        if retain:
            cache.retain(t, prompt, slot)
        pages = list(pool._pages[slot])
        pool.free(slot)
        for p in pages:
            refs[p] -= 1

    for i in range(n_ops):
        pre = snap()
        u = rng.random()
        if u < 0.32:
            admit()
        elif u < 0.55 and live:
            append()
        elif u < 0.72 and live:
            release(retain=True)
        elif u < 0.80 and live:
            release(retain=False)
        elif u < 0.85 and live:
            fork()
        elif u < 0.90:
            seized.extend(pool.seize_pages(int(rng.integers(1, 5))))
        elif u < 0.95 and seized:
            pool.restore_pages(seized)
            seized = []
        else:
            pool.flush_prefix_cache()
        fold(pre)
        check(f"op {i}")
    while live:
        pre = snap()
        release(retain=rng.random() < 0.5)
        fold(pre)
        check("teardown")
    if seized:
        pool.restore_pages(seized)
        seized = []
    pre = snap()
    pool.flush_prefix_cache()
    fold(pre)
    check("final flush")
    assert not any(refs.values()) and pool.blocks_in_use() == 0
    return states


def test_allocator_oracle_quick(engines):
    both(engines, _allocator_sweep, seed=0, n_ops=120)


def _prefix_workload(ns, cfg, seed, n):
    rng = np.random.default_rng(seed)
    sys_p = {t: rng.integers(0, cfg.vocab_size, 2 * BS).astype(np.int32)
             for t in range(3)}
    arrivals = []
    for i in range(n):
        t = int(rng.integers(0, 3))
        tail = rng.integers(0, cfg.vocab_size,
                            int(rng.integers(1, 9))).astype(np.int32)
        arrivals.append((int(rng.integers(0, n)), ns.S.Request(
            rid=i, prompt=np.concatenate([sys_p[t], tail]), task_id=t,
            max_new_tokens=int(rng.integers(3, 9)))))
    return arrivals


def _seizure_races_retention(ns, eng, cfg):
    """A FaultPlan seizes pages while the cache retains and evicts: the
    cached run drains leak-free, and every survivor's stream equals a
    fault-free run without the cache."""
    kw = dict(num_slots=3, prefill_chunk=8, num_blocks=14)
    base = _sched(ns, eng, prefix_cache_pages=0, **kw)
    baseline = base.run_stream(_prefix_workload(ns, cfg, 21, 14))
    sched = _sched(ns, eng, prefix_cache_pages=8, **kw)
    plan = ns.F.FaultPlan(seed=11, horizon=48, p_exhaust=0.18,
                          exhaust_pages=8, exhaust_ticks=3, p_straggler=0.1,
                          straggler_ms=0.0, p_disconnect=0.08,
                          p_malformed=0.1)
    res = ns.F.run_chaos(sched, _prefix_workload(ns, cfg, 21, 14), plan)
    inj = res["injector"]
    assert not res["leak_findings"] and not sched.busy()
    assert inj.applied["exhaust"] > 0 and sched.pool.prefix_cache.hits > 0
    survivors = set(res["finished"])
    assert survivors == set(baseline) - set(inj.disconnected)
    for rid in survivors:
        assert list(res["finished"][rid].out) == list(baseline[rid].out)
    return (_outs(res["finished"].values()), dict(inj.applied),
            inj.disconnected, _cache(sched))


def test_chaos_seizure_races_retention(engines):
    both(engines, _seizure_races_retention)


# ---------------------------------------------------------------------------
# compaction (the reference's test_recovery.py compaction cases)
# ---------------------------------------------------------------------------

def _compact_dedupes(ns, eng, cfg):
    """Two running rows with the same prompt share its full pages after
    compact(); decode goes on through the copy-on-write path and both
    streams stay the cold one."""
    rng = np.random.default_rng(9)
    sched = _sched(ns, eng, num_slots=3, prefix_cache_pages=0,
                   prefill_chunk=8)
    prompt = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    reqs = [ns.S.Request(rid=i, prompt=prompt.copy(), task_id=1,
                         max_new_tokens=10) for i in range(2)]
    for r in reqs:
        sched.submit(r)
    while len(sched.running) < 2:
        sched.step()
    sched.step()                    # decode commits past the prompt
    freed = sched.pool.compact(
        {slot: r.prompt for slot, r in sched.running.items()})
    assert freed >= 1 and sched.pool.pages_deduped >= 1
    state = pool_state(sched.pool)
    sched.run()
    for r in reqs:
        assert list(r.out) == _ref(eng, reqs[0])
    _clean(sched)
    return freed, state, _outs(reqs)


def test_compact_dedupes_identical_prompts(engines):
    both(engines, _compact_dedupes)


def _compact_rescue(ns, eng, cfg):
    """A starved chunked admission compacts first: duplicate prompt pages
    come back, the late request admits, nobody is preempted."""
    rng = np.random.default_rng(10)
    sched = _sched(ns, eng, num_slots=3, num_blocks=9, prefix_cache_pages=0,
                   prefill_chunk=8)
    prompt = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    dups = [ns.S.Request(rid=i, prompt=prompt.copy(), task_id=0,
                         max_new_tokens=8) for i in range(2)]
    for r in dups:
        sched.submit(r)
    while len(sched.running) < 2:
        sched.step()
    late = ns.S.Request(rid=9, prompt=rng.integers(
        0, cfg.vocab_size, 10).astype(np.int32), task_id=2, max_new_tokens=4)
    sched.submit(late)
    sched.run()
    assert sched.pool.compactions >= 1 and sched.preemptions == 0
    assert list(late.out) == _ref(eng, late)
    for r in dups:
        assert list(r.out) == _ref(eng, dups[0])
    _clean(sched)
    return (_outs(dups + [late]), sched.pool.compactions,
            sched.pool.pages_deduped)


def test_compact_rescues_admission_before_preempt(engines):
    both(engines, _compact_rescue)


# ---------------------------------------------------------------------------
# the port's own: COW on the device, write-exclusive, warm = cold bitwise
# ---------------------------------------------------------------------------

def test_chain_keys_are_the_reference_keys(engines):
    from repro.serve.kv_pool import chain_keys as jchain
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 50000, 37).astype(np.int32)
    for task in (0, 3):
        assert chain_keys(task, toks, BS, 4) == jchain(task, toks, BS, 4)


def test_cow_copies_the_shared_page_on_every_layer(engines):
    """A fork's first append copies the shared tail page into a fresh one
    on every layer's K and V; the source page and every other page are
    untouched."""
    _, sides = engines
    eng = sides["port"][1]
    pool = PagedKVPool(eng.model, num_slots=2, max_len=16, block_size=4,
                       num_blocks=10)
    g = torch.Generator().manual_seed(0)
    for c in pool.cache.values():
        c.copy_(torch.randn(c.shape, generator=g))
    before = {n: c.clone() for n, c in pool.cache.items()}
    slot = pool.alloc(npages=2)
    pool.commit_prefill(slot, 6)                # tail page half full
    fork = pool.fork(slot)
    assert pool.ensure_append_page(fork) and pool.cow_copies == 1
    src, dst = pool._pages[slot][1], pool._pages[fork][1]
    assert pool._pages[slot][0] == pool._pages[fork][0] and src != dst
    for n, c in pool.cache.items():
        assert torch.equal(c[:, dst], c[:, src])
        others = [p for p in range(pool.num_blocks) if p != dst]
        assert torch.equal(c[:, others], before[n][:, others])
    assert pool.leak_report() == []


def test_write_exclusive_refuses_a_shared_page(engines):
    _, sides = engines
    eng = sides["port"][1]
    pool = PagedKVPool(eng.model, num_slots=3, max_len=32, block_size=8,
                       num_blocks=12)
    slot = pool.alloc(npages=2)
    pool.commit_prefill(slot, 12)
    fork = pool.fork(slot)
    rows = np.asarray([slot, fork, 0], np.int32)
    pos = np.asarray([12, 12, -1], np.int32)
    with pytest.raises(ValueError, match="holders"):
        check_write_exclusive(rows, pos, pool.block_tables, pool._refs, 8)
    assert pool.ensure_append_page(slot) and pool.ensure_append_page(fork)
    check_write_exclusive(rows, pos, pool.block_tables, pool._refs, 8)
    # reads below the depth stay shared: only writes are held
    check_write_exclusive(np.asarray([slot]), np.asarray([-1]),
                          pool.block_tables, pool._refs, 8)


def test_scheduler_checks_write_exclusive_before_dispatch(engines):
    """A tick whose packed list writes into a shared page raises before
    the dispatch (the row's copy-on-write skipped on purpose)."""
    cfg, sides = engines
    eng = sides["port"][1]
    rng = np.random.default_rng(12)
    sched = sched_mod.ContinuousScheduler(eng, sched_mod.SchedulerConfig(
        num_slots=3, bucket_min=8, block_size=8, prefill_chunk=16))
    sched.submit(sched_mod.Request(rid=0, prompt=_tokens(rng, 12),
                                   max_new_tokens=8))
    while not sched.running:
        sched.step()
    (slot, req), = sched.running.items()
    sched.pool.fork(slot)               # a holder that the tick ignores
    d0 = eng.dispatches
    sched._ensure_pages = lambda: None
    with pytest.raises(ValueError, match="holders"):
        sched.step()
    assert eng.dispatches == d0


def test_warm_equals_cold_bitwise_on_the_cpu(engines):
    """The port's plain versions compute each row alone, so a request
    that maps a cached prefix sees logits bitwise those of the same
    request served cold, at every step, and writes the same K/V."""
    cfg, sides = engines
    eng = sides["port"][1]
    rng = np.random.default_rng(13)
    sys_p = _tokens(rng, 3 * BS)
    a = np.concatenate([sys_p, _tokens(rng, 5)])
    b = np.concatenate([sys_p, _tokens(rng, 7)])
    kv = {}

    def serve(warm):
        sched = sched_mod.ContinuousScheduler(eng, sched_mod.SchedulerConfig(
            num_slots=3, bucket_min=8, block_size=BS, prefill_chunk=16,
            prefix_cache_pages=16 if warm else 0))
        if warm:
            sched.submit(sched_mod.Request(rid=0, prompt=a, task_id=1,
                                           max_new_tokens=4))
            sched.run()
        commit = sched.pool.commit_prefill

        def grab(slot, length):
            commit(slot, length)
            pages = sched.pool._pages[slot]
            kv[warm] = {n: c[:, pages].flatten(1, 2)[:, :length].clone()
                        for n, c in sched.pool.cache.items()}
        sched.pool.commit_prefill = grab
        req = sched_mod.Request(rid=1, prompt=b, task_id=1, max_new_tokens=6)
        sched.submit(req)
        with LogitsTap(sched) as tap:
            sched.run()
        assert sched.pool.leak_report() == []
        hit = sched.pool.prefix_cache.hit_tokens if warm else 0
        return req.out, tap.rows, hit
    cold_out, cold_rows, _ = serve(False)
    warm_out, warm_rows, hit = serve(True)
    assert hit == 3 * BS and warm_out == cold_out
    assert set(warm_rows) == set(cold_rows) and len(cold_rows) == 6
    for k in cold_rows:
        assert torch.equal(warm_rows[k], cold_rows[k]), k
    for n in ("k", "v"):
        assert torch.equal(kv[True][n], kv[False][n])
