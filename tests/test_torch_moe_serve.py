"""The mixture-of-experts decoders on the port's serving paths against the
JAX reference (reduced qwen3-moe-30b-a3b and llama4-maverick-400b-a17b,
as ``test_torch_moe.py`` builds them): prefill plus decode steps over a
contiguous cache and over pages, ``mixed_step`` over a packing with dead
tokens, the static batch, the streams tick for tick against the
reference's scheduler (at the reduced default capacity factor 4.0, which
drops nothing, and at the full configs' 1.25, where chunk ticks drop: the
same packing gives the same drops, so the tokens are equal), warm equals
cold from the prefix cache, and the launchers.

The MoE sees each call's tokens flattened in the reference's order: (b, s)
row-major for prefill and the static batch, the packed list (decode rows,
then prompt chunks, then dead padding) for ``mixed_step``. float32
results within 2e-5; tokens and scheduler states equal.
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_util import (LogitsTap, assert_traces_equal, jax_peft, jax_tasks,
                       np32, port_tables, port_tasks_peft, trace_ticks)
from repro.serve import scheduler as jsched
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.sampling import SamplingParams as JSampling
from repro_torch import bridge, configs
from repro_torch.launch import export as export_launcher
from repro_torch.launch import serve as launcher
from repro_torch.launch import train as train_launcher
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.sampling import SamplingParams
from moe_util import LLAMA, NAMES, QWEN, TOL, bundles, setup, tokens
from moe_util import one_torch_thread  # noqa: F401 (autouse fixture)

REF = SimpleNamespace(name="reference", S=jsched, Sampling=JSampling)
PORT = SimpleNamespace(name="port", S=sched_mod, Sampling=SamplingParams)
B = 2


# ---------------------------------------------------------------------------
# prefill + decode: contiguous and paged
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,method", [
    (QWEN, "aot4"), (QWEN, "ptv2"), (LLAMA, "none"), (LLAMA, "aot4")])
def test_prefill_and_decode_match_reference(name, method):
    """Prefill 8 tokens (b 2) into a contiguous cache of 24, then 6
    decode steps (scalar and per-row positions in turn): logits and the
    whole cache after every step against the reference's."""
    cfg, jmodel, jparams, model, params = setup(name)
    toks = tokens(cfg, s=14)
    jb, pb = bundles(cfg, jparams, method)
    jlg, jcache, jpos = jax.jit(lambda t: jmodel.prefill(
        jparams, {"tokens": t}, jb, max_len=24))(jnp.asarray(toks[:, :8]))
    lg, cache, pos = model.prefill(params, torch.from_numpy(toks[:, :8]),
                                   pb, max_len=24)
    assert pos == int(jpos)
    jdec = jax.jit(lambda t, p, c: jmodel.decode_step(jparams, t, p, c, jb))
    for t in range(8, 14):
        np.testing.assert_allclose(np32(lg), np32(jlg), **TOL)
        want = bridge.cache_from_jax(cfg, jax.device_get(jcache),
                                     device="cpu")
        for n in ("k", "v"):
            np.testing.assert_allclose(np32(cache[n]), np32(want[n]), **TOL)
        p = pos + t - 8
        per_row = t % 2 == 1
        jp = jnp.full((B,), p, jnp.int32) if per_row else jnp.int32(p)
        pp = torch.full((B,), p) if per_row else p
        step = toks[:, t:t + 1]
        jlg, jcache = jdec(jnp.asarray(step), jp, jcache)
        lg, cache = model.decode_step(params, torch.from_numpy(step), pp,
                                      cache, pb)
    np.testing.assert_allclose(np32(lg), np32(jlg), **TOL)


def packed(rows_tokens, npages, bs, dead=0, decode=()):
    """A packed tick: ``decode`` rows (slot, token, position) first, then
    each slot's chunk (slot, tokens from position 0), then ``dead``
    padding tokens; block tables mapping slot s to pages 1 + s * npages
    onward. Returns (tokens (T, 1), rows, pos, block tables, logit_idx)."""
    toks, rows, pos = [], [], []
    logit_idx = np.zeros(len(rows_tokens), np.int32)
    for slot, tok, p in decode:
        toks.append(tok)
        rows.append(slot)
        pos.append(p)
        logit_idx[slot] = len(toks) - 1
    for slot, chunk in enumerate(rows_tokens):
        if chunk is None:
            continue
        for j, tok in enumerate(chunk):
            toks.append(tok)
            rows.append(slot)
            pos.append(j)
        logit_idx[slot] = len(toks) - 1
    toks += [0] * dead
    rows += [0] * dead
    pos += [-1] * dead
    bt = (1 + np.arange(len(rows_tokens))[:, None] * npages
          + np.arange(npages)[None]).astype(np.int32)
    return (np.asarray(toks, np.int32)[:, None], np.asarray(rows, np.int32),
            np.asarray(pos, np.int32), bt, logit_idx)


@pytest.mark.parametrize("name", NAMES)
def test_mixed_step_and_paged_decode_match_reference(name):
    """One mixed tick packing two slots' chunks (7 and 5 tokens) and 4
    dead tokens, then 3 paged decode steps (``decode_step`` with block
    tables), then a mixed tick of the two decode rows before a third
    slot's chunk with dead padding: logits and the whole pool after each
    call against the reference's (the pool bridged as the cache is), with
    4 stacked fused tasks."""
    cfg, jmodel, jparams, model, params = setup(name)
    rng = np.random.default_rng(4)
    npages, bs = 4, 4
    nb = 1 + 3 * npages
    jcache = jmodel.init_paged_cache(nb, bs)
    cache = model.init_paged_cache(nb, bs)
    tasks = jax_tasks(cfg, jparams, 4)
    ptables = port_tables(tasks)
    chunks = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (7, 5)]

    def both_mixed(args, tids):
        nonlocal jcache, cache
        tk, rows, pos, bt, lidx = args
        jlg, jcache = jax.jit(lambda *a: jmodel.mixed_step(
            jparams, *a[:4], jax_peft(tasks, a[5]), block_tables=a[4],
            logit_idx=a[6]))(jnp.asarray(tk), jnp.asarray(rows),
                             jnp.asarray(pos), jcache, jnp.asarray(bt),
                             jnp.asarray(tids), jnp.asarray(lidx))
        lg, cache = model.mixed_step(
            params, torch.from_numpy(tk), torch.from_numpy(rows),
            torch.from_numpy(pos), cache,
            port_tasks_peft(ptables, torch.from_numpy(tids)),
            block_tables=torch.from_numpy(bt),
            logit_idx=torch.from_numpy(lidx))
        np.testing.assert_allclose(np32(lg), np32(jlg), **TOL)
        check_pool()
        return lg

    def check_pool():
        want = bridge.cache_from_jax(cfg, jax.device_get(jcache),
                                     device="cpu")
        for n in ("k", "v"):
            np.testing.assert_allclose(np32(cache[n][:, 1:]),
                                       np32(want[n][:, 1:]), **TOL)

    args = packed(chunks + [None], npages, bs, dead=4)
    tids = np.asarray([0] * 7 + [3] * 5 + [0] * 4, np.int32)
    lg = both_mixed(args, tids)
    bt = args[3]
    last = lg.argmax(-1)[:2].numpy().astype(np.int32)
    ptids = np.asarray([0, 3], np.int32)
    jb = jax_peft(tasks, jnp.asarray(ptids))
    pb = port_tasks_peft(ptables, torch.from_numpy(ptids))
    depth = np.asarray([7, 5], np.int32)
    for _ in range(3):
        jlg, jcache = jax.jit(lambda t, p, c: jmodel.decode_step(
            jparams, t, p, c, jb, block_tables=jnp.asarray(bt[:2])))(
                jnp.asarray(last[:, None]), jnp.asarray(depth), jcache)
        lg, cache = model.decode_step(
            params, torch.from_numpy(last[:, None]),
            torch.from_numpy(depth), cache, pb,
            block_tables=torch.from_numpy(bt[:2]))
        np.testing.assert_allclose(np32(lg), np32(jlg), **TOL)
        check_pool()
        last = lg[:, -1].argmax(-1).numpy().astype(np.int32)
        depth = depth + 1
    third = rng.integers(0, cfg.vocab_size, 6).tolist()
    args = packed([None, None, third], npages, bs, dead=3,
                  decode=[(0, int(last[0]), int(depth[0])),
                          (1, int(last[1]), int(depth[1]))])
    both_mixed(args, np.asarray([0, 3] + [2] * 6 + [0] * 3, np.int32))


@pytest.mark.parametrize("name", NAMES)
def test_generate_matches_reference(name):
    """The static batch: 3 prompts of 12 with mixed tasks, 10 greedy
    steps."""
    cfg, jeng, eng = engines(name)
    prompts = tokens(cfg, b=3, s=12)
    tids = np.asarray([2, 0, 1], np.int32)
    np.testing.assert_array_equal(eng.generate(prompts, 10, tids),
                                  np.asarray(jeng.generate(prompts, 10,
                                                           tids)))


# ---------------------------------------------------------------------------
# the streams, tick for tick
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def engines(name, factor=None, max_len=48, n_tasks=3):
    cfg, jmodel, jparams, model, params = setup(name, factor)
    tasks = jax_tasks(cfg, jparams, n_tasks)
    jeng = JServeEngine(jmodel, jparams, JServeConfig(max_len=max_len),
                        fused_tasks=tasks)
    eng = ServeEngine(model, params, ServeConfig(max_len=max_len),
                      fused_tasks=port_tables(tasks))
    return cfg, jeng, eng


def workload(ns, cfg, stochastic, seed=17, n=7):
    rr = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        sp = None
        if stochastic:
            sp = ns.Sampling(temperature=0.8, top_p=0.9,
                             top_k=5 if i % 2 else 0, seed=60 + i)
        reqs.append(ns.S.Request(
            rid=i, prompt=rr.integers(0, cfg.vocab_size,
                                      int(rr.integers(3, 17))).astype(
                                          np.int32),
            task_id=int(rr.integers(0, 3)),
            max_new_tokens=int(rr.integers(2, 14)), sampling=sp))
    return reqs


LAYOUTS = {
    "slots": dict(kv_layout="slots", num_slots=3, bucket_min=8),
    "paged_chunked": dict(kv_layout="paged", num_slots=3, bucket_min=8,
                          block_size=4, num_blocks=20, prefill_chunk=8),
    "paged_whole": dict(kv_layout="paged", num_slots=3, bucket_min=8,
                        block_size=4, num_blocks=14, prefill_chunk=0),
}
STREAMS = ([(n, "paged_chunked", f, False) for n in NAMES
            for f in (None, 1.25)]
           + [(QWEN, "slots", None, False), (LLAMA, "paged_whole", None,
                                              False),
              (QWEN, "paged_chunked", 1.25, True)])


@pytest.mark.parametrize("name,layout,factor,stochastic", STREAMS)
def test_streams_match_reference(name, layout, factor, stochastic):
    """The paged chunked stream of both archs at the reduced default
    factor (drop-free) and at 1.25 (qwen3-moe also sampled), the slots and
    the paged whole-prompt layouts drop-free: the scheduler's state
    after every tick, tokens and dispatches equal to the reference's. At
    1.25 the chunk ticks of qwen3-moe drop assignments (the port's
    recorded routes show it) and decode-only ticks never do."""
    cfg, jeng, eng = engines(name, factor)
    runs = []
    for ns, e in ((REF, jeng), (PORT, eng)):
        sched = trace_ticks(ns.S.ContinuousScheduler(
            e, ns.S.SchedulerConfig(**LAYOUTS[layout])))
        d0 = e.dispatches
        reqs = workload(ns, cfg, stochastic)
        for r in reqs:
            sched.submit(r)
        if ns is PORT:
            with e.model.record_routes() as routes:
                sched.run()
        else:
            sched.run()
        runs.append((sched, e.dispatches - d0, [r.out for r in reqs]))
    (jsch, jd, jout), (sch, d, out) = runs
    assert_traces_equal([jsch], [sch])
    assert sch.drain_check() == []
    assert (d, out) == (jd, jout)
    nmoe = sum(cfg.moe_layer_mask())
    assert len(routes) == nmoe * d
    if layout == "paged_chunked":
        slots = LAYOUTS[layout]["num_slots"]
        decode = [r for r in routes if r["tokens"] == slots]
        assert decode and all(bool(r["keep"].all()) for r in decode)
        dropped = sum(int((~r["keep"]).sum()) for r in routes)
        if factor is None:
            assert dropped == 0
        elif name == QWEN:
            assert dropped > 0


def test_dead_padding_before_live_tokens_changes_outputs():
    """ROADMAP C9 at the model level: reduced qwen3-moe at factor 1.25,
    one mixed tick of 40 live tokens (5 slots' chunks of 8) with 24 dead
    tokens placed after them (the scheduler's order) and the same tick
    with the dead tokens placed first: the reference and the port agree
    on each (logits within 2e-5); placed first, the dead tokens displace
    live assignments and change some slots' logits, in both packages."""
    cfg, jmodel, jparams, model, params = setup(QWEN, 1.25)
    rng = np.random.default_rng(0)
    chunks = [rng.integers(0, cfg.vocab_size, 8).tolist() for _ in range(5)]
    tk, rows, pos, bt, lidx = packed(chunks, 2, 4, dead=24)
    live = pos >= 0
    order_first = np.concatenate([np.flatnonzero(~live),
                                  np.flatnonzero(live)])
    out = {}
    for label, order in (("after", np.arange(len(pos))),
                         ("first", order_first)):
        inv = np.argsort(order)
        args = (tk[order], rows[order], pos[order], bt,
                inv[lidx].astype(np.int32))
        jlg, _ = jax.jit(lambda *a: jmodel.mixed_step(
            jparams, *a[:4], block_tables=a[4], logit_idx=a[5]))(
                jnp.asarray(args[0]), jnp.asarray(args[1]),
                jnp.asarray(args[2]), jmodel.init_paged_cache(11, 4),
                jnp.asarray(bt), jnp.asarray(args[4]))
        with model.record_routes() as routes:
            lg, _ = model.mixed_step(
                params, torch.from_numpy(args[0]), torch.from_numpy(args[1]),
                torch.from_numpy(args[2]), model.init_paged_cache(11, 4),
                block_tables=torch.from_numpy(bt),
                logit_idx=torch.from_numpy(args[4]))
        np.testing.assert_allclose(np32(lg), np32(jlg), **TOL)
        out[label] = (lg, sum(int((~r["keep"][torch.from_numpy(
            inv[np.flatnonzero(live)])]).sum()) for r in routes))
    assert out["after"][1] == 0 < out["first"][1]
    moved = (out["first"][0] - out["after"][0]).abs().amax(-1) > 1e-4
    assert int(moved.sum()) > 0


@pytest.mark.parametrize("name", NAMES)
def test_warm_equals_cold_from_prefix_cache(name):
    """Drop-free (factor 4.0), a request whose prompt maps a 3-page
    cached prefix gives the cold request's tokens, and its reported
    logits at every step within 2e-5 of the cold ones."""
    cfg, _, eng = engines(name)
    rng = np.random.default_rng(13)
    bs = 4
    sys_p = rng.integers(0, cfg.vocab_size, 3 * bs).astype(np.int32)
    a = np.concatenate([sys_p, rng.integers(0, cfg.vocab_size, 5)])
    b = np.concatenate([sys_p, rng.integers(0, cfg.vocab_size, 7)])

    def serve(warm):
        sched = sched_mod.ContinuousScheduler(eng, sched_mod.SchedulerConfig(
            num_slots=3, bucket_min=8, block_size=bs, prefill_chunk=8,
            prefix_cache_pages=16 if warm else 0))
        if warm:
            sched.submit(sched_mod.Request(rid=0, prompt=a.astype(np.int32),
                                           task_id=1, max_new_tokens=4))
            sched.run()
        req = sched_mod.Request(rid=1, prompt=b.astype(np.int32), task_id=1,
                                max_new_tokens=6)
        sched.submit(req)
        with LogitsTap(sched) as tap:
            sched.run()
        assert sched.pool.leak_report() == []
        hit = sched.pool.prefix_cache.hit_tokens if warm else 0
        return req.out, tap.rows, hit
    cold_out, cold_rows, _ = serve(False)
    warm_out, warm_rows, hit = serve(True)
    assert hit == 3 * bs and warm_out == cold_out
    assert set(warm_rows) == set(cold_rows) and len(cold_rows) == 6
    for k in cold_rows:
        np.testing.assert_allclose(np32(warm_rows[k]), np32(cold_rows[k]),
                                   **TOL)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

BASE = ["--device", "cpu", "--reduced", "--demo", "--tasks", "2",
        "--requests", "4", "--rate", "0.7", "--slots", "2", "--prompt", "12",
        "--steps", "6", "--max-len", "48", "--quiet"]


@pytest.mark.parametrize("layout", [[], ["--layout", "slots"],
                                    ["--prefill-chunk", "0"]],
                         ids=["paged", "slots", "whole"])
@pytest.mark.parametrize("name", NAMES)
def test_launcher_serves_each_moe_arch(name, layout):
    sched = launcher.main(BASE + ["--arch", name] + layout)
    assert len(sched.finished) == 4 and sched.drain_check() == []
    if not layout:
        assert launcher.main(BASE + ["--arch", name, "--static"]).shape == (
            4, 6)


@pytest.mark.parametrize("name", NAMES)
def test_train_launcher_trains_each_moe_arch(name, tmp_path, capsys):
    train_launcher.main(["--device", "cpu", "--reduced", "--arch", name,
                         "--steps", "2", "--method", "aot", "--ckpt-dir",
                         str(tmp_path)])
    assert "events: []" in capsys.readouterr().out


def test_export_then_serve_load_llama4(tmp_path):
    """``launch.export``'s writer puts float32 tables of reduced llama4
    (its ``--arch``) in the reference's checkpoint format, and
    ``launch.serve --arch --load`` serves them through the MoE layers.
    (The export's training loop is the smollm one that
    ``test_torch_lifecycle.py`` runs.)"""
    cfg = configs.reduced(configs.get(LLAMA), repeats=2)   # as --reduced
    assert export_launcher.parser().parse_args(
        ["--arch", LLAMA]).arch == LLAMA
    gen = torch.Generator().manual_seed(0)
    out = str(tmp_path / "fused")
    tables = {mode: {"table": torch.randn(
        cfg.num_layers, cfg.vocab_size, cfg.d_model, generator=gen) * 0.02}
        for mode in export_launcher.STEPS}
    assert export_launcher.export_tasks(out, tables, cfg.name) == [1, 2]
    sched = launcher.main([a for a in BASE if a != "--demo"]
                          + ["--arch", LLAMA, "--load", out])
    assert len(sched.finished) == 4 and sched.drain_check() == []
