"""Shared helpers of the PyTorch port's tests (``test_torch_*.py``).

Inputs are made with numpy and handed to both the JAX reference and the
port with identical values; nothing here runs on a GPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import aot as jax_aot
from repro.core import peft as jpeft
from repro_torch import bridge
from repro_torch.core import peft as port_peft

TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def both(x, dtype=jnp.float32):
    """numpy values -> (jax array, torch tensor) holding identical values of
    ``dtype`` (bf16 is rounded once, by JAX, then carried over exactly)."""
    if np.issubdtype(np.asarray(x).dtype, np.integer):     # indices: as is
        xj = jnp.asarray(x)
        return xj, torch.from_numpy(np.asarray(xj).copy())
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32)).copy())
    return xj, xt.to(TORCH[dtype])


def np32(x):
    """A JAX array or torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def jax_tasks(cfg, params, n):
    """``n`` fused task tables from the reference's ``random_fused``."""
    return [jax_aot.random_fused(cfg, params["embed"]["tok"], seed=s)
            for s in range(n)]


def jax_peft(tasks, task_ids):
    """The reference's multi-task fused-AoT bundle for ``mixed_step``."""
    opt = jpeft.PEFTOptions(method="aot",
                            aot=jax_aot.AoTOptions(mode="fused"))
    p = jpeft.make({"aot": jax_aot.stack_tasks(tasks)}, opt)
    p["task_ids"] = task_ids
    return p


def port_tasks_peft(tables, task_ids):
    """The port's multi-task fused-AoT bundle (as its ``ServeEngine`` builds
    it) for stacked ``tables`` ``{"table": (L, tasks, V, d)}``."""
    opt = port_peft.PEFTOptions(method="aot",
                                aot=port_peft.AoTOptions(mode="fused"))
    return dict(port_peft.make({"aot": tables}, opt), task_ids=task_ids)


def port_lm(tiny_lm):
    """The port's model and parameters carrying the reference's
    ``tiny_lm`` weights, on the CPU."""
    from repro_torch.models.model import Model
    cfg, _, params = tiny_lm
    model = Model(cfg, device="cpu")
    return model, bridge.params_from_jax(cfg, jax.device_get(params),
                                         device="cpu")


def port_tables(tasks):
    return bridge.tables_from_jax(jax.device_get(tasks), device="cpu")


# ---------------------------------------------------------------------------
# the serving stack, reference and port side by side
# ---------------------------------------------------------------------------

def pool_state(pool):
    """A paged pool's bookkeeping as plain values: pages, refcounts, block
    tables, slots, lengths, the sharing counters and, with a prefix cache,
    every entry (in LRU order, with its page, depth, parent, pins and
    children), the slots' pins and the cache's counters."""
    st = [pool.block_tables.tolist(), pool._refs.tolist(),
          list(pool._free_blocks), list(pool._free_slots),
          pool.cur_len.tolist(), pool.task_id.tolist(),
          sorted(pool._seized), sorted(pool._quarantined), pool.forks,
          pool.cow_copies, pool.compactions, pool.pages_deduped,
          pool.leak_report()]
    cache = pool.prefix_cache
    if cache is not None:
        st.append([(k, e.page, e.depth, e.parent, e.pins, sorted(e.children))
                   for k, e in cache._entries.items()])
        st.append(sorted((s, list(k)) for s, k in cache._slot_pins.items()))
        st.append((cache.hits, cache.misses, cache.hit_tokens,
                   cache.retained_pages, cache.evicted_pages))
    return st


def sched_state(sched):
    """A scheduler's state as plain values, tokens included: what the
    reference's and the port's must share after every tick."""
    def who(r):
        return (r.rid, r.sample_idx, r.priority, r.state, list(r.out))
    st = [sched.ticks, sched.clock, sched.preemptions,
          sched.prefill_chunks_run, sched.tokens_emitted,
          sorted((s, who(r)) for s, r in sched.running.items()),
          [who(r) for r in sched.queue],
          [(pf.req.rid, pf.req.sample_idx, pf.slot, pf.done, pf.length)
           for pf in sched._prefills],
          sorted((rid, r.finish_reason) for rid, r in sched.shed.items()),
          sorted((rid, r.finish_reason) for rid, r in sched.aborted.items()),
          sorted(sched.quarantined), sorted(sched.finished)]
    if sched.paged:
        st.append(pool_state(sched.pool))
    return st


def trace_ticks(sched):
    """Record ``sched_state`` after every ``step()`` (and once now) into
    ``sched.trace``; ``run``, ``run_stream`` and ``shutdown`` step through
    the instance attribute, so they are traced too."""
    sched.trace = [sched_state(sched)]
    step = sched.step

    def traced():
        step()
        sched.trace.append(sched_state(sched))
    sched.step = traced
    return sched


def assert_traces_equal(ref_scheds, port_scheds):
    """Every traced scheduler of the reference against the port's, tick
    by tick (the first differing tick is named)."""
    assert len(ref_scheds) == len(port_scheds)
    for k, (a, b) in enumerate(zip(ref_scheds, port_scheds)):
        assert len(a.trace) == len(b.trace), (k, len(a.trace), len(b.trace))
        for t, (x, y) in enumerate(zip(a.trace, b.trace)):
            if x != y:
                i = next(i for i, (u, v) in enumerate(zip(x, y)) if u != v)
                raise AssertionError(
                    f"scheduler {k}, after tick {t}, state part {i}: "
                    f"reference {x[i]!r} != port {y[i]!r}")


def both_sides(engines, scenario, **kw):
    """Run ``scenario(ns, eng, cfg, **kw)`` on the reference's side and on
    the port's of ``engines`` = ``(cfg, {"reference": (ns, eng), "port":
    (ns, eng)})``: their results must be equal, and every scheduler the
    scenario traced into ``ns.made`` must equal its counterpart after
    every tick. Returns the port's result."""
    cfg, sides = engines
    got, made = {}, {}
    for name, (ns, eng) in sides.items():
        ns.made = []
        got[name] = scenario(ns, eng, cfg, **kw)
        made[name] = ns.made
    assert_traces_equal(made["reference"], made["port"])
    assert got["port"] == got["reference"]
    return got["port"]


class LogitsTap:
    """Wraps a port scheduler's engine's serve_step while in use: records
    each running row's and each finishing prefill's reported logits row,
    keyed by (rid, sample, tokens emitted so far)."""

    def __init__(self, sched):
        self.sched, self.rows = sched, {}

    def __enter__(self):
        sched, eng = self.sched, self.sched.engine
        step = eng.serve_step

        def tapped(tokens, token_rows, token_pos, logit_idx, *a):
            out = step(tokens, token_rows, token_pos, logit_idx, *a)
            for slot, req in sched.running.items():
                self.rows[(req.rid, req.sample_idx, len(req.out))] = \
                    out[1][slot].clone()
            for pf in sched._prefills:
                n = int(((token_rows == pf.slot) & (token_pos >= 0)).sum())
                if pf.done + n >= pf.length:
                    self.rows[(pf.req.rid, 0, len(pf.req.out))] = \
                        out[1][pf.slot].clone()
            return out
        eng.serve_step = tapped
        return self

    def __exit__(self, *exc):
        del self.sched.engine.serve_step
