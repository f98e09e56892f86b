"""The ragged attention kernel's per-tick plan, on the CPU.

``decode_attention.ragged_plan`` cuts a packed token list into the items
the CUDA kernel launches over: runs of one slot's tokens at consecutive
positions (prefill chunks) in tiles of at most 16 for the tensor cores,
every other live token alone, each run of dead padding as one item. These tests hold it
to a plain loop over the tokens, on chip_smoke.py's packings, on random
packings and on the ticks of a chunked stream; check that the tick
uploads the plan with its other arrays (one upload, one download) and
hands it through ``Model.mixed_step`` to the kernel's wrapper; and check
the cluster split and the arguments the kernel wrappers pass to the C
entry points (no GPU: the entry point is replaced by a recorder).
"""
import contextlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from port_util import jax_tasks, port_lm, port_tables
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.scheduler import (ContinuousScheduler, Request,
                                         SchedulerConfig)

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PACKINGS = _chip_smoke().packings()


def loop_plan(rows, pos, tile=16):
    """The plan by a plain walk over the tokens: a token continues the item
    before it when both are dead, or when both are live in one slot at
    consecutive positions and that item holds fewer than ``tile`` tokens."""
    items = []
    for t, (r, p) in enumerate(zip(rows, pos)):
        if t > 0:
            r0, p0 = rows[t - 1], pos[t - 1]
            dead_run = p < 0 and p0 < 0
            live_run = p >= 0 and p0 >= 0 and r == r0 and p == p0 + 1 \
                and items[-1][1] < tile
            if dead_run or live_run:
                items[-1][1] += 1
                continue
        items.append([t, 1])
    return np.asarray(items, np.int32).reshape(-1, 2)


def random_packing(seed):
    """Decode tokens, chunks of random lengths and dead padding, shuffled
    as runs, over 6 slots."""
    rng = np.random.default_rng(seed)
    rows, pos = [], []
    for _ in range(rng.integers(1, 12)):
        kind = rng.integers(0, 3)
        slot = int(rng.integers(0, 6))
        if kind == 0:                                   # decode token
            rows.append(slot)
            pos.append(int(rng.integers(0, 2000)))
        elif kind == 1:                                 # a chunk
            n, lo = int(rng.integers(1, 70)), int(rng.integers(0, 900))
            rows += [slot] * n
            pos += list(range(lo, lo + n))
        else:                                           # dead padding
            n = int(rng.integers(1, 40))
            rows += [int(x) for x in rng.integers(0, 6, n)]
            pos += [int(x) for x in rng.integers(-5, 0, n)]
    return rows, pos


CASES = dict(PACKINGS)
CASES.update({f"random_{s}": random_packing(s) for s in range(12)})


def check_items(plan, rows, pos):
    """Every token once, in order; live items of 1-16 tokens of their
    first token's slot at consecutive positions; dead items all dead and
    never next to each other."""
    T = len(rows)
    rows, pos = np.asarray(rows), np.asarray(pos)
    assert plan.dtype == np.int32 and plan.shape[1] == 2
    first, count = plan[:, 0], plan[:, 1]
    assert first[0] == 0 and (first[1:] == first[:-1] + count[:-1]).all()
    assert first[-1] + count[-1] == T
    assert (count >= 1).all()
    dead = pos[first] < 0
    assert not (dead[1:] & dead[:-1]).any()
    covered = np.zeros(T, int)
    for f, n in plan:
        covered[f:f + n] += 1
        idx = np.arange(f, f + n)
        if pos[f] < 0:
            assert (pos[idx] < 0).all()
        else:
            assert n <= da.TILE_TOKENS
            assert (rows[idx] == rows[f]).all()
            assert (pos[idx] == pos[f] + np.arange(n)).all()
    assert (covered == 1).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_covers_every_token_once_in_valid_items(case):
    rows, pos = CASES[case]
    check_items(da.ragged_plan(rows, pos), rows, pos)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_equals_the_token_loop(case):
    """Runs are cut only where a run ends or at 16 tokens: the helper's
    items are exactly the plain loop's."""
    rows, pos = CASES[case]
    np.testing.assert_array_equal(da.ragged_plan(rows, pos),
                                  loop_plan(rows, pos))


@pytest.mark.parametrize("n, counts", [(1, [1]), (2, [2]), (16, [16]),
                                       (17, [16, 1]), (40, [16, 16, 8]),
                                       (256, [16] * 16)])
def test_a_run_is_cut_at_16(n, counts):
    rows, pos = [3] * n, list(range(500, 500 + n))
    plan = da.ragged_plan(rows, pos)
    assert plan[:, 1].tolist() == counts
    assert [pos[f] for f in plan[:, 0]] == \
        [500 + 16 * i for i in range(len(counts))]


@pytest.mark.parametrize("rows, pos, want", [
    ([0, 1], [5, 6], [1, 1]),                 # another slot breaks a run
    ([0, 0], [5, 7], [1, 1]),                 # a gap in positions
    ([0, 0], [6, 5], [1, 1]),                 # positions going down
    ([0, 0, 0, 0], [1, -1, -1, 2], [1, 2, 1]),   # dead padding between
    ([2, 5, 1], [-1, -3, -1], [3]),           # dead tokens: any slot
    ([0] * 40, [-1] * 40, [40]),              # a dead run is never cut
])
def test_plan_breaks_runs(rows, pos, want):
    assert da.ragged_plan(rows, pos)[:, 1].tolist() == want


def test_plan_of_an_empty_list():
    assert da.ragged_plan([], []).shape == (0, 2)


def test_chunk_tick_packing_has_23_items():
    """The phase-4 chunk tick (256 prompt tokens and 7 decode tokens): 16
    tiles of 16 and 7 single tokens, as the launch sizing in PERF.md
    assumed."""
    plan = da.ragged_plan(*PACKINGS["chunk256_decode"])
    assert plan.shape[0] == 23 and (plan[:, 1] == 16).sum() == 16


# ---------------------------------------------------------------------------
# the serving tick: the plan rides in the tick's one upload
# ---------------------------------------------------------------------------

MAX_LEN = 64


@pytest.fixture(scope="module")
def engine(tiny_lm):
    cfg, _, jparams = tiny_lm
    model, params = port_lm(tiny_lm)
    return ServeEngine(model, params, ServeConfig(max_len=MAX_LEN),
                       fused_tasks=port_tables(jax_tasks(cfg, jparams, 2)))


def _requests(cfg, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(5, 30)))
                    .astype(np.int32), task_id=i % 2,
                    max_new_tokens=int(rng.integers(2, 7)))
            for i in range(n)]


@contextlib.contextmanager
def recorded_ticks(monkeypatch, engine):
    """Records, per ``mixed_step``: the host copies of its token indices,
    the plan it was given, and the plans the attention wrapper saw."""
    ticks = []
    model = engine.model
    step, attend = model.mixed_step, ops.ragged_paged_attention

    def mixed_step(*a, **kw):
        ticks.append(dict(rows=a[2].numpy().copy(), pos=a[3].numpy().copy(),
                          plan=kw["plan"], seen=[]))
        return step(*a, **kw)

    def ragged(*a, **kw):
        ticks[-1]["seen"].append(a[6] if len(a) > 6 else kw.get("plan"))
        return attend(*a, **kw)
    monkeypatch.setattr(model, "mixed_step", mixed_step)
    monkeypatch.setattr(ops, "ragged_paged_attention", ragged)
    yield ticks


@pytest.mark.parametrize("max_prefills", [1, 4])
def test_chunked_stream_ticks_carry_their_plans(monkeypatch, engine,
                                                max_prefills):
    """A chunked stream (prefill_chunk 8): every tick's plan is the loop's
    plan of its packed list; decode tokens walk alone, each prefill's
    chunk of 2-8 tokens is one tile, the dead tail one item; every layer's
    attention call gets the tick's plan."""
    cfg = engine.model.cfg
    sched = ContinuousScheduler(engine, SchedulerConfig(
        num_slots=3, block_size=4, prefill_chunk=8,
        max_prefills=max_prefills))
    for r in _requests(cfg):
        sched.submit(r)
    with recorded_ticks(monkeypatch, engine) as ticks:
        sched.run()
    assert len(ticks) == sched.ticks > 0
    multi = 0
    for tk in ticks:
        plan = tk["plan"].numpy()
        np.testing.assert_array_equal(plan, loop_plan(tk["rows"], tk["pos"]))
        check_items(plan, tk["rows"], tk["pos"])
        assert len(tk["seen"]) == cfg.num_layers
        assert all(p is tk["plan"] for p in tk["seen"])
        live = plan[tk["pos"][plan[:, 0]] >= 0]
        assert (live[:, 1] <= 8).all()          # no chunk past the budget
        multi += int((live[:, 1] > 1).sum() > 1)
    assert sched.drain_check() == []
    if max_prefills == 4:
        assert sched.peak_prefills >= 2 and multi > 0, \
            "no tick carried two prefill tiles"


def test_serve_step_uploads_once_and_downloads_once(monkeypatch, engine):
    cfg = engine.model.cfg
    sched = ContinuousScheduler(engine, SchedulerConfig(
        num_slots=3, block_size=4, prefill_chunk=8, max_prefills=4))
    for r in _requests(cfg, seed=1):
        sched.submit(r)
    uploads, downloads = [], []
    upload, cpu = engine._upload, torch.Tensor.cpu
    serve_step = engine.serve_step

    def counted_upload(arrays):
        uploads[-1] += 1
        return upload(arrays)

    def counted_cpu(self, *a, **kw):
        if downloads:
            downloads[-1] += 1
        return cpu(self, *a, **kw)

    def step(*a, **kw):
        uploads.append(0)
        downloads.append(0)
        return serve_step(*a, **kw)
    monkeypatch.setattr(engine, "_upload", counted_upload)
    monkeypatch.setattr(engine, "serve_step", step)
    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    sched.run()
    assert len(uploads) == sched.ticks > 0
    assert uploads == [1] * sched.ticks
    assert downloads == [1] * sched.ticks


# ---------------------------------------------------------------------------
# the wrappers' arguments to the C entry points (no GPU)
# ---------------------------------------------------------------------------

@pytest.fixture
def recorder(monkeypatch):
    """Replaces the C entry points with a recorder of their arguments and
    lets the wrappers run on CPU tensors."""
    calls = []

    def lib(name):
        return lambda *args: calls.append((name, args)) or 0
    monkeypatch.setattr(da, "_lib", lib)
    monkeypatch.setattr(da, "_require_cuda", lambda dev: None)
    monkeypatch.setattr(da, "_stream", lambda dev: 0)
    monkeypatch.setattr(da, "_on_device",
                        lambda dev: contextlib.nullcontext())
    return calls


def _pages(bs, npages, slots=3, kvh=2, hd=16, h=6):
    q = torch.zeros(slots, h, hd, dtype=torch.bfloat16)
    k = torch.zeros(slots * npages + 1, bs, kvh, hd, dtype=torch.bfloat16)
    bt = torch.arange(1, slots * npages + 1,
                      dtype=torch.int32).view(slots, npages)
    return q, k, bt


SPLIT_CASES = [(16, 64), (4, 75), (8, 128), (32, 32), (16, 1), (16, 200)]


@pytest.mark.parametrize("bs, npages", SPLIT_CASES)
def test_paged_split_is_the_split_of_its_capacity(recorder, bs, npages):
    q, k, bt = _pages(bs, npages)
    cur = torch.tensor([1, bs * npages, 7], dtype=torch.int32)
    da.paged_decode_attention_kernel(q, k, k.clone(), bt, cur)
    (name, args), = recorder
    assert name == "paged_decode_attention"
    assert len(args) == len(da._ARGTYPES[name])
    # b, kvh, g, hd, block_size, npages, split
    assert args[6:13] == (3, 2, 3, 16, bs, npages,
                          da.decode_split(npages * bs))


@pytest.mark.parametrize("bs, npages", SPLIT_CASES)
def test_ragged_split_and_plan_arguments(recorder, bs, npages):
    q, k, bt = _pages(bs, npages)
    rows = torch.tensor([0, 0, 2], dtype=torch.int32)
    pos = torch.tensor([3, 4, -1], dtype=torch.int32)
    da.ragged_paged_attention_kernel(q, k, k.clone(), bt, rows, pos)
    (name, args), = recorder
    assert name == "ragged_paged_attention"
    assert len(args) == len(da._ARGTYPES[name])
    # T, n_items, kvh, g, hd, block_size, npages, split: the plan built from
    # the indices has a tile of 2 and a dead item
    assert args[8:16] == (3, 2, 2, 3, 16, bs, npages,
                          da.decode_split(npages * bs))


PLAN_BAD = {
    "int64": torch.zeros(1, 2, dtype=torch.long),
    "width": torch.zeros(1, 4, dtype=torch.int32),
    "empty": torch.zeros(0, 2, dtype=torch.int32),
    "too_many": torch.zeros(4, 2, dtype=torch.int32),
    "strided": torch.zeros(2, 3, dtype=torch.int32).T,
}


@pytest.mark.parametrize("case", sorted(PLAN_BAD))
def test_ragged_kernel_refuses_a_bad_plan(recorder, case):
    q, k, bt = _pages(16, 4)
    rows = torch.zeros(3, dtype=torch.int32)
    pos = torch.tensor([0, 1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="plan"):
        da.ragged_paged_attention_kernel(q, k, k.clone(), bt, rows, pos,
                                         PLAN_BAD[case])
    assert recorder == []


def test_plain_version_ignores_the_plan():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(3, 6, 16, generator=g)
    k = torch.randn(13, 4, 2, 16, generator=g)
    v = torch.randn(13, 4, 2, 16, generator=g)
    bt = torch.arange(1, 13, dtype=torch.int32).view(3, 4)
    rows = torch.tensor([0, 0, 2], dtype=torch.int32)
    pos = torch.tensor([3, 4, -1], dtype=torch.int32)
    plan = torch.from_numpy(da.ragged_plan(rows.numpy(), pos.numpy()))
    a = ops.ragged_paged_attention(q, k, v, bt, rows, pos, plan)
    b = ops.ragged_paged_attention(q, k, v, bt, rows, pos)
    assert torch.equal(a, b) and (a[2] == 0).all()
    assert ops.ragged_plan(rows, pos) is None        # the CPU needs none
