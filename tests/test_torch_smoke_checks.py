"""The pure-Python gates of the port's card scripts, on the CPU: phase 2's
check of the redesigned kernels' ptxas output (flash_mma_kernel,
decode_split_kernel, ragged_split_kernel, aot_gather_add_kernel), phase
6's comparison of kernel logits with the plain versions' (near ties),
phase 6's swap of the kernel wrappers in ``ops`` for the plain versions,
phases 5e-5g's gates and replayed schedules, and phase 7's gates (the
loss drop, the frozen backbone, fused against reparametrized) and 7c's
stream replayed, and phase 8's on a reduced encoder (the launch
arithmetic, the multi-task batch bitwise the single table, the served
classifier's gate and its zeroed control), and phase 10's rule for a
stream's tokens against its prompts served alone (the first difference a
near tie) on a reduced sliding-window stream. The phases themselves need
the card (chip_smoke.py)."""

import importlib.util
import inspect
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke")

FLASH = "_ZN12_GLOBAL__N_116flash_mma_kernelILi64ELb1EEEvPKT_"
DECODE = ("_ZN12_GLOBAL__N_119decode_split_kernelI13__nv_bfloat16Lb1ELi64ELi4E"
          "Lb1EEEvv")
RAGGED = ("_ZN12_GLOBAL__N_119ragged_split_kernelI13__nv_bfloat16Lb1ELi64ELi4E"
          "EEvv")
GATHER = ("_ZN12_GLOBAL__N_121aot_gather_add_kernelI13__nv_bfloat16S1_Lb1ELb1E"
          "LNS_4ModeE1EEEvPKT_PKT0_PKiSA_PKfPS2_SE_iiif")


def _ptxas(name, regs, spill):
    return (f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, "
            f"{spill} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, 380 bytes cmem[0]\n")


LOGS = {
    "clean": ({"flash_attention": _ptxas(FLASH, 168, 0),
               "decode_attention": _ptxas(DECODE, 72, 0)
               + _ptxas(RAGGED, 168, 0)}, None),
    "spill": ({"flash_attention": _ptxas(FLASH, 255, 40),
               "decode_attention": _ptxas(DECODE, 72, 0)
               + _ptxas(RAGGED, 168, 0)}, "spill"),
    "spill_ragged": ({"flash_attention": _ptxas(FLASH, 168, 0),
                      "decode_attention": _ptxas(DECODE, 72, 0)
                      + _ptxas(RAGGED, 128, 16)}, "spill"),
    "missing": ({"flash_attention": _ptxas(FLASH, 168, 0),
                 "decode_attention": _ptxas("other_kernel", 40, 0)},
                "missing"),
    "missing_ragged": ({"flash_attention": _ptxas(FLASH, 168, 0),
                        "decode_attention": _ptxas(DECODE, 72, 0)},
                       "missing"),
    "cached": ({"flash_attention": "cached",
                "decode_attention": "cached"}, None),
    "gather_norm": ({"flash_attention": "cached",
                     "decode_attention": "cached",
                     "aot_gather_add": _ptxas(GATHER, 30, 0)}, None),
    "spill_gather_norm": ({"flash_attention": "cached",
                           "decode_attention": "cached",
                           "aot_gather_add": _ptxas(GATHER, 30, 8)},
                          "spill"),
    "missing_gather": ({"flash_attention": "cached",
                        "decode_attention": "cached",
                        "aot_gather_add": _ptxas("other_kernel", 30, 0)},
                       "missing"),
}


@pytest.mark.parametrize("case", sorted(LOGS))
def test_phase2_refuses_spills_of_redesigned_kernels(case):
    logs, fault = LOGS[case]
    if fault:
        with pytest.raises(AssertionError, match=fault):
            cs.redesigned(logs)
        return
    new = cs.redesigned(logs)
    if case == "cached":
        assert new == {}
    elif case == "gather_norm":
        assert new == {"aot_gather_add_kernel":
                       ["I13__nv_bfloat16S1_Lb1ELb1ELNS_4ModeE1EE:30r/0s"]}
    else:
        assert new == {"flash_mma_kernel": ["ILi64ELb1EE:168r/0s"],
                       "decode_split_kernel":
                           ["I13__nv_bfloat16Lb1ELi64ELi4ELb1EE:72r/0s"],
                       "ragged_split_kernel":
                           ["I13__nv_bfloat16Lb1ELi64ELi4EE:168r/0s"]}


def _logits(rows=6, vocab=50, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, vocab, generator=g) * 3


def test_against_plain_identical_logits():
    lg = _logits()
    r = cs.against_plain(lg, lg.clone())
    assert r["ok"] and r["near_ties"] == 0 and r["tie_gap"] == 0.0
    assert r["logits_max_abs_err"] == 0.0


@pytest.mark.parametrize("gap,ok", [(0.01, True), (0.5, False)])
def test_against_plain_counts_a_flip_and_holds_its_gap(gap, ok):
    lg_p = _logits()
    best = lg_p.argmax(-1)
    second = lg_p.clone()
    second[0, best[0]] = -1e9
    other = second[0].argmax()
    lg_p[0, other] = lg_p[0, best[0]] - gap          # runner-up at ``gap``
    lg_k = lg_p.clone()
    lg_k[0, other] += gap + 1e-3                      # the kernels pick it
    r = cs.against_plain(lg_k, lg_p)
    assert r["near_ties"] == 1
    assert r["tie_gap"] == pytest.approx(gap, abs=1e-5)
    assert r["ok"] is ok


PLAIN_OPS = ("aot_gather_add", "aot_gather_add_multitask", "rms_norm",
             "ragged_paged_attention", "flash_attention", "decode_attention",
             "paged_decode_attention")


@pytest.mark.parametrize("name", PLAIN_OPS)
def test_plain_ops_take_every_positional_argument_of_their_op(name):
    """The model passes ``ops`` the op's positional parameters (the ragged
    plan included) and its keyword-only ones (the gather-adds' ``norm``):
    phase 6's plain stand-in must take each of them, and the op is
    restored afterwards."""
    from repro_torch.kernels import ops
    op = getattr(ops, name)
    params = inspect.signature(op).parameters
    positional = [p for p in params.values()
                  if p.kind is p.POSITIONAL_OR_KEYWORD]
    keyword = {"norm": None} if "norm" in params else {}
    assert bool(keyword) == name.startswith("aot_gather_add")
    with cs.plain_ops():
        stand_in = getattr(ops, name)
        assert stand_in is not op
        inspect.signature(stand_in).bind(*range(len(positional)), **keyword)
    assert getattr(ops, name) is op


def test_plain_ops_ragged_drops_the_plan():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)
    q = torch.randn(3, 6, 16, generator=g)
    k = torch.randn(13, 4, 2, 16, generator=g)
    v = torch.randn(13, 4, 2, 16, generator=g)
    bt = torch.arange(1, 13, dtype=torch.int32).view(3, 4)
    rows = torch.tensor([0, 0, 2], dtype=torch.int32)
    pos = torch.tensor([3, 4, -1], dtype=torch.int32)
    plan = torch.from_numpy(da.ragged_plan(rows.numpy(), pos.numpy()))
    with cs.plain_ops():
        out = ops.ragged_paged_attention(q, k, v, bt, rows, pos, plan)
    assert torch.equal(out, da.ragged_paged_attention_plain(q, k, v, bt,
                                                            rows, pos))


# ---------------------------------------------------------------------------
# phase 5e: the faulted tick's gates and schedule
# ---------------------------------------------------------------------------

def test_survivors_expected_takes_out_every_loss():
    assert cs.survivors_expected(range(6), [1], {4: "req"}, [5, 1]) == \
        {0, 2, 3}
    assert cs.survivors_expected([0, 1], [], {}, []) == {0, 1}


def test_prefix_mismatches_stop_at_the_faulted_tick():
    twin = {0: [5, 6, 7, 8], 1: [1, 2, 3], 2: [9, 9]}
    ticks_of = {0: [3, 4, 10, 11], 1: [4, 5, 9], 2: [2, 6]}
    # rid 0 differs only after tick 6, rid 1 at tick 5, rid 2 not at all
    got = {0: [5, 6, 0, 0], 1: [1, 0, 3], 2: [9, 9]}
    assert cs.prefix_mismatches(got, twin, ticks_of, 6) == [1]
    assert cs.prefix_mismatches(got, twin, ticks_of, 4) == []
    assert cs.prefix_mismatches(got, twin, ticks_of, 10) == [0, 1]


def test_first_divergence_names_request_and_tick():
    twin = {0: [1, 2], 1: [3, 4, 5], 2: [6]}
    ticks_of = {0: [1, 2], 1: [2, 7, 8], 2: [3]}
    assert cs.first_divergence({0: [1, 2], 2: [6]}, twin, ticks_of) is None
    assert cs.first_divergence({0: [1, 2], 1: [3, 0, 5]}, twin,
                               ticks_of) == (1, 7)
    # one stream a prefix of the other: the tick of its last token
    assert cs.first_divergence({1: [3, 4]}, twin, {1: [2, 7]}) == (1, 7)


def test_fault_launches_count_the_raised_attempt():
    assert cs.fault_launches(32, 71, 0) == 2272
    assert cs.fault_launches(32, 71, cs.FAULT_LAYER) == 2272 + 16
    assert cs.fault_launches(2, 5, 1) == 11


class FakeEngine:
    """The engine's serving interface without a model: a tick's tokens,
    a whole prompt's first tokens, n > 1 first draws and a slots decode
    step's tokens are zeros, an armed fault acts as
    ``ServeEngine.inject_fault`` says, dispatches are counted by kind as
    ``ServeEngine.attach_metrics`` counts them, and the block-table check
    runs as in ``serve_step`` (the scheduler itself checks the write-fresh
    rule). Phase 5's scheduling does not depend on the tokens (no stop or
    end token), so this replays the card's schedule exactly."""

    def __init__(self):
        from types import SimpleNamespace
        self.cfg = SimpleNamespace(max_len=cs.MAX_LEN)
        self.model = SimpleNamespace(
            cfg=SimpleNamespace(vocab_size=49152, layer_kinds=("attn",),
                                prefix_lm_len=0, frontend=None),
            window=lambda: 0,
            init_paged_cache=lambda nb, bs: {
                n: torch.zeros(1, nb, bs, 1, 1) for n in ("k", "v")},
            init_cache=lambda b, S: {
                n: torch.zeros(1, b, S, 1, 1) for n in ("k", "v")})
        self.num_tasks, self.peft = 4, None
        self.dispatches, self._pending_fault, self._m = 0, None, None

    def attach_metrics(self, registry):
        self._m = {k: registry.counter(f"engine_dispatch_{k}_total")
                   for k in ("serve_step", "prefill", "decode_mixed",
                             "sample_first")}

    def _count(self, kind):
        self.dispatches += 1
        if self._m is not None:
            self._m[kind].inc()

    def inject_fault(self, kind, slot=-1):
        self._pending_fault = (kind, slot)

    def prefill_request(self, tokens, length, task_id, sample=None):
        self._count("prefill")
        first = [0] if sample is None else self.sample_first(None, sample)
        return first, {n: torch.zeros(1, 1, tokens.shape[1], 1, 1)
                       for n in ("k", "v")}

    def sample_first(self, logits_row, sample):
        self._count("sample_first")
        return [0] * len(sample[0])

    def decode_mixed(self, tokens, pos, cache, task_ids, sample=None):
        import numpy as np
        self._count("decode_mixed")
        return np.zeros(len(pos), np.int32), cache

    def serve_step(self, tokens, token_rows, token_pos, logit_idx, cache,
                   block_tables, token_tasks, sample):
        import numpy as np
        from repro_torch.models.model import check_table_reach
        from repro_torch.serve.engine import DispatchFault
        fault, self._pending_fault = self._pending_fault, None
        if fault is not None and fault[0] == "alloc_failure":
            raise DispatchFault("injected")
        check_table_reach(token_rows, token_pos, block_tables.shape[1],
                          cache["k"].shape[2])
        finite = np.ones(len(logit_idx), bool)
        if fault is not None:
            finite[fault[1]] = False
        self._count("serve_step")
        return (np.zeros(len(logit_idx), np.int32),
                np.zeros((len(logit_idx), 1), np.float32), cache, finite)


def _phase5_stream():
    from repro_torch.launch import serve as launcher
    args = launcher.parser().parse_args(cs.BASE + cs.GREEDY)
    eng = FakeEngine()

    def fresh():
        return (launcher.make_scheduler(eng, args),
                launcher.make_arrivals(args, 49152, args.tasks))
    return eng, fresh


def test_phase5e_f1_f2_find_their_ticks_on_phase5_stream():
    eng, fresh = _phase5_stream()
    twin, arrivals = fresh()
    cs.stream_ticks(twin, arrivals)
    assert (twin.ticks, len(twin.finished)) == (71, 16)
    sched, arrivals = fresh()
    state = {}
    cs.stream_ticks(sched, arrivals, cs.f1_before(eng, state))
    assert cs.F1_ALLOC_TICK <= state["alloc"] < cs.F1_RAISE_TICK
    assert state["raise"] >= cs.F1_RAISE_TICK and state["armed"]
    assert sched.dispatch_faults == sched.tick_retries_used == 1
    assert sched.ticks == 71 and len(sched.finished) == 16
    sched, arrivals = fresh()
    state = {}
    cs.stream_ticks(sched, arrivals, cs.f2_before(eng, state))
    assert state["tick"] >= cs.F2_TICK
    assert set(sched.quarantined) == {state["rid"]}
    assert sched.pool.num_quarantined() > 0
    assert len(sched.finished) == 15 and sched.drain_check() == []


def test_phase5e_f3_plan_fires_every_kind_on_phase5_stream():
    """F3_PLAN's seed fires every kind on phase 5's stream, work is live
    at shutdown, and every F3 gate holds (the card runs the same
    schedule; only the tokens differ)."""
    _, fresh = _phase5_stream()
    twin, arrivals = fresh()
    cs.stream_ticks(twin, arrivals)
    sched, arrivals = fresh()
    res = cs.run_f3(sched, arrivals)
    assert cs.f3_failures(sched, set(twin.finished), res, 16) == []
    assert res["held"] > 0 and res["report"].quarantined_pages_released > 0
    assert sched.preemptions > 0, "exhaust never pressed on the pool"


def test_f3_failures_name_each_broken_gate():
    _, fresh = _phase5_stream()
    twin, arrivals = fresh()
    cs.stream_ticks(twin, arrivals)
    sched, arrivals = fresh()
    res = cs.run_f3(sched, arrivals)
    res["injector"].applied["nan"] = 0
    res["leaks_before"] = ["leaked pages"]
    lost = min(sched.finished)
    sched.finished.pop(lost)
    bad = cs.f3_failures(sched, set(twin.finished), res, 16)
    assert "nan never fired" in bad
    assert any(b.startswith("leaks") for b in bad)
    assert any(b.startswith("survivors") for b in bad)
    assert "1 requests unaccounted for" in bad


# ---------------------------------------------------------------------------
# phase 5f: the shared-prefix and policy streams, replayed
# ---------------------------------------------------------------------------

def _replay(monkeypatch, label):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    return cs.shared_run(FakeEngine(), cs.SHARED_RUNS[label])


@pytest.mark.parametrize("label", sorted(cs.SHARED_RUNS))
def test_phase5f_replay_fixes_every_count(monkeypatch, label):
    """The card's schedule of each 5f run is the replay's: its counts are
    SHARED_EXPECT's and every gate holds (no kernel runs here)."""
    run = _replay(monkeypatch, label)
    assert run["counts"] == cs.SHARED_EXPECT[label]
    assert cs.shared_failures(label, run, 0) == []


def test_phase5f_runs_exercise_what_they_gate():
    """The replayed counts show each path 5f is for: warm hits skip the
    prompt tokens the cold run packs, the small pool's admissions are
    rescued by compaction, the priority mix sheds both ways and preempts
    for admission, and each n = 4 run forks some samples and requeues
    others (the whole-prompt run forks all)."""
    e = cs.SHARED_EXPECT
    cold, warm = e["cold"], e["warm"]
    assert warm["hits"] > 0 and cold["prefill_tokens"] - \
        warm["prefill_tokens"] == warm["hit_tokens"] > 0
    assert warm["evicted"] > 0 and warm["ticks"] < cold["ticks"]
    assert e["compaction"]["compaction_rescues"] >= 1
    p = e["priorities"]
    assert min(p["shed_queue_full"], p["shed_displaced"],
               p["admission_preemptions"]) >= 1
    for label in ("sampled_n4", "greedy_n4", "greedy_n4_whole"):
        r = e[label]
        assert r["forks"] == r["cow_copies"] == len(r["forked_samples"]) > 0
        assert r["finished"] == 4
    assert e["greedy_n4"]["forks"] < 12 == e["greedy_n4_whole"]["forks"]


def test_phase5f_gates_name_each_failure(monkeypatch):
    run = _replay(monkeypatch, "priorities")
    run["counts"]["forks"] += 1
    lost = min(run["sched"].finished)
    run["sched"].finished.pop(lost)
    run["launches"]["ragged_paged_attention"] = 1
    bad = cs.shared_failures("priorities", run, 0)
    assert any("'forks': (1, 0)" in b for b in bad)
    assert any(b.startswith("finished") for b in bad)
    assert any("ragged_paged_attention launched 1 times" in b for b in bad)


def test_sibling_report_tells_forked_from_requeued(monkeypatch):
    run = _replay(monkeypatch, "greedy_n4")
    sched = run["sched"]
    assert cs.sibling_report(sched, run["ticks_of"]) == ([], "8/8")
    sched.finished[1].samples[1] = [7]              # a forked sibling
    sched.finished[2].samples[2] = [7]              # a requeued one
    assert cs.sibling_report(sched, run["ticks_of"]) == (["1:1"], "7/8")


# ---------------------------------------------------------------------------
# phase 5g: observability and crash recovery, replayed
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def restore_twins(tmp_path_factory):
    """The crash-free twin of each 5g stream, replayed."""
    d = tmp_path_factory.mktemp("twins")
    sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda: None
    try:
        return {tuple(extra): cs.sample_outs(cs.restore_run(
            FakeEngine(), extra, d / "twin.jsonl",
            cs.serve_crashing(0))["sched"].finished)
            for extra in (cs.GREEDY, cs.N4_SAMPLED,
                          cs.GREEDY + cs.SLOTS_LAYOUT)}
    finally:
        torch.cuda.synchronize = sync


def _replay_5g(monkeypatch, tmp_path, label):
    """One 5g run as phase_restore drives it, on the model-less engine.
    Returns the run, its flags and its crash tick (None: no crash tick)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    eng, path = FakeEngine(), tmp_path / f"{label}.jsonl"
    if label in cs.CRASH_RUNS:
        extra, crash_at = cs.CRASH_RUNS[label]
        return cs.restore_run(eng, extra, path, cs.serve_crashing(crash_at),
                              crash_at), extra, crash_at
    if label == "slots_snapshot":
        extra = cs.GREEDY + cs.SLOTS_LAYOUT
        return cs.restore_run(eng, extra, path, cs.serve_snapshot(
            cs.SNAPSHOT_TICK, tmp_path / "slots.json")), extra, \
            cs.SNAPSHOT_TICK
    return cs.restore_run(eng, cs.GREEDY, path,
                          cs.serve_chaos(cs.F4_PLAN)), cs.GREEDY, None


@pytest.mark.parametrize("label", sorted(cs.RESTORE_EXPECT))
def test_phase5g_replay_fixes_every_count(monkeypatch, tmp_path,
                                          restore_twins, label):
    """The card's schedule of each 5g run is the replay's: its counts are
    RESTORE_EXPECT's and every gate of restore_failures holds."""
    run, extra, crash_at = _replay_5g(monkeypatch, tmp_path, label)
    assert run["counts"] == cs.RESTORE_EXPECT[label]
    assert cs.restore_failures(label, run, restore_twins[tuple(extra)],
                               crash_at, 0) == []


def test_phase5g_runs_exercise_what_they_gate():
    """Each crash run crashes once (F4 at least once) and restores live
    requests; the tick before each crash packs what its name says: the
    stream's first prompts chunking, decode rows beside a chunk, decode
    rows alone, request 0's forked samples beside fresh n = 4 prompts."""
    e = cs.RESTORE_EXPECT
    for label, c in e.items():
        assert len(c["ticks"]) >= 2 and c["restored"]
        assert all(r["live"] > 0 for r in c["restored"]), label
    assert cs.CRASH_RUNS["first_chunks"][1] <= 4
    assert e["first_chunks"]["tick_before"][1] >= 2
    assert min(e["mixed"]["tick_before"]) > 0
    assert e["decode_only"]["tick_before"] == [8, 0]
    assert e["sampled_n4"]["tick_before"] == [4, 3]
    assert e["sampled_n4"]["dispatches"]["sample_first"] == 4
    assert e["slots_snapshot"]["dispatches"]["serve_step"] == 0
    assert e["F4"]["journal"]["quarantine"] and e["F4"]["journal"]["abort"]


def test_phase5g_gates_name_each_failure(monkeypatch, tmp_path,
                                        restore_twins):
    run, extra, crash_at = _replay_5g(monkeypatch, tmp_path, "mixed")
    twin = dict(restore_twins[tuple(extra)])
    run["counts"]["ticks"] = [1, 2]
    early = min(k for k, t in run["ticks_of"].items() if t[0] < crash_at)
    twin[early] = [7] + twin[early][1:]      # a token before the crash
    run["launches"]["ragged_paged_attention"] = 1
    bad = cs.restore_failures("mixed", run, twin, crash_at, 0)
    assert any("'ticks': ([1, 2]" in b for b in bad)
    assert any(b.startswith("tokens before the crash") for b in bad)
    assert any("ragged_paged_attention launched 1 times" in b for b in bad)


def test_phase5g_obs_runs_are_bitwise_and_traced(monkeypatch):
    """Observability off / on / on / off on phase 5's stream: every run's
    streams equal, the traced run has every tick span once per tick (the
    first, admission alone, has no decode rows to page)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    runs = cs.obs_runs(FakeEngine())
    assert [r[0] for r in runs] == ["off", "on", "on", "off"]
    assert all(r[3] == runs[0][3] and not r[5] for r in runs)
    spans = cs.span_ms(runs[1][4].tracer)
    assert set(spans) == set(cs.SPANS)
    assert {k: n for k, (_, n) in spans.items()} == {
        "admission": 71, "ensure_pages": 70, "pack_budget_split": 71,
        "dispatch": 71, "postprocess": 71}


# ---------------------------------------------------------------------------
# phase 7: train, fuse, serve the trained tasks
# ---------------------------------------------------------------------------

def test_phase7a_loss_drop_gate():
    """The same batches' mean must fall for every run; with ``fresh``
    (the FRESH_GATED runs) the last steps' mean on other batches too."""
    losses = [10.95, 10.96, 10.93, 10.94, 10.90] + [10.96] * 25
    again = [10.90, 10.92, 10.89, 10.90, 10.86]
    first, after, last, bad = cs.loss_drop(losses, again)
    assert bad == [] and after < first < last
    assert cs.loss_drop(losses, [11.0] * 5)[3] == [
        "loss did not fall (10.9360 -> 11.0000 on the first 5 batches)"]
    bad = cs.loss_drop(losses[:-1] + [float("nan")], [10.0] * 5)[3]
    assert bad == ["a loss is not finite"]
    assert cs.loss_drop(losses, again, fresh=True)[3] == [
        "loss did not fall (10.9360 -> 10.9600 from the first 5 steps to "
        "the last 5)"]
    falling = losses[:5] + [10.5] * 25
    assert cs.loss_drop(falling, again, fresh=True)[3] == []
    assert cs.FRESH_GATED == ("kron",) and set(cs.FRESH_GATED) <= set(
        cs.TRAIN_LM)


def test_phase7a_changed_leaves_is_bitwise():
    a = [torch.zeros(3), torch.ones(2)]
    b = [x.clone() for x in a]
    assert cs.changed_leaves(a, b) == []
    b[1][0] = torch.nextafter(torch.tensor(1.0), torch.tensor(2.0))
    assert cs.changed_leaves(a, b) == [1]


def test_phase7c_fused_vs_reparam_on_cpu():
    """The comparison 7c gates, at reduced widths: exact on the CPU."""
    from repro_torch import configs
    from repro_torch.core import aot as aot_mod
    from repro_torch.core import peft as peft_mod
    from repro_torch.models.model import Model, ModelOptions
    cfg = configs.reduced(configs.get("smollm-360m"), repeats=2)
    model = Model(cfg, ModelOptions(attn_impl="ref"), device="cpu")
    params = model.init(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(0))
    toks[0, 3] = 5
    fused_opt = peft_mod.PEFTOptions(method="aot",
                                     aot=aot_mod.AoTOptions(mode="fused"))
    for mode in ("fc", "kron"):
        opt = peft_mod.PEFTOptions(method="aot", aot=aot_mod.AoTOptions(
            mode=mode, rank=4, dropout=0.0))
        pp = peft_mod.init(cfg, opt, seed=1, device="cpu")
        pp["aot"] = {k: torch.randn(v.shape) * 0.05
                     for k, v in pp["aot"].items()}
        fused = aot_mod.fuse(pp["aot"], cfg, opt.aot,
                             embed=params["embed"]["tok"], vocab_chunk=50)
        err, share = cs.fused_vs_reparam(
            model, params, peft_mod.make(pp, opt),
            peft_mod.make({"aot": fused}, fused_opt), toks)
        assert (err, share) == (0.0, 1.0)
        fused["table"][:, 5] += 1.0         # a wrong row shows
        err, share = cs.fused_vs_reparam(
            model, params, peft_mod.make(pp, opt),
            peft_mod.make({"aot": fused}, fused_opt), toks)
        assert err > 0.1 and share < 1.0


def test_phase7c_replay_fixes_the_counts(monkeypatch):
    """7c's stream (SERVE_TRAINED: phase 5's flags, two tasks, eight
    requests) replayed without a model: the card's ticks and dispatches
    are TRAINED_EXPECT's, every request's first-token row is captured, and
    the launches 7c requires are one per layer per dispatched tick."""
    from repro_torch.launch import serve as launcher
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    eng = FakeEngine()
    args = launcher.parser().parse_args(cs.SERVE_TRAINED)
    arrivals = launcher.make_arrivals(args, 49152, args.tasks)
    assert {r.task_id for _, r in arrivals} == {0, 1}
    sched, rows = cs.trained_stream(eng, args, arrivals)
    got = dict(ticks=sched.ticks, dispatched=eng.dispatches,
               finished=len(sched.finished))
    assert got == cs.TRAINED_EXPECT
    assert sorted(rows) == [r.rid for _, r in arrivals]
    assert sched.drain_check() == [] and sched.preemptions == 0
    assert cs.trained_launches(32, got["dispatched"]) == {
        "aot_gather_add_multitask": 32 * 57,
        "ragged_paged_attention": 32 * 57}
    cs.check_launches("7c", dict(cs.trained_launches(2, 3), rms_norm=0),
                      cs.trained_launches(2, 3))
    with pytest.raises(AssertionError, match="rms_norm launched 1"):
        cs.check_launches("7c", dict(cs.trained_launches(2, 3), rms_norm=1),
                          cs.trained_launches(2, 3))


def test_phase7c_against_float32_gate():
    """Per task: the served error within BF16_FACTOR times plain bf16's,
    and the task's effect over the backbone carried within CARRY_TOL."""
    base = torch.tensor([[1.0, 0.5, -0.25, 0.0]] * 2)
    ref = base + torch.tensor([[0.0, 0.5, 0.0, -0.5], [0.2, 0.0, 0.2, 0.0]])
    plain = ref + torch.tensor([[0.04, 0.0, -0.01, 0.0]])
    res = cs.against_float32(ref + 0.07, plain, ref, base, [0, 1])
    assert res["ok"] and set(res["tasks"]) == {0, 1}
    assert res["tasks"][1]["carried"] == pytest.approx(1.0)   # a row shift
    assert res["tasks"][0]["carried_plain"] == pytest.approx(1.0)
    off = ref + torch.tensor([[0.0, 0.09, 0.0, 0.0], [0.0] * 4])
    res = cs.against_float32(off, plain, ref, base, [0, 1])
    assert not res["ok"] and cs.rejected(res) == {0}
    assert res["tasks"][0]["plain_err"] == pytest.approx(0.04)
    assert res["tasks"][0]["served_err"] == pytest.approx(0.09)
    # task 1 without its table: every logit within 2 x 0.04 of float32's
    # (its effect is 0.2), but none of the effect carried
    res = cs.against_float32(torch.stack([ref[0], base[1]]), plain + 0.1 *
                             torch.tensor([[0.0] * 4, [1.0] * 4]), ref,
                             base, [0, 1])
    assert cs.rejected(res) == {1}
    assert res["tasks"][1]["served_err"] <= 2 * res["tasks"][1]["plain_err"]
    assert res["tasks"][1]["carried"] == pytest.approx(0.0)


def test_phase7c_controls_are_rejected():
    """``control_serves`` over two tasks' tables, each served as the
    backbone's logits plus its task's slot of the stacked tables: the
    true serve passes, each control fails in exactly its wrong tasks."""
    g = torch.Generator().manual_seed(0)
    V, task_ids = 64, [0, 1, 1, 0, 1]
    fc = 0.03 * torch.randn(1, V, 1, generator=g)     # a small effect
    kron = 0.5 * torch.randn(1, V, 1, generator=g)
    tables = [{"table": fc}, {"table": kron}]
    base = torch.randn(len(task_ids), V, generator=g)

    def serve(stacked, noise):
        return torch.stack([base[i] + stacked[0, t, :, 0]
                            for i, t in enumerate(task_ids)]) + noise
    ref = serve(torch.stack([fc, kron], 1), 0.0)
    plain = ref + 0.02 * torch.randn(ref.shape, generator=g)
    served = ref + 0.02 * torch.randn(ref.shape, generator=g)
    assert cs.against_float32(served, plain, ref, base, task_ids)["ok"]
    seen = {}
    for name, stacked, wrong in cs.control_serves(tables):
        res = cs.against_float32(serve(stacked["table"], served - ref),
                                 plain, ref, base, task_ids)
        seen[name] = (cs.rejected(res), wrong)
    assert seen == {"fc_zeroed": ({0}, {0}), "swapped": ({0, 1}, {0, 1})}


# ---------------------------------------------------------------------------
# phase 8: the paper's encoders
# ---------------------------------------------------------------------------

@pytest.fixture()
def encoder_kernels(monkeypatch):
    """chip_smoke on the CPU at reduced size: ``DEV`` the CPU, the card's
    waits no-ops, the wrappers on their kernel branch (so they count) with
    the plain versions standing in for the kernels, the configs reduced."""
    from repro_torch import configs
    from repro_torch.kernels import aot_bias, ops
    from repro_torch.kernels import flash_attention as fa
    monkeypatch.setattr(cs, "DEV", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(ops, "_on_cpu", lambda *xs: False)
    for name, fn in (("aot_gather_add_kernel", aot_bias.aot_gather_add_plain),
                     ("aot_gather_add_multitask_kernel",
                      aot_bias.aot_gather_add_multitask_plain),
                     ("flash_attention_kernel", fa.flash_attention_plain)):
        monkeypatch.setattr(ops, name, fn)
    get = configs.get
    monkeypatch.setattr(configs, "get",
                        lambda name: configs.reduced(get(name), repeats=2))
    yield
    ops.reset_launches()


def test_phase8_launch_arithmetic(encoder_kernels):
    """One logits call of a reduced roberta-large launches what
    ``encoder_launches`` says for every method of 8a: a flash attention
    per layer, a plain gather-add per layer with AoT (the multi-task entry
    for the mixed batch), no norm kernel; a stray launch fails the gate."""
    model, params = cs.encoder_model("roberta-large")
    L = model.cfg.num_layers
    tables = cs.stacked_tables(model.cfg, params["embed"]["tok"],
                               cs.ENC_TASKS)
    toks = torch.randint(0, model.cfg.vocab_size, (3, 20),
                         generator=torch.Generator().manual_seed(0))
    setups = cs.encoder_setups(model, params, tables, 3,
                               torch.Generator().manual_seed(1))
    assert tuple(setups) == cs.ENC_METHODS
    for label, (p, bd) in setups.items():
        with torch.no_grad():
            _, counts = cs.counted_logits(model, p, toks, bd, label)
        assert {k: v for k, v in counts.items() if v} == \
            cs.encoder_launches(L, label)
    assert cs.encoder_launches(24, "aot") == {"flash_attention": 24,
                                              "aot_gather_add": 24}
    assert cs.encoder_launches(48, "none") == {"flash_attention": 48}
    with pytest.raises(AssertionError, match="rms_norm launched 1"):
        cs.check_launches("8", dict(cs.encoder_launches(L, "none"),
                                    rms_norm=1),
                          cs.encoder_launches(L, "none"))
    assert set(cs.ENC_PATH) <= {"flash_attention", "aot_gather_add",
                                "aot_gather_add_multitask"}
    assert all(path[len("enc_roberta_"):] in cs.ENC_METHODS
               for path in cs.ENC_PATH.values())


def test_phase8_multitask_all_zero_is_bitwise_single(encoder_kernels,
                                                     monkeypatch):
    """8a's rule on the plain path: the multi-task batch with every task
    id 0 gives the single-table call's logits bit for bit; a multi-task
    gather that strays by one bf16-sized step fails it."""
    from repro_torch.kernels import ops
    model, params = cs.encoder_model("roberta-large")
    tables = cs.stacked_tables(model.cfg, params["embed"]["tok"], 3)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert cs.multitask_equals_single(model, params, tables, toks)
        real = ops.aot_gather_add_multitask_kernel
        monkeypatch.setattr(ops, "aot_gather_add_multitask_kernel",
                            lambda *a, **kw: real(*a, **kw) + 2 ** -8)
        assert not cs.multitask_equals_single(model, params, tables, toks)


def test_phase8_served_classifier_gate_rejects_the_zeroed_table(
        encoder_kernels):
    """8d's gate on a reduced roberta-large: a fused task with a head,
    served through the kernel path in bf16, against the float32 function
    (``against_float32``): the true table passes, the zeroed control is
    rejected; the served calls launch ``encoder_launches`` per batch."""
    from repro_torch.core import aot as aot_mod
    from repro_torch.core import peft as P
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model, ModelOptions
    model, params16 = cs.encoder_model("roberta-large")
    cfg, dt = model.cfg, torch.bfloat16
    ref32 = Model(cfg, ModelOptions(attn_impl="ref"), device="cpu")
    ref16 = Model(cfg, ModelOptions(dt, dt, attn_impl="ref"), device="cpu")
    params = ref32.init(0)
    params16 = cs.cast_backbone(params, dt)
    assert params16["layers"][0]["ln1"]["bias"].dtype == torch.float32
    assert params16["layers"][0]["mlp"]["b1"].dtype == dt
    g = torch.Generator().manual_seed(3)
    table = aot_mod.random_fused(cfg, params["embed"]["tok"], seed=1,
                                 scale=0.5)["table"]
    head = {"w": torch.randn(cfg.d_model, 2, generator=g),
            "b": torch.zeros(2)}
    fopt = P.PEFTOptions(method="aot", num_classes=2,
                         aot=P.AoTOptions(mode="fused"))
    bundle = P.make({"aot": {"table": table}, "head": head}, fopt)
    batches = [torch.randint(0, cfg.vocab_size, (8, 24), generator=g)
               for _ in range(3)]
    with torch.no_grad():
        ops.reset_launches()
        served = cs.classify_rows(model, params16, batches, P.make(
            {"aot": {"table": table.to(dt)}, "head": head}, fopt))
        counts = {k: v for k, v in ops.launches().items() if v}
        plain16 = cs.classify_rows(ref16, params16, batches, bundle)
        lg_32 = cs.classify_rows(ref32, params, batches, bundle)
        lg_0 = cs.classify_rows(ref32, params, batches, P.make(
            {"head": head}, P.PEFTOptions(method="none", num_classes=2)))
        zero = cs.classify_rows(model, params16, batches, P.make(
            {"aot": {"table": torch.zeros_like(table, dtype=dt)},
             "head": head}, fopt))
    assert counts == {k: 3 * v for k, v in cs.encoder_launches(
        cfg.num_layers, "aot").items()}
    ids = [0] * served.shape[0]
    assert cs.against_float32(served, plain16, lg_32, lg_0, ids)["ok"]
    ctl = cs.against_float32(zero, plain16, lg_32, lg_0, ids)
    assert cs.rejected(ctl) == {0}
    assert abs(ctl["tasks"][0]["carried"]) < 0.1


# ---------------------------------------------------------------------------
# phase 9: the lifecycle across processes
# ---------------------------------------------------------------------------

def _overload(monkeypatch, tmp_path, label):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    return cs.overload_run(FakeEngine(), cs.overload_args(label, tmp_path))


@pytest.mark.parametrize("label", sorted(cs.OVERLOAD_RUNS))
def test_phase9c_replay_fixes_every_count(monkeypatch, tmp_path, label):
    """The card's schedule of each 9c run (the launcher's overload flags
    on phase 5's engine) is the replay's: its counts are
    OVERLOAD_EXPECT's and every gate holds (no kernel runs here)."""
    run = _overload(monkeypatch, tmp_path, label)
    assert run["counts"] == cs.OVERLOAD_EXPECT[label]
    assert cs.overload_failures(label, run, 0) == []


def test_phase9c_runs_exercise_what_they_gate(monkeypatch, tmp_path):
    """Each run sheds both ways, retries, misses deadlines and leaves work
    for the drain to shed; one gives up; the bursty run's gap is derived
    from --rate (bursts of 6 every 12 ticks); the class column of the
    trace is what the requests carry where it is given."""
    for label, c in cs.OVERLOAD_EXPECT.items():
        assert set(c["sheds"]) == {"displaced", "queue_full"}, label
        assert c["retries"] > 0 and c["deadline_misses"] > 0, label
        assert c["aborted"]["shutdown"] == c["drain_shed"] > 0, label
        assert c["drain_grace_used"] == 8, label
    assert max(c["gave_up"] for c in cs.OVERLOAD_EXPECT.values()) >= 1
    from repro_torch.launch import serve as launcher
    args = cs.overload_args("bursty", tmp_path)
    assert launcher.burst_gap(args) == 12
    ticks = [t for t, _ in launcher.make_arrivals(args, 49152, 4)]
    assert ticks[0] <= 1 and ticks[6] >= 12 and ticks[12] >= 24
    args = cs.overload_args("trace_classes", tmp_path)
    named = [line.split(",")[1] if "," in line else None
             for line in cs.OVERLOAD_TRACES["trace_classes"].splitlines()
             if not line.startswith("#")]
    got = [r.priority for _, r in launcher.make_arrivals(args, 49152, 4)]
    assert all(n is None or n == g for n, g in zip(named, got))
    assert {g for n, g in zip(named, got) if n is None} >= {"standard"}
    reqs = [r for _, r in launcher.make_arrivals(args, 49152, 4)]
    assert {r.deadline_ticks for r in reqs if r.priority == "latency"} \
        == {24}
    assert {r.deadline_ticks for r in reqs if r.priority != "latency"} \
        == {None}


def test_phase9c_gates_name_each_failure(monkeypatch, tmp_path):
    run = _overload(monkeypatch, tmp_path, "trace_classes")
    run["counts"]["retries"] += 1
    lost = min(run["sched"].finished)
    run["sched"].finished.pop(lost)
    run["launches"]["ragged_paged_attention"] = 1
    run["drain"].leak_findings.append("page 3 leaked")
    bad = cs.overload_failures("trace_classes", run, 0)
    assert any("'retries': (5, 4)" in b for b in bad)
    assert any(b == f"unaccounted requests [{lost}]" for b in bad)
    assert any("page 3 leaked" in b for b in bad)
    assert any("ragged_paged_attention launched 1 times" in b for b in bad)


def test_phase9a_bitwise_tree_comparison():
    a = {"trainable": {"w": torch.arange(6.0).reshape(2, 3),
                       "e": torch.ones(3, dtype=torch.bfloat16)},
         "step": 30}
    b = {"trainable": {"w": a["trainable"]["w"].clone(),
                       "e": a["trainable"]["e"].clone()}, "step": 30}
    assert cs.tree_bits_equal(a, b) == [] and cs.max_leaf_diff(a, b) == 0
    b["trainable"]["w"][1, 2] += 1e-6
    b["step"] = 29
    assert cs.tree_bits_equal(a, b) == [0, 2]      # jax's order: keys sorted
    assert cs.max_leaf_diff(a, b) == pytest.approx(1e-6, rel=0.1)
    b["trainable"]["w"] = b["trainable"]["w"].double()
    assert 2 in cs.tree_bits_equal(a, b)
    assert cs.tree_bits_equal(a, {"trainable": a["trainable"]}) == \
        ["structure"]


def test_phase9a_resume_across_processes_on_the_cpu(monkeypatch, tmp_path):
    """9a end to end on the CPU at reduced widths: two launcher processes
    (2 steps, then resumed to 3) give 7a's in-process state bitwise, and a
    state saved and restored in process is bitwise; a state the processes
    did not reach fails the gate."""
    from repro_torch.launch import train as trainer
    flags = ["--device", "cpu", "--reduced"]
    monkeypatch.setattr(cs, "DEV", "cpu")
    monkeypatch.setattr(cs, "RESUME_FLAGS", flags)
    monkeypatch.setattr(cs, "RESUME_STEPS", (2, 3))
    monkeypatch.setattr(cs, "LIFECYCLE_DIR", tmp_path)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    args = trainer.parser().parse_args(flags + ["--steps", "3"])
    t = trainer.build(args)
    trainer.train(t, args)
    report = {}
    cs.resume_across_processes(report, t.state)
    r = report["resume"]
    assert r["not_bitwise"] == [] and r["round_trip_not_bitwise"] == []
    assert r["steps_kept"] == [2, 3] and r["final_step"] == 3
    assert r["bytes"] > 0 and r["failures"] == []
    assert not (tmp_path / "resume").exists()



# ---------------------------------------------------------------------------
# phase 10: a stream's tokens against its prompts served alone
# ---------------------------------------------------------------------------

def _alone_logits(n, v=6, top=None):
    """(n, v) logits whose argmax is token 0 with a margin of 1, row ``j``
    of ``top`` = {j: (token, gap)} instead putting ``token`` that far
    below the argmax."""
    lgs = torch.zeros(n, v)
    lgs[:, 0] = 1.0
    for j, (tok, gap) in (top or {}).items():
        lgs[j, tok] = 1.0 - gap
    return lgs


@pytest.mark.parametrize("got,top,want", [
    ([0, 0, 0], None, None),
    ([0, 3, 5], {1: (3, 0.03)}, (1, 0.03, True)),    # a near tie
    ([0, 3, 5], {1: (3, 0.09)}, (1, 0.09, False)),   # past two tolerances
    ([4, 0, 0], None, (0, 1.0, False)),
    ([0, 0], None, (2, float("inf"), False))])       # a short stream
def test_phase10_divergence_rule(got, top, want):
    """The first differing token is a near tie when the alone run's logit
    gap there is within two LOGIT_TOL tolerances at the top logit (2e-2 +
    2e-2 x 1 each); tokens past it are not compared; a stream of another
    length diverges."""
    res = cs.divergence(got, [0, 0, 0], _alone_logits(3, top=top))
    if want is None:
        assert res is None
    else:
        assert res[0] == want[0] and res[2] == want[2]
        assert res[1] == pytest.approx(want[1])


def test_phase10_stream_vs_alone_on_a_reduced_ring(monkeypatch):
    """``stream_vs_alone`` on a reduced danube slots stream served on the
    CPU (window 8, prompts of 9-15 in buckets of 16: the C7 case): every
    request's tokens equal its prompt's served alone."""
    from repro_torch import configs
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.scheduler import (ContinuousScheduler, Request,
                                             SchedulerConfig)
    import numpy as np
    cfg = configs.reduced(configs.get("h2o-danube-1.8b"), repeats=2).replace(
        sliding_window=8)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    tables = torch.randn(cfg.num_layers, 2, cfg.vocab_size, cfg.d_model) * 0.02
    engine = ServeEngine(model, params, ServeConfig(max_len=40),
                         fused_tasks={"table": tables})
    monkeypatch.setattr(cs, "DEV", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    rng = np.random.default_rng(1)
    sched = ContinuousScheduler(engine, SchedulerConfig(
        kv_layout="slots", num_slots=2, bucket_min=16))
    for i in range(4):
        sched.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, int(rng.integers(9, 16))).astype(np.int32),
            task_id=i % 2, max_new_tokens=int(rng.integers(4, 12))))
    sched.run()
    equal, ties, bad = cs.stream_vs_alone(engine, sched.finished)
    assert (equal, ties, bad) == (4, [], [])


# ---------------------------------------------------------------------------
# phase 11: the mixture-of-experts decoders
# ---------------------------------------------------------------------------

def _rank(experts, probs):
    return (torch.tensor(experts), torch.tensor(probs))


@pytest.mark.parametrize("a,b,want", [
    (_rank([3, 1, 2], [0.5, 0.3, 0.2]), _rank([3, 1, 2], [0.5, 0.3, 0.2]),
     0.0),
    # the 2nd and 3rd swap, each within 5% of the other's 2nd probability
    (_rank([3, 1, 2], [0.5, 0.25, 0.24]), _rank([3, 2, 1], [0.5, 0.25, 0.24]),
     0.04),
    # the other run's 2nd was this run's 3rd, 40% below
    (_rank([3, 1, 2], [0.5, 0.3, 0.18]), _rank([3, 2, 1], [0.5, 0.3, 0.18]),
     0.4),
    # an expert outside the other run's recorded ranks
    (_rank([3, 1, 2], [0.5, 0.3, 0.2]), _rank([3, 0, 2], [0.5, 0.3, 0.2]),
     1.0)])
def test_phase11_route_gap(a, b, want):
    """``route_gap`` at k = 2: 0 for equal sets; else the largest shortfall
    of a swapped expert's probability in the other run below that run's
    k-th, 1.0 when it is not among the other's recorded ranks. A router
    near tie is a gap within MOE_ROUTE_TIE (0.1)."""
    assert cs.route_gap(a, b, 2) == pytest.approx(want, abs=1e-6)
    assert (cs.route_gap(a, b, 2) <= cs.MOE_ROUTE_TIE) == (want <= 0.1)


def test_phase11_route_drops_split_ticks_and_live_tokens():
    """Two MoE layers; a chunk tick of 4 tokens (the last 2 dead, and
    dropped in layer 0), then a decode-only tick of 2 tokens: the chunk
    tick drops 1 / 8 of all assignments and none of the live ones."""
    keep = lambda rows: {"keep": torch.tensor(rows), "tokens": len(rows)}
    routes = [keep([[True], [True], [False], [False]]),
              keep([[True]] * 4), keep([[True]] * 2), keep([[True]] * 2)]
    live = [[True, True, False, False], [True, True]]
    got = cs.route_drops(routes, 2, live, decode_T=2)
    assert got["chunk"]["ticks"] == got["decode"]["ticks"] == 1
    assert got["chunk"]["max"] == pytest.approx(0.25)
    assert got["chunk_live"]["max"] == 0.0 and got["decode"]["max"] == 0.0


def test_phase11_on_reduced_moe_configs(monkeypatch):
    """Phase 11 on the CPU at reduced widths (qwen3-moe and llama4 at 4
    experts, their capacity factor set back to 1.25, phase 5's stream cut
    to short prompts): every gate of 11a-11c runs and passes, launches are
    exact, the drop-free stream equals each prompt served alone, nothing
    drops on a decode-only tick and the padding placed first displaces
    live rows at 1.25."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels import aot_bias, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    monkeypatch.setattr(cs, "DEV", "cpu")
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(ops, "_on_cpu", lambda *xs: False)
    for name, fn in (
            ("aot_gather_add_multitask_kernel",
             aot_bias.aot_gather_add_multitask_plain),
            ("rms_norm_kernel", aot_bias.rms_norm_plain),
            ("flash_attention_kernel", fa.flash_attention_plain),
            ("decode_attention_kernel", da.decode_attention_plain),
            ("paged_decode_attention_kernel",
             da.paged_decode_attention_plain),
            ("ragged_paged_attention_kernel",
             lambda q, k, v, bt, r, p, plan=None:
             da.ragged_paged_attention_plain(q, k, v, bt, r, p))):
        monkeypatch.setattr(ops, name, fn)
    get = configs.get

    def reduced(name):
        cfg = configs.reduced(get(name), repeats=4)
        return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                   capacity_factor=1.25))
    monkeypatch.setattr(configs, "get", reduced)
    base = list(cs.BASE)
    base[base.index("--prompt") + 1] = "40"
    base[base.index("--steps") + 1] = "6"
    monkeypatch.setattr(cs, "BASE", base)
    parts = {k: dict(v, requests=6, static=(2, 16, 3), layers=v["layers"]
                     and 2) for k, v in cs.MOE_PARTS.items()}
    monkeypatch.setattr(cs, "MOE_PARTS", parts)
    monkeypatch.setattr(cs, "MOE_ROUTING", (2, 16))
    monkeypatch.setattr(cs, "MOE_PAGED_STATIC", (2, 16, 3))
    monkeypatch.setattr(cs, "MOE_CHECK_STATIC", (4, 8, 2))
    report, threads = {}, torch.get_num_threads()
    torch.set_num_threads(1)        # six tier-1 workers share the cores
    try:
        launches = cs.phase_moe(report)
    finally:
        torch.set_num_threads(threads)
        ops.reset_launches()
    moe = report["moe"]
    assert set(launches) == {"moe_qwen3moe_paged",
                             "moe_qwen3moe_paged_dropfree",
                             "moe_qwen3moe_static",
                             "moe_qwen3moe_static_paged", "moe_llama4_paged",
                             "moe_llama4_static"}
    q = moe["qwen3moe"]
    assert q["failures"] == [] and q["dropfree"]["divergences"] == []
    assert q["dropfree"]["stream_equal"] == q["requests"] == 6
    assert q["drops"]["decode"]["max"] == 0.0
    assert moe["cross_check"]["padding"]["config"]["displaced"] > 0


# ---------------------------------------------------------------------------
# phase 13: the front-ends; phase 5d's P-Tuning v1 launches
# ---------------------------------------------------------------------------

def test_phase13_on_reduced_frontends(monkeypatch):
    """Phase 13 on the CPU at reduced widths (paligemma-3b and
    hubert-xlarge with 2 layers, a prefix of 4 patches, 4 x (4 + 12) + 5
    steps, frames 2 x 24): every gate of 13a and 13b runs and passes, the
    launches are exact (the prefix through attention_chunked, no flash in
    paligemma's prefill; P-Tuning v1's on hubert likewise), and a stray
    launch or a missing chunked call fails the launch arithmetic."""
    from repro_torch import configs
    from repro_torch.kernels import aot_bias, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    monkeypatch.setattr(cs, "DEV", "cpu")
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cs, "wall_ms", lambda fn, iters, warmup=3: (
        fn(0), 1.0)[1])
    monkeypatch.setattr(cs, "profile_of", lambda fn, steps: dict(
        device_busy_ms=1.0, kernels_per_step=1.0))
    monkeypatch.setattr(ops, "_on_cpu", lambda *xs: False)
    for name, fn in (
            ("aot_gather_add_kernel", aot_bias.aot_gather_add_plain),
            ("aot_gather_add_multitask_kernel",
             aot_bias.aot_gather_add_multitask_plain),
            ("rms_norm_kernel", aot_bias.rms_norm_plain),
            ("flash_attention_kernel", fa.flash_attention_plain),
            ("decode_attention_kernel", da.decode_attention_plain)):
        monkeypatch.setattr(ops, name, fn)
    get = configs.get
    monkeypatch.setattr(configs, "get",
                        lambda name: configs.reduced(get(name), repeats=2))
    monkeypatch.setattr(cs, "PALI", dict(cs.PALI, static=(4, 12, 5)))
    monkeypatch.setattr(cs, "PALI_CHECK_STEPS", (0, 2, 4))
    monkeypatch.setattr(cs, "HUBERT", dict(cs.HUBERT, frames=(2, 24),
                                           max_pos=64))
    report, threads = {}, torch.get_num_threads()
    torch.set_num_threads(1)        # six tier-1 workers share the cores
    try:
        with torch.no_grad():
            launches = cs.phase_frontends(report)
    finally:
        torch.set_num_threads(threads)
        ops.reset_launches()
    front = report["frontends"]
    assert front["paligemma"]["failures"] == []
    assert front["hubert"]["failures"] == []
    assert front["paligemma"]["mixed_equal"] + len(
        front["paligemma"]["near_ties"]) == 4
    nonzero = lambda c: {k: v for k, v in c.items() if v}
    assert nonzero(launches["front_pali_prefill"]) == {
        "aot_gather_add_multitask": 2, "chunked": 2}
    assert nonzero(launches["front_pali_decode"]) == {
        "aot_gather_add_multitask": 10, "decode_attention": 10}
    for label in cs.HUBERT_METHODS:
        assert nonzero(launches[f"front_hubert_{label}"]) == \
            cs.encoder_launches(2, label)
    assert set(cs.FRONT_PATH.values()) <= set(launches)
    assert cs.encoder_launches(48, "ptv1") == {"chunked": 48}
    assert cs.logits_launches(32, "ptv1") == {"chunked": 32, "rms_norm": 32}
    assert cs.logits_launches(32, "aot") == {"flash_attention": 32,
                                             "aot_gather_add": 32}
    with pytest.raises(AssertionError, match="flash_attention launched 1"):
        cs.check_launches("13", dict(cs.encoder_launches(2, "ptv1"),
                                     flash_attention=1),
                          cs.encoder_launches(2, "ptv1"))


# ---------------------------------------------------------------------------
# phase 14: distribution on a one-rank mesh, run here on gloo at reduced
# widths with the same functions and gates
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank_mesh():
    import torch.distributed as dist
    mesh = cs.dist_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def _reduced(name, **moe):
    from repro_torch import configs
    cfg = configs.reduced(configs.get(name), repeats=2)
    if moe:
        import dataclasses
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


def test_phase14a_sharded_logits_on_cpu(one_rank_mesh):
    cfg = _reduced("smollm-360m")
    err, plain, sharded, placed = cs.sharded_logits(
        one_rank_mesh, cfg, torch.float32, "cpu", batch=(4, 16))
    assert cs.sharded_logits_gate(err, 2e-5, plain, sharded, cfg.num_layers,
                                  on_card=False) == []
    # a mesh dim of size 1 holds every dim whole
    assert err == 0.0 and placed == "(Replicate(), Replicate())"


def test_phase14a_gate_names_each_failure():
    want = {"flash_attention": 32, "aot_gather_add_multitask": 32,
            "rms_norm": 0}
    assert cs.sharded_logits_gate(0.0, 2e-2, want, dict(want), 32,
                                  on_card=True) == []
    fails = cs.sharded_logits_gate(0.5, 2e-2, want,
                                   dict(want, flash_attention=31), 32, True)
    assert len(fails) == 2 and "max err" in fails[0]
    fails = cs.sharded_logits_gate(float("nan"), 2e-2, dict(want, rms_norm=1),
                                   dict(want, rms_norm=1), 32, True)
    assert len(fails) == 2 and "unsharded launches" in fails[1]


def test_phase14b_e_train_mesh_and_reshard_on_cpu(one_rank_mesh, tmp_path):
    argv = ["--arch", "smollm-360m", "--reduced", "--method", "aot",
            "--rank", "8", "--steps", "3", "--seq", "32", "--batch", "4"]
    runs = cs.train_mesh_vs_plain("1x1", argv, "cpu", tmp_path)
    err, bitwise, fails = cs.train_gate(runs)
    assert fails == [] and len(runs["mesh"][0]) == 3
    assert err <= 2e-5
    assert cs.reshard_round_trip(runs["mesh"][2], one_rank_mesh,
                                 tmp_path / "reshard") == []


def test_phase14b_gate():
    t = {"w": torch.ones(3)}
    same = {"mesh": ([1.0, 0.5], t, None), "plain": ([1.0, 0.5], t, None)}
    assert cs.train_gate(same) == (0.0, True, [])
    off = {"mesh": ([1.0, 0.5], {"w": torch.ones(3) + 1e-3}, None),
           "plain": ([1.0, 0.5], t, None)}
    err, bitwise, fails = cs.train_gate(off)
    assert not bitwise and len(fails) == 1 and err > 1e-4
    assert cs.train_gate({"mesh": ([], t, None), "plain": ([1.0], t, None)}
                         )[2]


def test_phase14c_expert_parallelism_on_cpu(one_rank_mesh):
    cfg = _reduced("qwen3-moe-30b-a3b", num_experts=8, top_k=2,
                   capacity_factor=8.0)
    err, close, scale, finite, *dropped = cs.ep_vs_gspmd(
        one_rank_mesh, cfg, torch.float32, "cpu", x_shape=(2, 16))
    assert cs.ep_gate(err, close, finite, tuple(dropped)) == []
    assert err <= 2e-5 < scale
    assert len(cs.ep_gate(1.0, False, False, (0.0, 0.5))) == 3


def test_phase14d_compressed_all_reduce_on_cpu(one_rank_mesh):
    assert cs.compressed_vs_rounding("cpu") == []


def test_phase3_softcap_cases_run_on_the_cpu():
    """Phase 3's softcap line: every case runs (its CUDA-vs-CPU gate is
    0 here, the same device twice), and the cap changes each output."""
    gen = torch.Generator().manual_seed(0)
    cases = cs.softcap_cases("cpu", gen)
    assert set(cs.softcap_errors(cases).values()) == {0.0}
    uncapped = cs.softcap_cases("cpu", torch.Generator().manual_seed(0),
                                cap=0.0)
    for name, (fn, xs) in cases.items():
        off = uncapped[name][0](*uncapped[name][1])
        assert float((fn(*xs) - off).abs().max()) > 1e-3, name


def test_c4_watch_records_each_rows_writer(monkeypatch, tmp_path):
    """ROADMAP C4's KVWatch on the replayed sampled_n4 crash run and the
    same stream uncrashed: in the uncrashed run a forked sample's own
    rows come from the split walk and its prompt rows from the parent's
    chunk tiles; after the crash each restored sample re-prefills its
    rows in tiles of 16 from position 0. With no model every row's bits
    agree, so kv_divergence finds none."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(cs, "DEV", "cpu")
    extra, crash_at = cs.CRASH_RUNS["sampled_n4"]
    watches = []
    for i, at in enumerate((crash_at, 0)):
        w = cs.KVWatch()
        cs.restore_run(FakeEngine(), extra, tmp_path / f"{i}.jsonl",
                       cs.serve_crashing(at), at or None, w)
        watches.append(w)
    crash, twin = watches
    assert len(twin.hashes) == len(crash.hashes) == 16
    assert twin.writer_of("0:2", 0) == "tile@0 (0:0)"
    assert twin.writer["0:2"][max(twin.writer["0:2"])] == "split walk"
    assert min(twin.writer["0:2"]) > 0          # its prompt is the parent's
    assert crash.writer_of("0:2", 40) == "tile@32 (0:2)"
    assert cs.kv_divergence(twin, crash, "0:2") is None
