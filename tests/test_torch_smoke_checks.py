"""The pure-Python gates of the port's card scripts, on the CPU: phase 2's
check of the redesigned kernels' ptxas output (flash_mma_kernel,
decode_split_kernel, ragged_split_kernel, aot_gather_add_kernel), phase
6's comparison of kernel logits with the plain versions' (near ties), and
phase 6's swap of the kernel wrappers in ``ops`` for the plain versions.
The phases themselves need the card (chip_smoke.py)."""

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
    """The engine's serving interface without a model: a tick's tokens
    are zeros, an armed fault acts as ``ServeEngine.inject_fault`` says,
    and the block-table check runs as in ``serve_step`` (the scheduler
    itself checks the write-fresh rule). Phase 5's scheduling
    does not depend on the tokens (no stop or end token), so this replays
    the card's schedule exactly."""

    def __init__(self):
        from types import SimpleNamespace
        self.cfg = SimpleNamespace(max_len=cs.MAX_LEN)
        self.model = SimpleNamespace(
            cfg=SimpleNamespace(vocab_size=49152),
            init_paged_cache=lambda nb, bs: {
                n: torch.zeros(1, nb, bs, 1, 1) for n in ("k", "v")})
        self.num_tasks, self.peft = 4, None
        self.dispatches, self._pending_fault = 0, None

    def inject_fault(self, kind, slot=-1):
        self._pending_fault = (kind, slot)

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
        self.dispatches += 1
        return np.zeros(len(logit_idx), np.int32), None, cache, finite


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
