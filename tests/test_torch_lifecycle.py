"""The paper's lifecycle across processes in the port, held against the
JAX reference on the CPU: training broken at a step and resumed from a
checkpoint (``TrainLoop.resume`` / ``run(start_step=)``, and the training
launcher's ``--ckpt-dir`` run twice) bitwise the unbroken run; the
reference's training checkpoint continued by the port; the fused-table
export and ``launch.serve --load`` on tables either manager wrote, served
to the reference launcher's tokens; and the launcher's overload flags
(``--arrivals bursty``, ``--burst``, ``--burst-gap``, ``--arrival-trace``,
``--deadline-ticks``, ``--max-retries``, ``--backoff``, ``--grace-ticks``)
drawing the reference's requests and giving its retries, gave-up list
and drain report."""
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from port_util import both_sides, jax_tasks, port_lm, port_tables
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import aot as JA
from repro.core import peft as JP
from repro.launch import serve as jlaunch
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions as JOpts
from repro.serve import scheduler as jsched
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import loop as jloop
from repro.train import step as JS
from repro_torch import bridge, configs
from repro_torch import tree as T
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import LMStream
from repro_torch.launch import export as exporter
from repro_torch.launch import serve as launcher
from repro_torch.launch import train as trainer
from repro_torch.models.model import Model, ModelOptions
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.train import loop as ploop
from repro_torch.train import step as PS

REDUCED = ["--device", "cpu", "--reduced"]


def _bits(a, b):
    """Two trees of tensors / ints equal bit for bit, leaf by leaf."""
    la, lb = T.sorted_leaves(a), T.sorted_leaves(b)
    assert T.structure(a) == T.structure(b) and len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y and type(x) is type(y)


# ---------------------------------------------------------------------------
# training: broken, checkpointed, resumed
# ---------------------------------------------------------------------------

def _trainer(mode, steps):
    args = trainer.parser().parse_args(REDUCED + [
        "--steps", str(steps), "--aot-mode", mode, "--rank", "4", "--seq",
        "16", "--batch", "4"])
    return trainer.build(args), args


def _loop(t, args, ckpt=None, every=2):
    return ploop.TrainLoop(train_step=t.train_step, frozen=t.frozen,
                           stream=trainer.lm_stream(args, t.model.cfg
                                                    .vocab_size),
                           ckpt=ckpt, ckpt_every=every, log_every=1,
                           device="cpu")


@pytest.mark.parametrize("mode", ["fc", "kron"])
def test_resumed_run_is_the_unbroken_run_bitwise(tmp_path, mode):
    """Steps 0-2, a checkpoint (async writer), a fresh trainer (a new
    process's state) resumed to step 6: parameters, AdamW's mu, nu and
    step, the step counter and the stream's cursor are the unbroken
    run's bit for bit, and so is every step's loss."""
    t, args = _trainer(mode, 6)
    whole = _loop(t, args)
    want = whole.run(t.state, 6)
    t, _ = _trainer(mode, 6)
    first = _loop(t, args, CheckpointManager(str(tmp_path), keep=2))
    first.run(t.state, 3)
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3]
    t, _ = _trainer(mode, 6)
    again = _loop(t, args, CheckpointManager(str(tmp_path), keep=2))
    state, start = again.resume(t.state)
    assert start == 3 and again.events == [{"kind": "resume", "step": 3}]
    got = again.run(state, 6, start_step=start)
    _bits(got, want)
    assert type(got["opt"].step) is int and got["opt"].step == 6
    assert again.stream.state() == whole.stream.state()
    assert [h["loss"] for h in first.history + again.history] == \
        [h["loss"] for h in whole.history]
    assert CheckpointManager(str(tmp_path)).all_steps() == [4, 6]


def _npz(path):
    with np.load(path) as z:
        return {k: (z[k].dtype.str, z[k].tobytes()) for k in z.files}


def test_launcher_ckpt_dir_twice_is_one_run(tmp_path, capsys):
    """``--steps 4`` then ``--steps 6`` into one ``--ckpt-dir`` writes the
    step-6 checkpoint of a single 6-step run, byte for byte."""
    flags = REDUCED + ["--rank", "4", "--seq", "16", "--batch", "4"]
    for steps, d in ((4, "split"), (6, "split"), (6, "whole")):
        assert trainer.main(flags + ["--steps", str(steps), "--ckpt-dir",
                                     str(tmp_path / d)]) == 0
    out = capsys.readouterr().out
    assert "events: [{'kind': 'resume', 'step': 4}]" in out
    split = tmp_path / "split" / "smollm-360m"
    whole = tmp_path / "whole" / "smollm-360m"
    assert CheckpointManager(str(split)).all_steps() == [4, 6]
    for name in ("manifest.json", "extra.json"):
        assert (split / "step_0000000006" / name).read_bytes() == \
            (whole / "step_0000000006" / name).read_bytes()
    assert _npz(split / "step_0000000006" / "arrays.npz") == \
        _npz(whole / "step_0000000006" / "arrays.npz")


def test_reference_checkpoint_continues_in_the_port(tmp_path, tiny_lm):
    """The reference's TrainLoop trains AoT fc 3 steps and checkpoints;
    the port resumes that checkpoint and trains to step 6, the reference
    too: parameters within test_torch_train's 1e-5, equal step counters
    and stream cursors, losses within 1e-5 relative."""
    cfg, _, params = tiny_lm
    popt = JP.PEFTOptions(method="aot",
                          aot=JA.AoTOptions(mode="fc", rank=4, dropout=0.0))
    pp = jax.device_get(JP.init(jax.random.PRNGKey(1), cfg, popt))
    jinit, jstep = JS.make_train_step(
        JModel(cfg, JOpts(attn_impl="ref", remat=False)),
        JS.TrainConfig(peft=popt, lr=1e-3, loss_chunk=4))
    jstep = jax.jit(jstep)
    jtr, jfr = JS.split_train(params, pp, "aot")
    stream_kw = dict(vocab_size=cfg.vocab_size, seq_len=16, batch_size=4,
                     seed=3)
    from repro.data.pipeline import LMStream as JStream

    def jloop_(d):
        return jloop.TrainLoop(train_step=jstep, frozen=jfr,
                               stream=JStream(**stream_kw),
                               ckpt=JManager(str(d), async_save=False),
                               ckpt_every=3, log_every=1)
    jloop_(tmp_path / "ref").run(jinit(jtr), 3)
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    jl = jloop_(tmp_path / "ref")
    jstate, jstart = jl.resume(jinit(jtr))
    jfinal = jl.run(jstate, 6, start_step=jstart)

    _, pparams = port_lm(tiny_lm)
    model = Model(cfg, ModelOptions(attn_impl="ref"), device="cpu")
    bundle = bridge.peft_from_jax(pp, popt, device="cpu")
    pinit, pstep = PS.make_train_step(model, PS.TrainConfig(
        peft=bundle["opt"], lr=1e-3, loss_chunk=4))
    ptr, pfr = PS.split_train(pparams, bundle["params"], "aot")
    pl = ploop.TrainLoop(train_step=pstep, frozen=pfr,
                         stream=LMStream(**stream_kw),
                         ckpt=CheckpointManager(str(tmp_path / "port")),
                         ckpt_every=3, log_every=1, device="cpu")
    pstate, pstart = pl.resume(pinit(ptr))
    assert pstart == jstart == 3 and pstate["step"] == 3
    pfinal = pl.run(pstate, 6, start_step=pstart)
    assert pfinal["step"] == int(jfinal["step"]) == 6
    assert pfinal["opt"].step == int(jfinal["opt"].step) == 6
    assert pl.stream.state() == jl.stream.state()
    want = jax.tree.leaves(jax.device_get(jfinal["trainable"]))
    got = [x.detach().numpy() for x in T.sorted_leaves(pfinal["trainable"])]
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    for a, b in zip(pl.history, jl.history):
        assert a["step"] == b["step"]
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * b["loss"]


# ---------------------------------------------------------------------------
# export, then serve --load
# ---------------------------------------------------------------------------

def test_export_writes_what_both_loaders_read(tmp_path, capsys,
                                             monkeypatch):
    """The port's export (reduced widths) writes step 1 fc and step
    2 kron in float32, fused bitwise the reparametrization on the CPU; the
    reference's ``load_tasks`` reads them as the port's does. None of that
    depends on how long each mode trains, so 3 steps stand for the
    exporter's 100."""
    monkeypatch.setattr(exporter, "TRAIN_STEPS", 3)
    d = str(tmp_path / "fused")
    assert exporter.main(REDUCED + ["--out", d]) == 0
    assert "fuse_err=0.0e+00" in capsys.readouterr().out
    cfg = configs.reduced(configs.get("smollm-360m"), repeats=2)
    mine = launcher.load_tasks(cfg, d, torch.float32, "cpu")
    theirs = jlaunch.load_tasks(cfg, d)
    assert [t["table"].dtype for t in mine] == [torch.float32] * 2
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a["table"].numpy(), b["table"])
    with pytest.raises(ValueError, match="float32"):
        exporter.export_tasks(d, {"fc": {"table": mine[0]["table"].to(
            torch.bfloat16)}}, cfg.name)


def _write_tables(side, d, cfg, jparams):
    """Two fabricated float32 tasks (the reference's ``random_fused``)
    written by ``side``'s manager as the export does: step 1, step 2."""
    tasks = jax.device_get(jax_tasks(cfg, jparams, 2))
    for s, t in enumerate(tasks, start=1):
        extra = {"mode": "fc", "arch": cfg.name}
        if side == "reference":
            JManager(d, async_save=False).save(s, t, extra=extra)
        else:
            CheckpointManager(d, async_save=False).save(
                s, {"table": torch.from_numpy(np.array(t["table"]))},
                extra=extra)


@pytest.mark.parametrize("side", ["reference", "port"])
def test_serve_load_gives_the_reference_launchers_tokens(
        tmp_path, tiny_lm, monkeypatch, side):
    """``--load`` of tables that ``side``'s manager wrote: the port's
    launcher (the reference's weights carried over) serves every request
    the reference launcher serves with the same tokens."""
    cfg, _, jparams = tiny_lm
    d = str(tmp_path / "tables")
    _write_tables(side, d, cfg, jparams)
    flags = ["--reduced", "--load", d, "--requests", "6", "--rate", "1.5",
             "--prompt", "12", "--steps", "6", "--max-len", "64",
             "--quiet"]
    seen = {}
    run = jlaunch.run_with_retries

    def keep(*a, **kw):
        seen["ref"] = run(*a, **kw)
        return seen["ref"]
    monkeypatch.setattr(jlaunch, "run_with_retries", keep)
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jlaunch.main()
    host = jax.device_get(jparams)

    class RefWeights(launcher.Model):
        def init(self, seed=0):
            return bridge.params_from_jax(self.cfg, host, device="cpu")
    monkeypatch.setattr(launcher, "Model", RefWeights)
    sched = launcher.main(flags + ["--device", "cpu"])
    ref = seen["ref"][3]
    assert sorted(sched.finished) == sorted(ref.finished) == list(range(6))
    assert {r: list(map(int, q.out)) for r, q in sched.finished.items()} \
        == {r: list(map(int, q.out)) for r, q in ref.finished.items()}
    assert sched.engine.num_tasks == 2


def test_load_refuses_an_empty_directory(tmp_path):
    cfg = configs.reduced(configs.get("smollm-360m"), repeats=2)
    with pytest.raises(FileNotFoundError,
                       match="no fused-table checkpoints under"):
        launcher.load_tasks(cfg, str(tmp_path), torch.float32, "cpu")
    with pytest.raises(SystemExit):
        launcher.main(REDUCED + ["--quiet"])     # neither --demo nor --load


# ---------------------------------------------------------------------------
# the overload flags: arrivals draw for draw, the drain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,burst,gap", [(9, 6, 12), (7, 3, 1), (12, 4, 0)])
def test_bursty_ticks_are_the_references(n, burst, gap):
    a = launcher.bursty_ticks(np.random.default_rng(5), n, burst, gap)
    b = jlaunch.bursty_ticks(np.random.default_rng(5), n, burst, gap)
    assert a == b and len(a) == n


TRACES = {"ticks": "0\n0\n3\n7\n7\n7\n9\n15\n16\n",
          "partial": "# tick,priority\n0,latency\n1\n\n1,best_effort\n"
                     "2,\n4  # a comment\n4,standard\n6\n9,latency\n",
          "short": "0,standard\n2\n5,best_effort\n"}


def _trace(tmp_path, name):
    path = tmp_path / f"{name}.trace"
    path.write_text(TRACES[name])
    return str(path)


@pytest.mark.parametrize("name", sorted(TRACES))
def test_load_arrival_trace_is_the_references(tmp_path, name):
    path = _trace(tmp_path, name)
    for n in (4, 20):
        assert launcher.load_arrival_trace(path, n) == \
            jlaunch.load_arrival_trace(path, n)


class _Captured(Exception):
    pass


def _reference_arrivals(monkeypatch, flags):
    """The reference launcher's requests for ``flags``: its ``main`` runs
    until it hands them to ``run_with_retries``."""
    def capture(sched, arrivals, **kw):
        raise _Captured(arrivals, kw)
    monkeypatch.setattr(jlaunch, "run_with_retries", capture)
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    with pytest.raises(_Captured) as ei:
        jlaunch.main()
    return ei.value.args


ARRIVAL_FLAGS = {
    "bursty": ["--arrivals", "bursty"],
    "bursty_gap": ["--arrivals", "bursty", "--burst", "4", "--burst-gap",
                   "3", "--system-prompt", "5"],
    "trace": ["--arrival-trace", "ticks"],
    "trace_partial": ["--arrival-trace", "partial", "--priority-mix",
                      "latency=0.25,standard=0.5,best_effort=0.25",
                      "--deadline-ticks", "6"],
    "trace_short": ["--arrival-trace", "short", "--system-prompt", "4"],
    "deadlines": ["--priority-mix", "latency=0.5,best_effort=0.5",
                  "--deadline-ticks", "4", "--max-retries", "2",
                  "--backoff", "3", "--grace-ticks", "5"],
}


@pytest.mark.parametrize("label", sorted(ARRIVAL_FLAGS))
def test_make_arrivals_draws_the_reference_requests(tmp_path, monkeypatch,
                                                    label):
    """Every new flag: the same ticks, classes, tasks, prompts, lengths
    and deadlines as the reference launcher's draws (a trace class takes
    no draw; a short trace cuts the stream), and the client loop's policy
    handed over as the reference hands it."""
    flags = ["--reduced", "--demo", "--tasks", "3", "--requests", "9",
             "--rate", "0.75", "--prompt", "12", "--steps", "6",
             "--max-len", "64", "--quiet"]
    extra = list(ARRIVAL_FLAGS[label])
    if "--arrival-trace" in extra:
        i = extra.index("--arrival-trace") + 1
        extra[i] = _trace(tmp_path, extra[i])
    ref, kw = _reference_arrivals(monkeypatch, flags + extra)
    args = launcher.parser().parse_args(flags + extra + ["--device", "cpu"])
    vocab = configs.reduced(configs.get("smollm-360m"), repeats=2).vocab_size
    mine = launcher.make_arrivals(args, vocab, 3)
    assert len(mine) == len(ref) == {"trace_short": 3,
                                     "trace_partial": 8}.get(label, 9)
    for (t, a), (u, b) in zip(mine, ref):
        assert (t, a.rid, a.task_id, a.max_new_tokens, a.priority,
                a.deadline_ticks) == (u, b.rid, b.task_id, b.max_new_tokens,
                                      b.priority, b.deadline_ticks)
        assert np.array_equal(a.prompt, b.prompt)
    assert (args.grace_ticks, args.max_retries, args.backoff) == (
        kw["grace_ticks"], kw["max_retries"], kw["backoff"])


def test_a_trace_class_outside_the_priorities_is_refused(tmp_path,
                                                         monkeypatch):
    path = tmp_path / "bad.trace"
    path.write_text("0,latency\n1,urgent\n")
    flags = ["--reduced", "--demo", "--requests", "2", "--quiet",
             "--arrival-trace", str(path)]
    args = launcher.parser().parse_args(flags + ["--device", "cpu"])
    with pytest.raises(ValueError, match="'urgent' is not one of"):
        launcher.make_arrivals(args, 128, 3)
    with pytest.raises(SystemExit):
        launcher.main(flags + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    with pytest.raises(SystemExit):
        jlaunch.main()


MAX_LEN = 48


@pytest.fixture(scope="module")
def engines(tiny_lm):
    from types import SimpleNamespace
    cfg, jmodel, jparams = tiny_lm
    tasks = jax_tasks(cfg, jparams, 3)
    jeng = JServeEngine(jmodel, jparams, JServeConfig(max_len=MAX_LEN),
                        fused_tasks=tasks)
    model, params = port_lm(tiny_lm)
    eng = ServeEngine(model, params, ServeConfig(max_len=MAX_LEN),
                      fused_tasks=port_tables(tasks))
    return cfg, {"reference": (SimpleNamespace(name="reference", S=jsched),
                               jeng),
                 "port": (SimpleNamespace(name="port", S=sched_mod), eng)}


def _overload(ns, eng, cfg, grace):
    """Bursts against a queue of 2 with latency deadlines, then a drain
    with ``grace`` ticks: gave-up rids, retries, the drain report, every
    shed and aborted request with its reason, the streams served."""
    rng = np.random.default_rng(23)
    classes = ("latency", "standard", "best_effort")
    arrivals = []
    for i in range(14):
        prio = classes[int(rng.integers(0, 3))]
        arrivals.append((int(i // 5) * 4, ns.S.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, int(
                rng.integers(4, 14))).astype(np.int32),
            task_id=int(rng.integers(0, 3)), priority=prio,
            max_new_tokens=int(rng.integers(3, 8)),
            deadline_ticks=5 if prio == "latency" else None)))
    sched = ns.S.ContinuousScheduler(eng, ns.S.SchedulerConfig(
        num_slots=2, bucket_min=8, kv_layout="paged", block_size=8,
        prefill_chunk=8, num_blocks=9, max_queue=2))
    run = (launcher if ns.name == "port" else jlaunch).run_with_retries
    gave_up, retries, report, sched = run(sched, arrivals, grace_ticks=grace,
                                          max_retries=2, backoff=2)
    assert not sched.busy() and sched.pool.leak_report() == []
    return (sorted(gave_up), retries,
            None if report is None else (
                report.finished, report.shed_rids, report.grace_ticks_used,
                report.leak_findings, report.cache_pages_released),
            sched.deadline_misses,
            sorted((r, q.finish_reason) for r, q in sched.shed.items()),
            sorted((r, q.finish_reason) for r, q in sched.aborted.items()),
            {r: list(map(int, q.out)) for r, q in sched.finished.items()})


@pytest.mark.parametrize("grace", [0, 3, -1])
def test_run_with_retries_drains_as_the_reference(engines, grace):
    got = both_sides(engines, _overload, grace=grace)
    gave_up, retries, report, misses, shed, aborted, _ = got
    assert retries > 0 and misses > 0 and shed
    if grace >= 0:
        assert report[2] <= grace and any(r == "shutdown"
                                          for _, r in aborted)
    else:
        assert report is None
