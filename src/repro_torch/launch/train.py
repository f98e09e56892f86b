"""Training launcher of the port: one PEFT method (or full fine-tuning) on
the synthetic LM stream, from a random backbone (seed 0) and PEFT
parameters (seed 1), in float32 with TF32 off, through the differentiable
plain path (``ModelOptions(attn_impl="ref")``). Counterpart of
``repro.launch.train`` with its defaults. The run checkpoints into
``--ckpt-dir``/<arch> (the reference's format) and resumes from the newest
checkpoint there, so a second call with more ``--steps`` continues the
first, bit for bit the run that was never stopped. Runs on the card unless
``--device cpu`` is given.

    # on a GPU: full-width smollm-360m, AoT with the FC reparametrization
    PYTHONPATH=src python -m repro_torch.launch.train --method aot \\
        --aot-mode fc --rank 32 --steps 100
    # on the CPU, reduced widths
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 3 --method lora
    # the paper's encoders (roberta-large, deberta-xl) train the same way
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 3 --arch roberta-large --method bitfit
    # the front-ends: seeded stub patches / audio frames beside the stream
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 3 --arch hubert-xlarge --method lora
    # stop after 20 steps, then resume to 30 in another process
    PYTHONPATH=src python -m repro_torch.launch.train --ckpt-dir D --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --ckpt-dir D --steps 30
    # a (data 2, model 4) mesh: 8 local gloo ranks on the CPU, spawned here
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --reduced --steps 2 --mesh 2x4
    # under torchrun (RANK / WORLD_SIZE set): one NCCL rank per GPU
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --mesh 2x2

With ``--mesh DxM`` the trainable state and the frozen tree are laid out
on a (data D, model M) mesh by their logical axes (``distrib.axes``,
``distrib.sharding.tp_dp_rules``), each batch by its batch axes, and the
step runs under those rules; gradients are reduced over the data axis
where the parameters are replicated. Rank 0 logs and writes the
checkpoints, whole leaves in the reference's format, so a run resumes on
any mesh or none. Without ``RANK`` / ``WORLD_SIZE`` in the environment
the launcher spawns the D * M local ranks itself.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.reshard import reshard_tree
from repro_torch.core import aot as aot_mod
from repro_torch.core import peft as peft_mod
from repro_torch.data.pipeline import LMStream
from repro_torch.device import resolve_device
from repro_torch.distrib import axes as axlib
from repro_torch.distrib import sharding as shlib
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.model import Model, ModelOptions
from repro_torch.train.loop import TrainLoop
from repro_torch.train.step import TrainConfig, make_train_step, split_train

METHODS = ("aot", "bitfit", "lora", "adapters", "ptv1", "ptv2", "ft")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--method", default="aot", choices=METHODS)
    ap.add_argument("--aot-mode", default="fc", choices=["fc", "kron"])
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--ckpt-dir", default="results/launch_train",
                    help="checkpoints go to (and resume from) DIR/<arch>")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run there)")
    ap.add_argument("--mesh", default="",
                    help="e.g. 2x4 => (data=2, model=4) ranks: NCCL, one GPU "
                         "each, or gloo with --device cpu; empty = no mesh")
    return ap


@dataclass
class Trainer:
    """What :func:`build` wires together."""
    model: Model
    params: Any                     # the backbone
    popt: peft_mod.PEFTOptions
    state: Any                      # {"trainable", "opt", "step"}
    frozen: Any
    train_step: Callable


def build(args, num_classes: int = 0) -> Trainer:
    """The model (attn_impl="ref", float32), its random backbone (seed 0),
    the method's PEFT parameters (seed 1; AoT with dropout 0, as the
    reference launcher sets it) and the train step, in LM mode or, with
    ``num_classes`` > 0, classifying through a head of that many classes."""
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg, repeats=2)
    if args.seq < cfg.frontend_len:
        raise SystemExit(f"{cfg.name}: --seq {args.seq} is shorter than its "
                         f"{cfg.frontend_len} patches")
    model = Model(cfg, ModelOptions(attn_impl="ref"), device=args.device)
    params = model.init(0)
    popt = peft_mod.PEFTOptions(
        method=args.method, num_classes=num_classes,
        aot=aot_mod.AoTOptions(mode=args.aot_mode, rank=args.rank,
                               dropout=0.0))
    pp = peft_mod.init(cfg, popt, seed=1, device=args.device)
    tcfg = TrainConfig(peft=popt, lr=args.lr, loss_chunk=args.seq // 4)
    init_state, train_step = make_train_step(model, tcfg,
                                             classify=num_classes > 0)
    trainable, frozen = split_train(params, pp, args.method)
    return Trainer(model, params, popt, init_state(trainable), frozen,
                   train_step)


def lm_stream(args, vocab_size: int) -> LMStream:
    """The training data: ``LMStream(seed 0)`` at ``--seq`` x ``--batch``."""
    return LMStream(vocab_size=vocab_size, seq_len=args.seq,
                    batch_size=args.batch, seed=0)


class FrontEndStream:
    """An :class:`LMStream` with a front-end's stub inputs beside each
    batch, seeded normals drawn as ``data.pipeline.input_batch_for`` draws
    them, from ``(seed, step)`` so that the stream resumes bitwise: a vision
    front-end's "patches" (b, frontend_len, frontend_dim); for audio frames
    "frames" (b, s, frontend_dim) in place of the tokens (the labels
    stay)."""

    def __init__(self, stream: LMStream, cfg):
        self.stream, self.cfg = stream, cfg

    def state(self) -> Dict:
        return self.stream.state()

    def restore(self, state: Dict):
        self.stream.restore(state)

    def next(self) -> Dict[str, np.ndarray]:
        cfg, step = self.cfg, self.stream.state()["step"]
        batch = self.stream.next()
        b, s = batch["labels"].shape
        rng = np.random.default_rng((self.stream.seed, step, 1))
        if cfg.frontend == "audio_frames":
            del batch["tokens"]
            batch["frames"] = rng.normal(
                size=(b, s, cfg.frontend_dim)).astype(np.float32)
        else:
            batch["patches"] = rng.normal(
                size=(b, cfg.frontend_len, cfg.frontend_dim)).astype(
                    np.float32)
        return batch


def _names(path, leaf):
    return axlib.logical_axes_for(path, tuple(leaf.shape))


def sharded_step(train_step, mesh, rules):
    """``train_step`` on ``mesh``: each batch entry laid out by its batch
    axes (every rank holds the whole batch and keeps its shard), the step
    run under ``rules``, its metrics gathered whole."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def step(state, frozen, batch, rng):
        batch = {k: distribute_tensor(
            v, mesh, shlib.placements_for(axlib.batch_axes_for(k, v.shape),
                                          v.shape, mesh, rules),
            src_data_rank=None) for k, v in batch.items()}
        with shlib.use_rules(mesh, rules):
            state, metrics = train_step(state, frozen, batch, rng)
        return state, {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}
    return step


def train(trainer: Trainer, args, log_every: int = 10,
          ckpt: Optional[CheckpointManager] = None, mesh=None,
          rules=None) -> TrainLoop:
    """``--steps`` steps on :func:`lm_stream`; the trained state lands in
    ``trainer.state``. With ``ckpt``, the newest checkpoint there is
    resumed first and the run saves every ``max(20, steps // 5)`` steps
    and at its last. With ``mesh`` and ``rules``, the state and the frozen
    tree are laid out on the mesh by their logical axes (a resumed state
    too) and every step runs there (:func:`sharded_step`). Returns the
    loop (its ``history`` and ``events``)."""
    cfg = trainer.model.cfg
    stream = lm_stream(args, cfg.vocab_size)
    if cfg.frontend:
        stream = FrontEndStream(stream, cfg)
    step, frozen = trainer.train_step, trainer.frozen
    if mesh is not None:
        step = sharded_step(step, mesh, rules)
        frozen = reshard_tree(frozen, mesh, rules, _names)
    loop = TrainLoop(train_step=step, frozen=frozen, stream=stream,
                     ckpt=ckpt, ckpt_every=max(20, args.steps // 5),
                     log_every=log_every, device=args.device)
    state, start = loop.resume(trainer.state)
    if mesh is not None:
        state = reshard_tree(state, mesh, rules, _names)
    trainer.state = loop.run(state, args.steps, start_step=start)
    return loop


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(argv: List[str], world: int, timeout_s: float = 3600.0
                ) -> int:
    """Run this launcher with ``argv`` as ``world`` local ranks (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT`` on a free local
    port), wait for all, and return the first non-zero exit code (0 when
    all succeed). A rank that fails ends the others; so does
    ``timeout_s``."""
    src = os.path.dirname(os.path.dirname(os.path.abspath(configs.__file__)))
    path = os.pathsep.join(p for p in (src, os.environ.get("PYTHONPATH"))
                           if p)
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), PYTHONPATH=path)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            bad = [p.returncode for p in procs if p.returncode]
            if bad or time.monotonic() > deadline:
                rc = bad[0] if bad else 124
                break
            time.sleep(0.1)
        rc = rc or next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return rc


def run_mesh(args, rank: int, world: int, log_every: int = 10):
    """This rank's share of a ``--mesh`` run: join the process group
    (NCCL on CUDA, gloo with ``--device cpu``; an initialised group is
    kept), build the trainer on this rank's device, and train it on the
    mesh. Rank 0 logs and writes the checkpoints. Returns (trainer,
    loop)."""
    shape, axes = mesh_mod.parse_mesh(args.mesh)
    if world != int(np.prod(shape)):
        raise SystemExit(f"--mesh {args.mesh} needs {int(np.prod(shape))} "
                         f"ranks; WORLD_SIZE is {world}")
    dev = mesh_mod.init_group(rank, world, args.device)
    args.device = str(dev)
    trainer = build(args)
    mesh = mesh_mod.make_mesh(shape, axes, dev.type)
    ckpt = CheckpointManager(f"{args.ckpt_dir}/{args.arch}", keep=2,
                             writer=rank == 0)
    loop = train(trainer, args, log_every=log_every, ckpt=ckpt, mesh=mesh,
                 rules=shlib.tp_dp_rules())
    if rank == 0:
        _report(loop)
    return trainer, loop


def _report(loop: TrainLoop) -> None:
    for h in loop.history[-3:]:
        print({k: round(v, 4) if isinstance(v, float) else v
               for k, v in h.items()})
    print("events:", loop.events)


def main(argv: Optional[List[str]] = None) -> int:
    args = parser().parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 as float32
    if args.mesh:
        shape, _ = mesh_mod.parse_mesh(args.mesh)
        resolve_device(args.device)     # refuses a missing card up front
        ranked = mesh_mod.env_rank()
        if ranked is None:
            return spawn_ranks(sys.argv[1:] if argv is None else list(argv),
                               int(np.prod(shape)))
        run_mesh(args, *ranked)
        return 0
    trainer = build(args)           # refuses a missing card before any file
    ckpt = CheckpointManager(f"{args.ckpt_dir}/{args.arch}", keep=2)
    _report(train(trainer, args, ckpt=ckpt))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
