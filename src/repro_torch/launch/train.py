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
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import aot as aot_mod
from repro_torch.core import peft as peft_mod
from repro_torch.data.pipeline import LMStream
from repro_torch.models.model import Model, ModelOptions
from repro_torch.train.loop import TrainLoop
from repro_torch.train.step import TrainConfig, make_train_step, split_train

METHODS = ("aot", "bitfit", "lora", "adapters", "ptv1", "ptv2", "ft")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="Not ported yet (ROADMAP A16): the reference's --mesh (a "
               "data x model device mesh).")
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


def train(trainer: Trainer, args, log_every: int = 10,
          ckpt: Optional[CheckpointManager] = None) -> TrainLoop:
    """``--steps`` steps on :func:`lm_stream`; the trained state lands in
    ``trainer.state``. With ``ckpt``, the newest checkpoint there is
    resumed first and the run saves every ``max(20, steps // 5)`` steps
    and at its last. Returns the loop (its ``history`` and ``events``)."""
    cfg = trainer.model.cfg
    stream = lm_stream(args, cfg.vocab_size)
    if cfg.frontend:
        stream = FrontEndStream(stream, cfg)
    loop = TrainLoop(train_step=trainer.train_step, frozen=trainer.frozen,
                     stream=stream, ckpt=ckpt,
                     ckpt_every=max(20, args.steps // 5),
                     log_every=log_every, device=args.device)
    state, start = loop.resume(trainer.state)
    trainer.state = loop.run(state, args.steps, start_step=start)
    return loop


def main(argv: Optional[List[str]] = None) -> int:
    args = parser().parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 as float32
    trainer = build(args)           # refuses a missing card before any file
    ckpt = CheckpointManager(f"{args.ckpt_dir}/{args.arch}", keep=2)
    loop = train(trainer, args, ckpt=ckpt)
    for h in loop.history[-3:]:
        print({k: round(v, 4) if isinstance(v, float) else v
               for k, v in h.items()})
    print("events:", loop.events)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
