"""Fusion and export, the paper's section 3.3 lifecycle as an artifact
pipeline: the port's counterpart of ``examples/fuse_and_export.py``.

Trains AoT P-Tuning with the FC and with the Kronecker reparametrization
on one classification task (``ClassificationTask(seed 3)``, a 2-class
head, from a random backbone, seed 0), fuses each into explicit per-layer
tables (``core.aot.fuse``, float32), holds forward through the tables
against forward through the reparametrization (bitwise on the CPU, within
2e-5 on CUDA, where cuBLAS may tile the two GEMMs differently), and writes
both through the checkpoint manager in the reference's format: step 1
fc, step 2 kron, ``extra={"mode", "arch"}``. ``launch.serve --load DIR``
(either package's) serves them, task id = step order. ``--arch`` picks
another decoder (the MoE pair among them; serve with the same ``--arch``).
Runs on the card unless ``--device cpu`` is given.

    # on the CPU, reduced widths, as the reference's example runs
    PYTHONPATH=src python -m repro_torch.launch.export --device cpu --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --load results/fused_artifacts
    # on a GPU: full-width smollm-360m (two float32 tables, 12.1 GB on disk)
    PYTHONPATH=src python -m repro_torch.launch.export
    PYTHONPATH=src python -m repro_torch.launch.serve --dtype bfloat16 \\
        --slots 8 --max-len 1024 --prefill-chunk 256 \\
        --load results/fused_artifacts
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import aot as aot_mod
from repro_torch.core import peft as peft_mod
from repro_torch.data.tasks import ClassificationTask
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, ModelOptions
from repro_torch.train.loop import step_rng
from repro_torch.train.step import TrainConfig, make_train_step, split_train

ARCH = "smollm-360m"
STEPS = {"fc": 1, "kron": 2}        # the reference's checkpoint step per mode
CPU_TOL, CUDA_TOL = 0.0, 2e-5       # fused against on-the-fly (ROADMAP C5)
# the reference example's training: 100 steps of 16 x 32 tokens, lr 8e-3,
# AoT rank 16, PEFT seed 4
TRAIN_STEPS, BATCH, SEQ, LR, RANK = 100, 16, 32, 8e-3, 16


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=ARCH,
                    help="any servable decoder (default: the reference "
                         "example's smollm-360m)")
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the arch to 2 layers and tiny widths")
    ap.add_argument("--out", default="results/fused_artifacts",
                    help="checkpoint directory the tables are written to")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run there)")
    return ap


def train_mode(model, params, task, mode: str):
    """AoT with reparametrization ``mode`` (RANK, no dropout, PEFT seed 4)
    and a head trained TRAIN_STEPS steps on ``task``'s batches of BATCH in
    float32. Returns (the trained PEFT params, their options, the last
    step's accuracy)."""
    popt = peft_mod.PEFTOptions(
        method="aot", num_classes=task.num_classes,
        aot=aot_mod.AoTOptions(mode=mode, rank=RANK, dropout=0.0))
    pp = peft_mod.init(model.cfg, popt, seed=4, device=model.device)
    init_state, train_step = make_train_step(
        model, TrainConfig(peft=popt, lr=LR), classify=True)
    trainable, frozen = split_train(params, pp, "aot")
    state = init_state(trainable)
    for i in range(TRAIN_STEPS):
        b = {k: torch.from_numpy(v).to(model.device)
             for k, v in task.batch(BATCH, step=i).items()}
        state, m = train_step(state, frozen, b, step_rng(0, i))
    return state["trainable"]["peft"], popt, float(m["acc"])


def fused_error(model, params, peft_params, popt, fused, tokens) -> float:
    """Max abs difference of ``model.forward`` through the
    reparametrization and through its ``fused`` tables on ``tokens``."""
    fopt = peft_mod.PEFTOptions(method="aot",
                                aot=aot_mod.AoTOptions(mode="fused"))
    with torch.no_grad():
        h1 = model.forward(params, tokens, peft_mod.make(peft_params, popt))
        h2 = model.forward(params, tokens,
                           peft_mod.make({"aot": fused}, fopt))
    return float((h1 - h2).abs().max())


def export_tasks(directory: str, fused_by_mode: Dict[str, dict],
                 arch: str) -> List[int]:
    """Write each mode's fused tables ``{"table": (L, V, d)}`` (float32,
    as the reference writes them) as its checkpoint step (fc 1, kron 2)
    with ``extra={"mode", "arch"}``; returns the directory's steps."""
    mgr = CheckpointManager(directory, keep=4, async_save=False)
    for mode, fused in fused_by_mode.items():
        if fused["table"].dtype != torch.float32:
            raise ValueError(f"{mode}: tables are exported in float32, got "
                             f"{fused['table'].dtype}")
        mgr.save(STEPS[mode], fused, extra={"mode": mode, "arch": arch})
    return mgr.all_steps()


def main(argv: Optional[List[str]] = None) -> int:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 as float32
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg, repeats=2)
    model = Model(cfg, ModelOptions(attn_impl="ref"), device=dev)
    params = model.init(0)
    task = ClassificationTask("exp", vocab_size=cfg.vocab_size,
                              seq_len=SEQ, num_classes=2, seed=3)
    tokens = torch.from_numpy(task.batch(4, 999)["tokens"]).to(dev)
    tol = CPU_TOL if dev.type == "cpu" else CUDA_TOL
    fused_by_mode = {}
    for mode in STEPS:
        peft_params, popt, acc = train_mode(model, params, task, mode)
        if mode == "kron":
            a, b = aot_mod.kron_factors(cfg.vocab_size)
            print(f"[{mode}] factorization a={a} b={b} (a*b={a * b} >= "
                  f"|V|={cfg.vocab_size})")
        with torch.no_grad():
            fused = aot_mod.fuse(peft_params["aot"], cfg, popt.aot,
                                 embed=params["embed"]["tok"])
        err = fused_error(model, params, peft_params, popt, fused, tokens)
        mb = aot_mod.table_bytes(cfg, 1, 2) / 1e6
        print(f"[{mode}] train_acc={acc:.3f} fuse_err={err:.1e} "
              f"serving_tables={mb:.2f} MB (bf16)")
        if not err <= tol:
            raise SystemExit(f"[{mode}] fused tables off the "
                             f"reparametrization by {err:.3e} (> {tol})")
        fused_by_mode[mode] = fused
    steps = export_tasks(args.out, fused_by_mode, cfg.name)
    print(f"fused artifacts written to {args.out} (steps: {steps})")
    rl = configs.get("roberta-large")
    print(f"RoBERTa-Large fused tables would be "
          f"{aot_mod.table_bytes(rl, 1, 2) / 1e9:.2f} GB/task (paper "
          "section 3.3: ~2.4 GB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
