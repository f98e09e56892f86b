#!/usr/bin/env python3
"""Phase 6 of chip_smoke.py at several seeds, on one NVIDIA GPU.

    python3 chip_seeds.py                      # this checkout's kernels
    python3 chip_seeds.py --src OTHER/src      # another tree's kernels

For each seed of SEEDS, phase 6's checks at full width with 2 layers
(one mixed tick; a whole-prompt prefill plus three decode steps for the
multi-task AoT batch and for every method of phase 5d; paged against
contiguous decode) with inputs and PEFT parameters drawn from that seed.
Each line gives, per check, the max abs logits error against the plain
versions fed the kernels' tokens, the near ties (tokens where the
kernels' argmax is not the plain versions'), the largest logit gap at
such a tie, and whether the plain versions' own greedy run picked other
tokens (``free-run DIFFER``: the exact-token gate phase 6 held before it
fed both runs the same tokens). ``--src`` names the directory that holds
``repro_torch``, so that the kernels of another commit (unpacked with
``git archive``) go through the same checks; they are built from that
tree's sources.

Prints the card's name and power limit, one line per seed, and a JSON
summary as the last line. A reading, not a gate: exits 0 when every seed
ran, whatever the checks found; non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


SEEDS = range(8)          # chip_smoke.PHASE6_SEED (0) and seven more


def main() -> int:
    here = Path(__file__).resolve().parent
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=here / "src",
                    help="the directory that holds repro_torch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_seeds: FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(0, str(here))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi())
    csrc = Path(_build.__file__).parent / "csrc"
    _build.build(sorted(p.stem for p in csrc.glob("*.cu")))
    summary = {"src": str(args.src), "seeds": {}}
    for seed in SEEDS:
        report = {}
        try:
            cs.phase_cross_check(report, seed=seed, recompute=False)
            passed = True
        except AssertionError:
            passed = False
        checks = dict(tick=report["cross_check"],
                      static=report["cross_check_static"],
                      **report["cross_check_peft"])
        summary["seeds"][seed] = dict(passed=passed, checks=checks)
    flat = [(s, c, r) for s, v in summary["seeds"].items()
            for c, r in v["checks"].items()]
    summary["free_run_differ"] = [f"{s}/{c}" for s, c, r in flat
                                  if not r.get("free_same", True)]
    summary["near_ties"] = sum(r["near_ties"] for _, _, r in flat)
    summary["out_of_tolerance"] = [f"{s}/{c}" for s, c, r in flat
                                   if not r["ok"]]
    summary["paged_differ"] = [s for s, v in summary["seeds"].items()
                               if not v["checks"]["static"]["paged_same"]]
    out = here / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = f"chip_seeds_{args.src.resolve().parent.name}.json"
    (out / name).write_text(json.dumps(summary, indent=1, default=str))
    print(json.dumps({k: v for k, v in summary.items() if k != "seeds"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
