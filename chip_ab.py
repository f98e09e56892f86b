#!/usr/bin/env python3
"""Phase 4's ragged attention (the chunk tick and the decode tick) and a
contiguous decode of one source tree's kernels, on one card: one JSON
line per call. To compare two trees, run each in turns in one call on the
chip, e.g. a parent unpacked by ``git archive`` into ``build/parent`` and
this tree unpacked into ``build/final``:

    for t in parent final final parent; do
        python3 chip_ab.py build/$t $t || exit 1
    done

Each tree's kernels are built into that tree's own ``build/kernels``.
"""
import json
import sys

import numpy as np
import torch


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    tree, label = sys.argv[1], sys.argv[2]
    if not torch.cuda.is_available():
        print("chip_ab: FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [tree, tree + "/src"]
    import chip_smoke as cs
    from repro_torch.kernels import _build, decode_attention, ops
    _build.build(["decode_attention"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    pk = cs.packings()
    out = {}
    for name in ("chunk256_decode", "decode_only"):
        rows, pos = pk[name]
        q, k, v, bt, r, p = cs.ragged_inputs(gen, rows, pos, dt, layers=32)
        plan = torch.from_numpy(decode_attention.ragged_plan(
            np.asarray(rows, np.int32), np.asarray(pos, np.int32))).to("cuda")
        kern = lambda i: ops.ragged_paged_attention(q, k[i % 32], v[i % 32],
                                                    bt, r, p, plan)
        plain = lambda i: decode_attention.ragged_paged_attention_plain(
            q, k[i % 32], v[i % 32], bt, r, p)
        out[name] = round(cs.timed(kern, plain, 64, 16, tol=cs.TOL[dt])["ms"],
                          5)
    qd, kd, vd, cur = cs.decode_inputs(gen, cs.DECODE_LENS * 2, dt, cs.HD,
                                       layers=32)
    out["decode"] = round(cs.device_ms(
        lambda i: ops.decode_attention(qd, kd[i % 32], vd[i % 32], cur), 64), 5)
    print(label, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
