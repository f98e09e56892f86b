#!/usr/bin/env python3
"""Phase 4's attention cases of one source tree's kernels, on one card: ragged
attention on the chunk tick, the decode tick and a chunk deep in a context
(``deep_1024``) at smollm-360m's heads, the chunk and decode ticks at
qwen3-moe's (h32 kvh4 hd128), and contiguous and paged decode at phase 4's
shapes, and both over the same K/V at b 4 rows of 1024 at one or two KV
heads (``b4_full/...``: [contiguous, paged]); phase 4's flash rows
(``flash/...``: [kernel, SDPA] with the same mask, SDPA timed in the same
call; the build that ran where the tree names it): smollm-360m's (16, 512)
causal and one prompt of 512, the encoders' 8 x 384 full, qwen3-moe's (16,
512) causal, recurrentgemma's 4 x 3072 at hd 256 with its window of 2048,
causal and full, hubert's 8 x 512 full at hd 80 and danube's 6144 with its
window of 4096 (hd 80); one JSON line of device ms per call, after the
card's name and power limit. With ``stream`` after the label, also phase
5's greedy paged stream on the tree's own engine, its tokens as one digest
(``chip_smoke.streams_digest``'s). To compare two trees, run each in turns
in one call on the chip, e.g. a parent unpacked by ``git archive`` into
``build/parent`` and this tree unpacked into ``build/final``:

    for t in parent final final parent; do
        python3 chip_ab.py build/$t $t || exit 1
    done

Each tree's kernels are built into that tree's own ``build/kernels``; each
tree's own ``chip_smoke.py`` makes the inputs (the same seed).
"""
import hashlib
import json
import sys

import numpy as np
import torch


def greedy_digest(cs) -> str:
    """Phase 5's greedy paged stream (the launcher's own code, random
    weights from seed 0) on ``cs``'s tree: its tokens by request id as 16
    hex digits of a hash."""
    from repro_torch.launch import serve as launcher
    engine, _ = cs.build_engine()
    args = launcher.parser().parse_args(cs.BASE + cs.GREEDY)
    sched = launcher.serve(engine, args, launcher.make_arrivals(
        args, engine.model.cfg.vocab_size, args.tasks))
    text = json.dumps({str(r.rid): [int(t) for t in r.out]
                       for r in sorted(sched.finished.values(),
                                       key=lambda r: r.rid)})
    return hashlib.sha256(text.encode()).hexdigest()[:16]


# phase 4's flash rows: name -> (b, s, heads, hd, causal, window)
FLASH_ROWS = {"smollm_b16_s512_causal": (16, 512, "H", 64, True, 0),
              "smollm_b1_s512_causal": (1, 512, "H", 64, True, 0),
              "encoders_b8_s384_full": (8, 384, "ENC_HEADS", 64, False, 0),
              "qwen3moe_b16_s512_causal": (16, 512, "MOE_HEADS", 128, True,
                                           0),
              "rgemma_b4_s3072_window2048": (4, 3072, "RGEMMA_HEADS", 256,
                                             True, 2048),
              "rgemma_b4_s3072_causal": (4, 3072, "RGEMMA_HEADS", 256, True,
                                         0),
              "rgemma_b4_s3072_full": (4, 3072, "RGEMMA_HEADS", 256, False,
                                       0),
              "hubert_b8_s512_full": (8, 512, "HUBERT_HEADS", 80, False, 0),
              "danube_b1_s6144_window4096": (1, 6144, "DANUBE_HEADS", 80,
                                             True, 4096)}


def flash_rows(cs, gen):
    """{"flash/<row>": [kernel ms, SDPA ms] (+ the wrapper's host us per
    call at one prompt of 512, + the build)} over FLASH_ROWS, inputs
    rotating over 4 sets; SDPA takes is_causal, no mask, or the window's
    bool mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    out = {}
    for name, (b, s, heads, hd, causal, window) in FLASH_ROWS.items():
        heads = (cs.H, cs.KVH) if heads == "H" else getattr(cs, heads)
        qs = [cs.flash_inputs(gen, b, s, s, hd, torch.bfloat16, heads=heads)
              for _ in range(4)]
        before = dict(getattr(fa, "BUILDS", {}))
        ms = cs.device_ms(lambda i: ops.flash_attention(
            *qs[i % 4], causal=causal, window=window), 8)
        kw = dict(is_causal=causal)
        if window:
            pos = torch.arange(s, device="cuda")
            kw = dict(attn_mask=(pos[None, :] <= pos[:, None])
                      & (pos[None, :] > pos[:, None] - window))
        sdpa = cs.device_ms(lambda i: F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in qs[i % 4]), enable_gqa=True,
            **kw), 8)
        row = [round(ms, 5), round(sdpa, 5)]
        if b == 1 and s == 512:        # host us per call, launch shorter
            row.append(round(cs.host_us(lambda i: ops.flash_attention(
                *qs[i % 4], causal=causal, window=window)), 1))
        built = [k for k, v in getattr(fa, "BUILDS", {}).items()
                 if v != before.get(k, 0)]
        out[f"flash/{name}"] = row + built
        del qs
    return out


def main() -> int:
    if len(sys.argv) not in (3, 4) or sys.argv[3:] not in ([], ["stream"]):
        print(__doc__, file=sys.stderr)
        return 2
    tree, label = sys.argv[1], sys.argv[2]
    if not torch.cuda.is_available():
        print("chip_ab: FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [tree, tree + "/src"]
    import chip_smoke as cs
    from repro_torch.kernels import _build, decode_attention, ops
    stream = sys.argv[3:] == ["stream"]
    _build.build(cs.KERNEL_SOURCES if stream
                 else ["decode_attention", "flash_attention"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    pk = cs.packings()
    out = {}
    cases = [("chunk256_decode", cs.HD, (cs.H, cs.KVH)),
             ("decode_only", cs.HD, (cs.H, cs.KVH)),
             ("deep_1024", cs.HD, (cs.H, cs.KVH)),
             ("moe/chunk256_decode", 128, cs.MOE_HEADS),
             ("moe/decode_only", 128, cs.MOE_HEADS)]
    for key, hd, heads in cases:
        rows, pos = pk[key.split("/")[-1]]
        q, k, v, bt, r, p = cs.ragged_inputs(gen, rows, pos, dt, layers=32,
                                             hd=hd, heads=heads)
        plan = torch.from_numpy(decode_attention.ragged_plan(
            np.asarray(rows, np.int32), np.asarray(pos, np.int32))).to("cuda")
        kern = lambda i: ops.ragged_paged_attention(q, k[i % 32], v[i % 32],
                                                    bt, r, p, plan)
        plain = lambda i: decode_attention.ragged_paged_attention_plain(
            q, k[i % 32], v[i % 32], bt, r, p)
        out[key] = round(cs.timed(kern, plain, 64, 16, tol=cs.TOL[dt])["ms"],
                         5)
        del q, k, v
    # contiguous decode: 16 rows at depths 512-575 of S 1024 (phase 4)
    qd, kd, vd, cur = cs.decode_inputs(gen, list(range(512, 576, 4)), dt,
                                       cs.HD, layers=32)
    out["decode"] = round(cs.device_ms(
        lambda i: ops.decode_attention(qd, kd[i % 32], vd[i % 32], cur),
        64), 5)
    del qd, kd, vd
    # paged decode: 8 slots of depths 17-1024, scrambled pages (phase 4)
    q = torch.randn(cs.SLOTS, cs.H, cs.HD, generator=gen, device="cuda").to(dt)
    kp = torch.randn(32, cs.NUM_BLOCKS, cs.BS, cs.KVH, cs.HD, generator=gen,
                     device="cuda").to(dt)
    vp = torch.randn_like(kp)
    bt = (torch.randperm(cs.NUM_BLOCKS - 1, generator=gen, device="cuda")
          + 1).view(cs.SLOTS, cs.NPAGES).to(torch.int32)
    cur = torch.tensor([1024, 1000, 777, 576, 512, 300, 129, 17],
                       dtype=torch.int32, device="cuda")
    out["paged_decode"] = round(cs.device_ms(
        lambda i: ops.paged_decode_attention(q, kp[i % 32], vp[i % 32], bt,
                                             cur), 64), 5)
    del q, kp, vp
    # contiguous and paged decode over the same K/V (pages of 16 scrambled,
    # bitwise equal) at few walks: b 4 rows full at 1024, one or two KV
    # heads (paligemma-3b's MQA at hd 256, g 8), 8 layers rotating
    for hd, heads in ((64, (8, 1)), (128, (8, 1)), (256, (8, 1)),
                      (256, (4, 1)), (256, (6, 2))):
        q, k, v, cur = cs.decode_inputs(gen, [1024] * 4, dt, hd, layers=8,
                                        heads=heads)
        pools = [cs.paged_copy(gen, k[i], v[i], 16, False) for i in range(8)]
        cont = lambda i: ops.decode_attention(q, k[i % 8], v[i % 8], cur)
        paged = lambda i: ops.paged_decode_attention(q, *pools[i % 8], cur)
        if not torch.equal(cont(0), paged(0)):
            raise AssertionError(f"paged decode hd {hd} {heads} is not "
                                 "bitwise contiguous decode")
        out[f"b4_full/hd{hd}_h{heads[0]}_kvh{heads[1]}"] = [
            round(cs.device_ms(fn, 64), 5) for fn in (cont, paged)]
        del q, k, v, pools
    out.update(flash_rows(cs, gen))
    if stream:
        out["greedy_tokens_digest"] = greedy_digest(cs)
    print(cs.smi(), flush=True)
    print(label, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
