#!/usr/bin/env python3
"""Where the ragged kernel's blocks run and for how long, on one card.

    python3 chip_trace.py [--blocks-only] [TREE [LABEL]]   # TREE: this tree

Builds a traced copy of TREE's ``csrc/decode_attention.cu`` under
``build/trace/LABEL``: every block records, on thread 0, its SM, the global
timer and the clock at entry and exit, and its plan item; a run walk also
records the clock cycles it spends setting up, walking and merging, and
per tile step those of warp 0 (lane 0) in each part of the step: issuing
the next tile's copies, waiting for this tile and the block barrier, the
scores (q K), the online softmax (shuffles, expf, the probabilities to
shared memory), P V, and the barrier after the step. Those counters need
this tree's run walk: the script fails where TREE's source lacks one of
their anchors, unless ``--blocks-only`` (block lives alone, for an earlier
tree's kernel). It runs one call of phase 4's ragged packings (the chunk
tick, ``deep_1024`` and the decode tick at smollm-360m's heads, the chunk
tick at qwen3-moe's), each first checked bitwise against paged decode, and
prints one JSON line per packing: the call's span, the blocks alive and
the SMs holding a block that walks, over time, each kind of item's block
lives, and the run walk's cycles (and ns, at the clock the blocks ran at)
per tile step. The trace changes timing a little: compare spans with
``chip_ab.py``'s, not with the trace's own. Raw traces go to
``chiprun_out/trace_<LABEL>_<packing>.npy``.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

TRACE = r'''
__device__ unsigned long long g_trace[8192][16];
__device__ __forceinline__ unsigned long long trace_time() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TRACE_SET(i, v) \
  do { if (threadIdx.x == 0) g_trace[blockIdx.x][i] = (v); } while (0)
// thread 0's laps of a run walk's tile steps, in shared memory (on only
// in a run walk's block): 0 issue, 1 wait, 2 scores, 3 softmax, 4 P V, 5
// barrier after, 6 steps
__shared__ long long tr_mark, tr_lap[7];
__shared__ int tr_on;
#define TRACE_MARK() \
  do { if (threadIdx.x == 0 && tr_on) tr_mark = clock64(); } while (0)
#define TRACE_LAP(i) \
  do { \
    if (threadIdx.x == 0 && tr_on) { \
      const long long c_ = clock64(); \
      tr_lap[i] += c_ - tr_mark; \
      tr_mark = c_; \
    } \
  } while (0)
// slots: 0 entry and 1 exit (global timer, ns), 2 SM, 3 plan item, 4 the
// clock at entry, 5 set-up / 6 walk / 7 merge cycles (run walks), 8-14
// tr_lap, 15 the clock at exit
struct TraceScope {
  __device__ TraceScope() {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    TRACE_SET(0, trace_time());
    TRACE_SET(2, sm);
    TRACE_SET(4, clock64());
    if (threadIdx.x == 0) {
      tr_on = 0;
      for (int i = 0; i < 7; ++i) tr_lap[i] = 0;
    }
  }
  __device__ ~TraceScope() {
    TRACE_SET(15, clock64());
    for (int i = 0; i < 7; ++i) TRACE_SET(8 + i, tr_lap[i]);
    TRACE_SET(1, trace_time());
  }
};
'''
READ = '''
extern "C" int read_trace(void* dst, unsigned long long bytes) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_trace, bytes));
}
extern "C" int clear_trace() {
  static unsigned long long zeros[8192][16];
  return static_cast<int>(cudaMemcpyToSymbol(g_trace, zeros, sizeof(zeros)));
}
'''
# this tree's run walk: cycles of set-up (entry to the page ids and the
# first q rows in shared memory), of the tile loops and of the merges,
# summed over its passes, and thread 0's laps of each tile step
# (walk_tile_tokens is the split walk's step too; its laps count only
# where a run walk turned them on)
PHASES = [
    ('''  __syncthreads();
  float* pws = p_s + warp * W * G * 16;''',
     '''  __syncthreads();
  long long c_walk = 0, c_merge = 0;
  if (threadIdx.x == 0) {
    g_trace[blockIdx.x][5] = clock64() - g_trace[blockIdx.x][4];
    tr_on = 1;
  }
  float* pws = p_s + warp * W * G * 16;'''),
    ('''    if (n_tiles > 0) {
      stage_kv<bf16, HDP, VEC>(k_s, v_s, kb, vb, srows, lo, hi_pass, hd,''',
     '''    const long long c0 = clock64();
    if (n_tiles > 0) {
      stage_kv<bf16, HDP, VEC>(k_s, v_s, kb, vb, srows, lo, hi_pass, hd,'''),
    ('''      for (int t = 0; t < n_tiles; ++t) {
        if (t + 1 < n_tiles) {''',
     '''      for (int t = 0; t < n_tiles; ++t) {
        TRACE_MARK();
        if (t + 1 < n_tiles) {'''),
    ('''        attn::cp_async_commit();
        attn::cp_async_wait<1>();         // tile t has landed
        __syncthreads();                  // (and q_s, on the first tile)
        const int s0 = (t & 1) * kSplitTile * kLd;
        walk_tile_tokens<bf16, HDP, G, true, W>(
            k_s + s0, v_s + s0, q_s, pws, lo + t * kSplitTile, hi, scale, st,
            warp, lane);
        __syncthreads();                  // stage t & 1 is free again''',
     '''        TRACE_LAP(0);
        attn::cp_async_commit();
        attn::cp_async_wait<1>();         // tile t has landed
        __syncthreads();                  // (and q_s, on the first tile)
        TRACE_LAP(1);
        const int s0 = (t & 1) * kSplitTile * kLd;
        walk_tile_tokens<bf16, HDP, G, true, W>(
            k_s + s0, v_s + s0, q_s, pws, lo + t * kSplitTile, hi, scale, st,
            warp, lane);
        TRACE_LAP(4);
        __syncthreads();                  // stage t & 1 is free again
        TRACE_LAP(5);
        if (threadIdx.x == 0) tr_lap[6] += 1;'''),
    ('''  // ---- online softmax over the warp's 16 positions''',
     '''  TRACE_LAP(2);
  // ---- online softmax over the warp's 16 positions'''),
    ('''  __syncwarp();
  // ---- P V: V rows masked only''',
     '''  __syncwarp();
  TRACE_LAP(3);
  // ---- P V: V rows masked only'''),
    ('''    // ---- each token's four warp partials -> its block partial (the ring
    // is free: every tile has landed and been walked)''',
     '''    const long long c1 = clock64();
    c_walk += c1 - c0;
    // ---- each token's four warp partials -> its block partial (the ring
    // is free: every tile has landed and been walked)'''),
    ('''    __syncthreads();                      // the ring free again
  };''',
     '''    __syncthreads();                      // the ring free again
    c_merge += clock64() - c1;
    TRACE_SET(6, c_walk);
    TRACE_SET(7, c_merge);
  };'''),
]
LAPS = ("issue", "wait", "scores", "softmax", "pv", "barrier_after")


def anchored(src, anchor, what):
    """The match of ``anchor`` (a regex) in ``src``; exits naming ``what``
    where the source has none."""
    m = re.search(anchor, src)
    if m is None:
        sys.exit(f"chip_trace: FAIL: no anchor for {what} in the source")
    return m


def traced_source(src, blocks_only=False):
    """``src`` with the trace: every block's entry and exit (a scope at the
    top of ragged_split_kernel) and its plan item, and unless
    ``blocks_only`` this tree's run-walk counters. Exits where an anchor is
    missing or not unique."""
    src = src.replace("namespace cg = cooperative_groups;",
                      "namespace cg = cooperative_groups;\n" + TRACE, 1)
    if TRACE not in src:
        sys.exit("chip_trace: FAIL: no anchor for the trace's declarations")
    head = anchored(src, r"ragged_split_kernel\([^{]*\{\n", "block lives")
    src = src[:head.end()] + "  TraceScope trace_scope;\n" + src[head.end():]
    item = anchored(src, r"\n  const int32_t\* item = plan \+ [^;]*;\n",
                    "the plan item")
    src = (src[:item.end()] + "  TRACE_SET(3, (item - plan) / kPlanWidth);\n"
           + src[item.end():])
    if not blocks_only:
        for i, (a, b) in enumerate(PHASES):
            if src.count(a) != 1:
                sys.exit(f"chip_trace: FAIL: run-walk anchor {i} found "
                         f"{src.count(a)} times (once expected); "
                         "--blocks-only traces block lives alone")
            src = src.replace(a, b, 1)
    return src + READ


def percentiles(x, q=(0, 50, 90, 100)):
    return [round(float(v), 2) for v in np.percentile(x, q)] if len(x) else []


def step_cycles(tr, m):
    """The run walk's tile step on blocks ``m``: thread 0's cycles in each
    lap per step (the median over the blocks of each block's mean), their
    sum, the clock's ns per cycle (a block's global-timer span over its
    clock span, the median) and so the step in ns."""
    steps = tr[m, 14]
    m = np.flatnonzero(m)[steps > 0]
    if not len(m):
        return {}
    per = tr[m, 8:14] / tr[m, 14:15]
    ns = np.median((tr[m, 1] - tr[m, 0]) / np.maximum(tr[m, 15] - tr[m, 4],
                                                       1))
    laps = {k: round(float(np.median(per[:, i])), 1)
            for i, k in enumerate(LAPS)}
    total = float(np.median(per.sum(axis=1)))
    return dict(blocks=int(len(m)), steps_median=float(np.median(tr[m, 14])),
                cycles_per_step=laps, cycles_per_step_total=round(total, 1),
                ns_per_cycle=round(float(ns), 4),
                ns_per_step=round(total * float(ns), 1))


def summary(tr, plan, pos, kvh, split, phases):
    """One packing's trace: span, alive blocks and walking SMs over time,
    each kind of item's block lives (us), and with ``phases`` the run
    walk's set-up / walk / merge cycles and its tile step's laps."""
    ent, ext = tr[:, 0] - tr[:, 0].min(), tr[:, 1] - tr[:, 0].min()
    ent, ext = ent / 1e3, ext / 1e3
    items = tr[:, 3]
    cnt, first = plan[items, 1], np.asarray(pos)[plan[items, 0]]
    kind = np.where(first < 0, "dead", np.where(cnt > 1, "run", "single"))
    life = ext - ent
    walks = life > 2.0          # a block that returns at once lives ~0.5 us
    steps = np.arange(0.0, ext.max(), 1.0)
    alive = [((ent <= t) & (ext > t)) for t in steps]
    out = dict(span_us=round(float(ext.max()), 2), blocks=int(len(tr)),
               sms=int(len(np.unique(tr[:, 2]))),
               sms_with_a_block_over_2us=int(len(np.unique(tr[walks, 2]))),
               alive_median=float(np.median([a.sum() for a in alive])),
               walking_sms_median=float(np.median(
                   [len(np.unique(tr[a & walks, 2])) for a in alive])))
    rank = np.arange(len(tr)) % split
    for k in ("run", "single"):
        m = kind == k
        if m.any():
            out[k] = dict(n=int(m.sum()), life_us=percentiles(life[m]),
                          entry_us=percentiles(ent[m]),
                          by_rank_life_median_us=[
                              round(float(np.median(life[m & (rank == r)])),
                                    2) for r in range(split)])
    if phases:
        m = (kind == "run") & (tr[:, 6] > 0)
        out["run_cycles_setup_walk_merge_median"] = [
            int(np.median(tr[m, c])) for c in (5, 6, 7)] if m.any() else []
        out["run_step"] = step_cycles(tr, kind == "run")
    return out


def main() -> int:
    args = sys.argv[1:]
    blocks_only = "--blocks-only" in args
    args = [a for a in args if a != "--blocks-only"]
    tree = args[0] if args else "."
    label = args[1] if len(args) > 1 else "this"
    if not torch.cuda.is_available():
        print("chip_trace: FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [tree, tree + "/src"]
    import chip_smoke as cs
    from repro_torch.kernels import _build, decode_attention as da, ops
    csrc = os.path.join(tree, "src/repro_torch/kernels/csrc")
    src = traced_source(open(f"{csrc}/decode_attention.cu").read(),
                        blocks_only)
    d = f"build/trace/{label}"
    os.makedirs(d, exist_ok=True)
    open(f"{d}/decode_attention.cu", "w").write(src)
    shutil.copy(f"{csrc}/attention_common.cuh", d)
    built = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                            f"{d}/lib.so", f"{d}/decode_attention.cu"],
                           capture_output=True, text=True)
    if built.returncode:
        print(built.stdout[-3000:], built.stderr[-3000:], file=sys.stderr)
        return 1
    lib = ctypes.CDLL(f"{d}/lib.so")
    fn = lib.ragged_paged_attention
    fn.argtypes = da._ARGTYPES["ragged_paged_attention"]
    fn.restype = ctypes.c_int
    lib.read_trace.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong]
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    pk = cs.packings()
    os.makedirs("chiprun_out", exist_ok=True)
    for key, name, hd, heads in [
            ("chunk", "chunk256_decode", cs.HD, (cs.H, cs.KVH)),
            ("deep", "deep_1024", cs.HD, (cs.H, cs.KVH)),
            ("decode", "decode_only", cs.HD, (cs.H, cs.KVH)),
            ("moe_chunk", "chunk256_decode", 128, cs.MOE_HEADS)]:
        rows, pos = pk[name]
        q, k, v, bt, r, p = cs.ragged_inputs(gen, rows, pos, dt, layers=8,
                                             hd=hd, heads=heads)
        plan_np = da.ragged_plan(rows, pos)
        plan = torch.from_numpy(plan_np).to("cuda")
        want = ops.paged_decode_attention(q, k[0], v[0],
                                          bt[r.long()].contiguous(),
                                          torch.clamp(p + 1, min=0))
        da._FNS["ragged_paged_attention"] = fn
        try:
            for i in range(3):          # warm: the launch, L2, clocks
                out = ops.ragged_paged_attention(q, k[i], v[i], bt, r, p,
                                                 plan)
            out = ops.ragged_paged_attention(q, k[0], v[0], bt, r, p, plan)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                print(f"chip_trace: FAIL: {key} not bitwise paged decode",
                      file=sys.stderr)
                return 1
            lib.clear_trace()
            ops.ragged_paged_attention(q, k[5], v[5], bt, r, p, plan)
            torch.cuda.synchronize()
        finally:
            da._FNS.pop("ragged_paged_attention")
        split = da.decode_split(bt.shape[1] * cs.BS)
        nb = plan_np.shape[0] * heads[1] * split
        tr = np.zeros((8192, 16), np.uint64)
        lib.read_trace(tr.ctypes.data, tr.nbytes)
        tr = tr[:nb].astype(np.int64)
        np.save(f"chiprun_out/trace_{label}_{key}.npy", tr)
        res = summary(tr, plan_np, pos, heads[1], split, not blocks_only)
        print(label, key, json.dumps(res), flush=True)
        del q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
