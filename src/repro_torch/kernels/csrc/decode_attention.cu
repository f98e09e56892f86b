// Decode attention for Hopper (sm_90a): query tokens attending over a KV
// history, in three forms: a row of a contiguous cache, a row of a paged
// pool through its block table, and each token of a packed ragged list over
// its slot's pages.
//
// Replaces: decode_attention_kernel, paged_decode_attention_kernel and
// ragged_paged_attention_kernel in src/repro/kernels/decode_attention.py.
// Semantics are the same: the g query heads of KV head kh attend over kv
// positions 0 .. n - 1, where n is cur_len[b] for a decode row and
// token_pos[t] + 1 for a ragged token (token t belongs to slot
// token_rows[t]; a ragged prefill chunk's tokens each see up to their own
// position, so they see their lower-positioned chunk-mates); positions past
// the cache or the table are not there to see; softmax in fp32 with running
// max/sum/accumulator and scale 1/sqrt(hd); a row with n <= 0 (cur_len <= 0,
// a dead padding token with token_pos < 0) gives exact zeros.
//
// Bound on an H100: bytes for decode rows, which read their K/V history once
// per KV head and do about 4 g flops per kv element read (g = 3 for
// smollm-360m), far under the card's ~295 flops per byte of bf16. So the
// card has to keep enough loads in flight to pull 3.35 TB/s. A ragged
// prefill chunk reads its slot's pages once per KV head too, if its tokens
// share them (the run walk below), and then does 4 hd flops per (query
// head, visible position) on the CUDA cores.
//
// One split walk serves every single query token (split_walk): one (row or
// token, KV head) walk is split over a thread-block cluster of `split`
// blocks (up to 8; the wrapper gives each block 256 positions of the
// capacity, S or npages x block_size, since the lengths live on the
// device). One block per walk gave 16 x 5 = 80 blocks of four warps on 132
// SMs at the static batch (40 at the paged one), too few loads in flight,
// and the deepest row set the time; the cluster gives 4x as many.
// - block r walks positions [r chunk, (r + 1) chunk), chunk = ceil(cap /
//   split), cut at the row's length; a block whose range is empty
//   contributes an empty partial (l = 0);
// - K/V tiles of 64 positions are staged in their own type with cp.async,
//   double-buffered: eight threads cover a 128-byte row, one instruction
//   four rows (a one-element build takes rows that are not 16-byte
//   aligned); hd is padded with zeros to 64 or 128 (contiguous decode
//   also 256: the wide walk below) in shared memory. Each
//   staged row comes from its own address: position p of a contiguous row,
//   or page table[p / block_size] of a paged one (any block size; a tile of
//   64 spans pages, 4 of them at smollm's 16), so the paged walk visits the
//   same ranges and tiles in the same order as the contiguous one and its
//   output is bitwise the contiguous one's over the same K/V;
// - warp w takes tile positions 16 w .. 16 w + 15, two lanes a position
//   (half the 16-byte chunks each, joined by one shuffle): g dot products
//   on the CUDA cores in fp32, an online softmax per warp, then P V with one
//   channel pair per lane and register, the probabilities read four at a
//   time from the warp's shared row. The heads are a compile-time G (g
//   rounded up to 4 or 8, the rows past g zeros), so no loop over them
//   branches and the reductions of the G heads overlap;
// - more than 8 query heads of one KV head (recurrentgemma-9b's MQA, g 16,
//   contiguous decode only) take ceil(g / 8) clusters of 8 heads each over
//   the same K/V, which the second reads from L2 (a 2048-row ring at hd 256
//   is 1 MB a row);
// - the four warps merge in shared memory; each block then writes its
//   partial (m, l, acc) into a slot of rank 0's shared memory (distributed
//   shared memory, remote stores that do not wait), and after one cluster
//   barrier rank 0 merges the slots and writes the row: one launch, no
//   global scratch, no counters. At hd 256 (the wide walk, contiguous
//   decode only) the ring and the slots together would pass a block's 227
//   KB, so the slots reuse the ring once every block's walk has ended (the
//   blocks arrive at the cluster barrier after their walks, not before),
//   and float32 stages one K/V tile at a time.
// Ragged lists (ragged_split_kernel) run one launch over a per-tick plan
// that the host builds from its own copies of token_rows and token_pos:
// items of (first token, count), one cluster per (item, KV head); the slot
// and first position are token_rows and token_pos of the first token. A
// token's output row is a function of its slot's K/V, its position and
// the pool's capacity and split alone, however the tick packed it: every
// live token's row is the split walk's arithmetic over [0, pos + 1), so it
// is bitwise a paged decode row with cur_len = pos + 1 (the reference's
// per-token grid gives it; its prefix cache and compaction trust "equal
// key => bitwise-equal page", and a restore re-prefills emitted tokens as
// a chunk). A single token (count 1) is the split walk itself. A run of
// up to 16 tokens of one slot at consecutive positions (a prefill chunk,
// cut into pieces of 16) is a run walk (run_walk, bf16): each token
// walking its prefix alone read the slot's pages once per token, 256
// times at a 256-token chunk. The run walk stages its block's whole range
// of the capacity, [r chunk, (r + 1) chunk) cut at the last token's
// length, once for its tokens (the range is at most 4 tiles of 64 at hd
// 128, 8 at hd 64: run_tiles), then walks each token over it with the
// walk's own tile step (walk_tile: the same warps' positions, the same
// fp32 sums on the CUDA cores, the same order), masked at the token's own
// pos + 1; a tile past that end is not walked, as the walk never reaches
// it, and V rows past it read as the zeros the walk stages there. Each
// token's block partial stays in the block's shared memory; after a
// cluster barrier every block merges a share of the run's output elements
// from the cluster's partials (distributed shared memory) with the walk's
// merge, and a second barrier keeps each partial alive until it has been
// read. A run whose range would not fit in shared memory (a capacity past
// 2048 / 4096 positions), and every float32 run, walks its tokens one
// after another in its cluster (the walk, no staging shared). A run of
// dead tokens (pos < 0), of any length, is one item: its blocks share its
// zeros and return. A run's rows take no tensor cores: an mma tile sums
// a row's products in another order than the walk, and the earlier token
// tile of this kernel, which did, cut each run's own visible range over
// the cluster, so a row's bits followed where its chunk began (ROADMAP
// C4).
//
// C interface (ctypes): every pointer and the stream are void*; returns
// cudaGetLastError() after the launch.

#include <cooperative_groups.h>

#include <algorithm>

#include "attention_common.cuh"

namespace {

namespace cg = cooperative_groups;

using attn::kNeg;
using attn::load1;
using attn::store1;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSplitTile = 64;   // kv positions per staged tile
constexpr int kMaxSplit = 8;     // blocks per cluster (the portable most)
constexpr int kRunTokens = 16;   // tokens of a run item at most (the plan's)
constexpr int kPlanWidth = 2;    // ints per plan item
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory a block may have
// Every kernel is declared with __launch_bounds__(kThreads, 1): without a
// least number of blocks per SM, ptxas capped the paged and float32 walks
// at 64-128 registers to raise their occupancy and spilled 16-64 bytes
// each (shared memory holds a walk to 4 blocks an SM anyway).

// The wide walk (hd padded to 256, recurrentgemma's MQA heads: contiguous
// decode only): its ring and merge slots together would pass the 227 KB a
// block may have (244 KB in bf16 at G 8), so the merge space reuses the
// ring once the walk has ended, and float32 stages one K/V tile at a time
// (two would be 266 KB alone)
__host__ __device__ constexpr bool wide_walk(int hdp) { return hdp > 128; }

__host__ __device__ constexpr int walk_stages(size_t elem, int hdp) {
  return wide_walk(hdp) && elem == sizeof(float) ? 1 : 2;
}

// The split walk: K and V tiles (two stages each, or one: walk_stages),
// then in fp32 the G q rows, each warp's probabilities (G x 16) and partial
// (acc, m, l), and a slot per block of the cluster for the block partials
// that rank 0 merges (in the ring for the wide walk); a paged walk's page
// ids follow
__host__ __device__ inline size_t walk_smem_bytes(size_t elem, int hdp,
                                                  int G, int g) {
  const size_t ld = hdp + 16 / elem;
  const size_t part = static_cast<size_t>(g) * (hdp + 2);
  const size_t ring = elem * 2 * walk_stages(elem, hdp) * kSplitTile * ld;
  const size_t q_p = sizeof(float) * static_cast<size_t>(G) *
                     (hdp + kWarps * 16);
  const size_t merge = sizeof(float) * (kWarps + kMaxSplit) * part;
  return ring + q_p + (wide_walk(hdp) ? 0 : merge);
}

// whole tiles of a block's range of `chunk` positions
__host__ __device__ constexpr int run_tiles(int chunk) {
  return (chunk + kSplitTile - 1) / kSplitTile;
}

// The run walk (bf16): K and V of the block's whole range (run_tiles of
// chunk), then the walk's q rows, probabilities and four warp partials,
// then one block partial per token of the run; the slot's page ids follow
__host__ __device__ inline size_t run_smem_bytes(int hdp, int G, int g,
                                                 int chunk) {
  const size_t ld = hdp + 8;
  const size_t part = static_cast<size_t>(g) * (hdp + 2);
  return sizeof(bf16) * 2 * static_cast<size_t>(run_tiles(chunk)) *
             kSplitTile * ld +
         sizeof(float) * (static_cast<size_t>(G) * (hdp + kWarps * 16) +
                          (kWarps + kRunTokens) * part);
}

// the cluster barrier in two halves: arrive without waiting, wait later
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// ... with release semantics: this block's reads of its shared memory are
// done before another block's writes there that follow the wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// 16 bytes of shared row as floats
template <typename T>
__device__ __forceinline__ void load_chunk(const T* p,
                                           float (&f)[16 / sizeof(T)]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  } else {
    attn::load8(p, f);
  }
}

// channels e, e + 1 of a shared row (e even)
template <typename T>
__device__ __forceinline__ float2 load_pair(const T* p) {
  if constexpr (std::is_same<T, float>::value) {
    return *reinterpret_cast<const float2*>(p);
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
}

// kv position p -> element offset of its K/V row from the KV head's channel
// 0: a contiguous cache row, or a paged one through its block table. A walk
// first copies the page ids of its n positions into shared memory
// (to_shared; every thread of the block calls it, and a barrier follows
// before a row is staged), so staging reads no page id from device memory
// and none past the table.
struct ContiguousRows {
  int64_t stride;        // kvh * hd
  static constexpr bool kPaged = false;
  __device__ __forceinline__ int64_t operator()(int p) const {
    return p * stride;
  }
  __device__ __forceinline__ ContiguousRows to_shared(int32_t*, int,
                                                      int) const {
    return *this;
  }
};

struct TableRows {
  const int32_t* table;  // the row's page ids (npages in device memory)
  int block_size;
  int64_t stride;        // kvh * hd
  static constexpr bool kPaged = true;
  __device__ __forceinline__ int64_t operator()(int p) const {
    return (static_cast<int64_t>(table[p / block_size]) * block_size +
            p % block_size) *
           stride;
  }
  __device__ __forceinline__ TableRows to_shared(int32_t* dst, int n,
                                                 int tid) const {
    for (int i = tid; i < (n + block_size - 1) / block_size; i += kThreads) {
      dst[i] = table[i];
    }
    return TableRows{dst, block_size, stride};
  }
};

// K and V rows p0 .. p0 + kSplitTile - 1 into one stage of the ring (rows
// from hi on as zeros)
template <typename T, int HDP, bool VEC, typename Rows>
__device__ __forceinline__ void stage_kv(T* ks, T* vs, const T* kb,
                                         const T* vb, Rows rows, int p0,
                                         int hi, int hd, int tid) {
  attn::stage_rows<T, HDP, kSplitTile, kThreads, VEC>(
      ks, [=](int r) { return kb + rows(p0 + r); }, hi - p0, hd, tid);
  attn::stage_rows<T, HDP, kSplitTile, kThreads, VEC>(
      vs, [=](int r) { return vb + rows(p0 + r); }, hi - p0, hd, tid);
}

// ---------------------------------------------------------------------------
// the split walk: one query token's g heads over n positions, split over
// the cluster
// ---------------------------------------------------------------------------

// One warp's running state of a walk: for each of the G heads the running
// max and sum, and this lane's channel pairs 64 c + 2 lane + {0, 1} of the
// accumulator
template <int HDP, int G>
struct WalkState {
  static constexpr int kC = HDP / 64;
  float m[G], l[G], acc[G][kC][2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      m[gi] = kNeg;
      l[gi] = 0.0f;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[gi][c][0] = acc[gi][c][1] = 0.0f;
    }
  }
};

// The token's G query heads of this KV head into q_s in fp32 (heads past g
// and channels past hd as zeros)
template <typename T, int HDP, int G>
__device__ __forceinline__ void load_q(float* q_s, const T* q_row, int g,
                                       int hd, int tid) {
  for (int i = tid; i < G * HDP; i += kThreads) {
    const int gi = i / HDP;
    const int e = i % HDP;
    q_s[i] = gi < g && e < hd ? load1(q_row + gi * hd + e) : 0.0f;
  }
}

// One staged tile of kSplitTile positions from p0 (kt, vt: its K and V
// rows) into the warp's state, positions from hi on masked: warp w takes
// tile positions 16 w .. 16 w + 15, two lanes a position (half the 16-byte
// chunks each, joined by one shuffle). MASK_V: the V rows from hi on may
// hold data (a run's later positions), so they are read as the zeros that
// the walk's own staging puts there.
template <typename T, int HDP, int G, bool MASK_V>
__device__ __forceinline__ void walk_tile(const T* kt, const T* vt,
                                          const float* q_s, float* pws,
                                          int p0, int hi, float scale,
                                          WalkState<HDP, G>& st, int warp,
                                          int lane) {
  using L = attn::Tile<T, HDP>;
  constexpr int kE = L::kVecE;            // elements per 16-byte chunk
  constexpr int kLd = L::kLd;
  constexpr int kC = HDP / 64;            // channel pairs per lane in P V
  constexpr bool kWide = wide_walk(HDP);
  const int pw = warp * 16 + (lane & 15);  // this lane's tile position
  const int half = lane >> 4;              // ... and its half of the chunks

  // ---- scores of position p0 + pw: this lane's half of the chunks, then
  // the other half's by one shuffle
  float s[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) s[gi] = 0.0f;
#pragma unroll
  for (int cc = 0; cc < HDP / kE / 2; ++cc) {
    const int c = 2 * cc + half;
    float kx[kE];
    load_chunk(kt + pw * kLd + c * kE, kx);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float* qg = q_s + gi * HDP + c * kE;
#pragma unroll
      for (int x = 0; x < kE; x += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qg + x);
        s[gi] = fmaf(qv.x, kx[x], s[gi]);
        s[gi] = fmaf(qv.y, kx[x + 1], s[gi]);
        s[gi] = fmaf(qv.z, kx[x + 2], s[gi]);
        s[gi] = fmaf(qv.w, kx[x + 3], s[gi]);
      }
    }
  }
  // ---- online softmax over the warp's 16 positions (both halves hold
  // the same values, so the reductions stay within 16 lanes); positions
  // past hi get p = 0 (their V rows are zeros)
  const bool valid = p0 + pw < hi;
  float mx[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    s[gi] += __shfl_xor_sync(0xffffffffu, s[gi], 16);
    // (__fmul_rn: never contracted into an fma, so every instance of the
    // walk rounds alike and paged rows stay bitwise contiguous ones)
    s[gi] = valid ? __fmul_rn(s[gi], scale) : kNeg;
    mx[gi] = s[gi];
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      mx[gi] = fmaxf(mx[gi], __shfl_xor_sync(0xffffffffu, mx[gi], o));
    }
  }
  float ps[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const float m_new = fmaxf(st.m[gi], mx[gi]);
    s[gi] = valid ? expf(s[gi] - m_new) : 0.0f;
    ps[gi] = s[gi];
    const float corr = expf(st.m[gi] - m_new);
    st.m[gi] = m_new;
    st.l[gi] = __fmul_rn(st.l[gi], corr);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      st.acc[gi][c][0] = __fmul_rn(st.acc[gi][c][0], corr);
      st.acc[gi][c][1] = __fmul_rn(st.acc[gi][c][1], corr);
    }
    if (half == 0) pws[gi * 16 + (lane & 15)] = s[gi];
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      ps[gi] += __shfl_xor_sync(0xffffffffu, ps[gi], o);
    }
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi) st.l[gi] += ps[gi];
  __syncwarp();
  // ---- acc[gi][channels 64 c + 2 lane + {0, 1}] += p[gi][j] v[j], four
  // positions at a time (kJv V rows in registers at once: four, or one
  // in the wide walk, whose eight channel pairs a lane would hold 64
  // registers of V)
  constexpr int kJv = kWide ? 1 : 4;
#pragma unroll
  for (int j0 = 0; j0 < 16; j0 += 4) {
#pragma unroll
    for (int jv = 0; jv < 4; jv += kJv) {
      float2 vv[kJv][kC];
#pragma unroll
      for (int j = 0; j < kJv; ++j) {
        const int r = warp * 16 + j0 + jv + j;
        const T* vr = vt + r * kLd + 2 * lane;
        const bool v_ok = !MASK_V || p0 + r < hi;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          vv[j][c] = v_ok ? load_pair(vr + 64 * c) : make_float2(0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(pws + gi * 16 + j0);
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int j = 0; j < kJv; ++j) {
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            st.acc[gi][c][0] =
                fmaf(pj[jv + j], vv[j][c].x, st.acc[gi][c][0]);
            st.acc[gi][c][1] =
                fmaf(pj[jv + j], vv[j][c].y, st.acc[gi][c][1]);
          }
        }
      }
    }
  }
}

// A warp's state into its share of the four warps' partials: w_m, w_l
// (kWarps x g) and w_acc (kWarps x g x HDP)
template <int HDP, int G>
__device__ __forceinline__ void store_warp_partial(
    const WalkState<HDP, G>& st, float* w_m, float* w_l, float* w_acc, int g,
    int warp, int lane) {
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi < g) {
      if (lane == 0) {
        w_m[warp * g + gi] = st.m[gi];
        w_l[warp * g + gi] = st.l[gi];
      }
      float* wa = w_acc + (warp * g + gi) * HDP + 2 * lane;
#pragma unroll
      for (int c = 0; c < WalkState<HDP, G>::kC; ++c) {
        wa[64 * c] = st.acc[gi][c][0];
        wa[64 * c + 1] = st.acc[gi][c][1];
      }
    }
  }
}

// The four warps' partials -> the block's partial in `slot` (this block's
// or another's shared memory): acc (g x HDP), then m (g), then l (g)
template <int HDP>
__device__ __forceinline__ void store_block_partial(float* slot,
                                                    const float* w_m,
                                                    const float* w_l,
                                                    const float* w_acc, int g,
                                                    int tid) {
  for (int i = tid; i < g * HDP; i += kThreads) {
    const int gi = i / HDP;
    float mx = kNeg;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, w_m[w * g + gi]);
    float sum = 0.0f, a = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(w_m[w * g + gi] - mx);
      sum = fmaf(w_l[w * g + gi], f, sum);
      a = fmaf(w_acc[w * g * HDP + i], f, a);
    }
    slot[i] = a;
    if (i % HDP == 0) {
      slot[g * HDP + gi] = mx;
      slot[g * HDP + g + gi] = sum;
    }
  }
}

// Element (gi, e) of a row from the cluster's block partials, slot(r)
// being block r's (acc, m, l)
template <int HDP, typename Slot>
__device__ __forceinline__ float merge_partials(Slot slot, int split, int g,
                                                int gi, int e) {
  float pm[kMaxSplit];
  float mx = kNeg;
#pragma unroll
  for (int r = 0; r < kMaxSplit; ++r) {
    pm[r] = r < split ? slot(r)[g * HDP + gi] : kNeg;
    mx = fmaxf(mx, pm[r]);
  }
  float sum = 0.0f, a = 0.0f;
#pragma unroll
  for (int r = 0; r < kMaxSplit; ++r) {
    if (r < split) {
      const float f = expf(pm[r] - mx);
      sum = fmaf(slot(r)[g * HDP + g + gi], f, sum);
      a = fmaf(slot(r)[gi * HDP + e], f, a);
    }
  }
  return a / fmaxf(sum, 1e-30f);
}

// This block's share (rank r of `split`: positions [r chunk, (r + 1)
// chunk), cut at n) of one walk; rank 0 writes the g heads to out_row.
// q_row: the token's g query heads of this KV head (g * hd, contiguous);
// kb, vb: channel 0 of this KV head at offset 0; rows: position -> offset.
// HDP: hd padded to 64, 128 or 256 (the wide walk). G: g rounded up to 4
// or 8; the rows past g are zeros, so every loop over the heads runs
// without a branch. Every block of the cluster calls it with the same n.
template <typename T, bool VEC, int HDP, int G, typename Rows>
__device__ __forceinline__ void split_walk(const T* __restrict__ q_row,
                                           const T* __restrict__ kb,
                                           const T* __restrict__ vb, Rows rows,
                                           int n, T* __restrict__ out_row,
                                           int g, int hd, int split, int chunk,
                                           float scale) {
  using L = attn::Tile<T, HDP>;
  constexpr int kLd = L::kLd;
  constexpr bool kWide = wide_walk(HDP);
  constexpr int kStages = walk_stages(sizeof(T), HDP);
  static_assert(!kWide || sizeof(float) * (kWarps + kMaxSplit) * G *
                                 (HDP + 2) <=
                             sizeof(T) * 2 * kStages * kSplitTile * kLd,
                "the wide walk's merge space fits in its ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);          // kStages x kSplitTile
  T* v_s = k_s + kStages * kSplitTile * kLd;         // kStages x kSplitTile
  float* q_s = reinterpret_cast<float*>(v_s + kStages * kSplitTile * kLd);
  float* p_s = q_s + G * HDP;                        // kWarps x G x 16
  // the merge space: after the probabilities, or (wide) over the ring
  float* w_acc = kWide ? reinterpret_cast<float*>(smem_raw)
                       : p_s + kWarps * G * 16;      // kWarps x g x HDP
  float* w_m = w_acc + kWarps * g * HDP;             // kWarps x g
  float* w_l = w_m + kWarps * g;                     // kWarps x g
  // kMaxSplit slots of (acc g x HDP, m g, l g): rank 0's receive the blocks'
  // partials
  float* parts = w_l + kWarps * g;
  const int part = g * (HDP + 2);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (n <= 0) {        // every block of the cluster returns here: no barrier
    if (rank == 0) {
      for (int i = tid; i < g * hd; i += kThreads) store1(out_row + i, 0.0f);
    }
    return;
  }
  // this block has started (see cluster_wait); the wide walk arrives once
  // its walk has ended, for its ring then takes the merge slots
  if constexpr (!kWide) cluster_arrive_relaxed();
  const int lo = min(rank * chunk, n);
  const int hi = min(lo + chunk, n);
  const int n_tiles = (hi - lo + kSplitTile - 1) / kSplitTile;
  const Rows srows = rows.to_shared(
      reinterpret_cast<int32_t*>(smem_raw + walk_smem_bytes(sizeof(T), HDP,
                                                            G, g)),
      n, tid);
  if constexpr (Rows::kPaged) __syncthreads();
  if (n_tiles > 0) {
    stage_kv<T, HDP, VEC>(k_s, v_s, kb, vb, srows, lo, hi, hd, tid);
  }
  attn::cp_async_commit();
  load_q<T, HDP, G>(q_s, q_row, g, hd, tid);

  WalkState<HDP, G> st;
  st.init();
  float* pws = p_s + warp * G * 16;        // this warp's probabilities

  for (int t = 0; t < n_tiles; ++t) {
    if constexpr (kStages == 2) {
      if (t + 1 < n_tiles) {
        const int p1 = lo + (t + 1) * kSplitTile;
        const int s1 = ((t + 1) & 1) * kSplitTile * kLd;
        stage_kv<T, HDP, VEC>(k_s + s1, v_s + s1, kb, vb, srows, p1, hi, hd,
                              tid);
      }
      attn::cp_async_commit();
      attn::cp_async_wait<1>();           // tile t has landed
    } else {
      attn::cp_async_wait<0>();           // tile t has landed
    }
    __syncthreads();                      // (and q_s, on the first pass)
    const int s0 = (t % kStages) * kSplitTile * kLd;
    walk_tile<T, HDP, G, false>(k_s + s0, v_s + s0, q_s, pws,
                                lo + t * kSplitTile, hi, scale, st, warp,
                                lane);
    __syncthreads();                      // stage t % kStages is free again
    if constexpr (kStages == 1) {
      if (t + 1 < n_tiles) {
        stage_kv<T, HDP, VEC>(k_s, v_s, kb, vb, srows,
                              lo + (t + 1) * kSplitTile, hi, hd, tid);
      }
      attn::cp_async_commit();
    }
  }
  attn::cp_async_wait<0>();
  if constexpr (kWide) cluster_arrive();   // the ring is free

  // ---- the four warps' partials -> the block's partial, into its slot of
  // rank 0's shared memory once every block of the cluster has started
  store_warp_partial<HDP, G>(st, w_m, w_l, w_acc, g, warp, lane);
  cluster_wait();
  __syncthreads();
  store_block_partial<HDP>(cluster.map_shared_rank(parts, 0) + rank * part,
                           w_m, w_l, w_acc, g, tid);

  // ---- the cluster's partials -> the row, by rank 0 from its own shared
  // memory, once every block's partial has landed there
  cluster.sync();
  if (rank != 0) return;
  for (int i = tid; i < g * hd; i += kThreads) {
    store1(out_row + i,
           merge_partials<HDP>([&](int r) { return parts + r * part; },
                               split, g, i / hd, i % hd));
  }
}

// ---------------------------------------------------------------------------
// the run walk: up to 16 tokens of one slot at consecutive positions
// p0 .. p0 + cnt - 1 (bf16), each walked as a single token over K/V
// staged once for all of them
// ---------------------------------------------------------------------------

// This block's share of the run (rank r of `split`: positions [r chunk,
// (r + 1) chunk) of the capacity, cut at each token's own pos + 1): the
// range of the last token is staged whole (run_tiles(chunk) tiles at
// most); token j's G heads then take the split walk's tile steps over its
// own tiles of it, and its block partial stays in this block's shared
// memory; after a cluster barrier every block merges a share of the run's
// output elements from the cluster's partials with the walk's merge. q and
// out hold hq elements per token; head0: this KV head's first query head's
// offset in a token's row.
template <int HDP, int G, bool VEC>
__device__ __forceinline__ void run_walk(const bf16* __restrict__ q,
                                         const bf16* __restrict__ kb,
                                         const bf16* __restrict__ vb,
                                         TableRows rows,
                                         bf16* __restrict__ out, int t0,
                                         int cnt, int p0, int64_t head0,
                                         int64_t hq, int g, int hd, int cap,
                                         int split, int chunk, float scale) {
  constexpr int kLd = attn::Tile<bf16, HDP>::kLd;
  const int tiles = run_tiles(chunk);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);     // tiles x kSplitTile
  bf16* v_s = k_s + tiles * kSplitTile * kLd;         // tiles x kSplitTile
  float* q_s = reinterpret_cast<float*>(v_s + tiles * kSplitTile * kLd);
  float* p_s = q_s + G * HDP;                         // kWarps x G x 16
  float* w_acc = p_s + kWarps * G * 16;               // kWarps x g x HDP
  float* w_m = w_acc + kWarps * g * HDP;              // kWarps x g
  float* w_l = w_m + kWarps * g;                      // kWarps x g
  float* parts = w_l + kWarps * g;                    // cnt x (acc, m, l)
  const int part = g * (HDP + 2);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = min(p0 + cnt, cap);       // the last token's visible count
  const int lo = min(rank * chunk, n);
  const int hi = min(lo + chunk, n);
  rows = rows.to_shared(
      reinterpret_cast<int32_t*>(smem_raw + run_smem_bytes(HDP, G, g,
                                                           chunk)),
      n, tid);
  __syncthreads();
  for (int t = 0; t < (hi - lo + kSplitTile - 1) / kSplitTile; ++t) {
    stage_kv<bf16, HDP, VEC>(k_s + t * kSplitTile * kLd,
                             v_s + t * kSplitTile * kLd, kb, vb, rows,
                             lo + t * kSplitTile, hi, hd, tid);
  }
  attn::cp_async_commit();
  attn::cp_async_wait<0>();
  float* pws = p_s + warp * G * 16;       // this warp's probabilities
  for (int j = 0; j < cnt; ++j) {
    // token j's own range in this block: the walk's lo and hi at its n
    // (lo itself, or empty)
    const int nj = min(p0 + j + 1, cap);
    const int loj = min(rank * chunk, nj);
    const int hij = min(loj + chunk, nj);
    load_q<bf16, HDP, G>(q_s, q + (t0 + j) * hq + head0, g, hd, tid);
    __syncthreads();                      // (the staged tiles, on j = 0)
    WalkState<HDP, G> st;
    st.init();
    for (int t = 0; t < (hij - loj + kSplitTile - 1) / kSplitTile; ++t) {
      walk_tile<bf16, HDP, G, true>(k_s + t * kSplitTile * kLd,
                                    v_s + t * kSplitTile * kLd, q_s, pws,
                                    loj + t * kSplitTile, hij, scale, st,
                                    warp, lane);
      __syncwarp();                       // pws read before it is rewritten
    }
    store_warp_partial<HDP, G>(st, w_m, w_l, w_acc, g, warp, lane);
    __syncthreads();
    store_block_partial<HDP>(parts + j * part, w_m, w_l, w_acc, g, tid);
    __syncthreads();                      // q_s and the warp partials free
  }
  cluster.sync();                         // every partial is in place

  // ---- this block's share of the run's output: every split-th run of
  // kThreads elements
  const int row = g * hd;
  for (int i = rank * kThreads + tid; i < cnt * row; i += split * kThreads) {
    const int j = i / row;
    const int r = i % row;
    out[(t0 + j) * hq + head0 + r] = __float2bfloat16_rn(merge_partials<HDP>(
        [&](int rr) { return cluster.map_shared_rank(parts + j * part, rr); },
        split, g, r / hd, r % hd));
  }
  cluster.sync();                         // no partial leaves while read
}

// ---------------------------------------------------------------------------
// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// Contiguous (PAGED false: caches (b, cap, kvh, hd)) or paged (PAGED true:
// pages through block_tables (b, npages), cap = npages * block_size) decode:
// cluster (b, kh, group) of `split` blocks walks row b's n = min(cur_len[b],
// cap) positions for query heads G group .. G group + G - 1 of KV head kh
// (groups = ceil(g / G): one where g <= 8; recurrentgemma's g 16 takes two
// clusters of 8 heads, which read the same K/V, the second from L2).
template <typename T, bool VEC, int HDP, int G, bool PAGED>
__global__ void __launch_bounds__(kThreads, 1)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ cur_len, T* __restrict__ out,
                    int cap, int kvh, int g, int hd, int block_size,
                    int npages, int groups, int split, int chunk,
                    float scale) {
  const int64_t id = blockIdx.x / split;            // (b * kvh + kh, group)
  const int group = static_cast<int>(id % groups);
  const int64_t row = id / groups;                  // b * kvh + kh
  const int64_t bi = row / kvh;
  const int kh = static_cast<int>(row % kvh);
  const int64_t stride = static_cast<int64_t>(kvh) * hd;
  const int n = min(cur_len[bi], cap);
  const int64_t head0 = row * g + G * group;
  const int gc = min(G, g - G * group);             // this cluster's heads
  const T* q_row = q + head0 * hd;
  T* out_row = out + head0 * hd;
  if constexpr (PAGED) {
    split_walk<T, VEC, HDP, G>(
        q_row, k + kh * hd, v + kh * hd,
        TableRows{block_tables + bi * npages, block_size, stride}, n, out_row,
        gc, hd, split, chunk, scale);
  } else {
    const int64_t base = bi * cap * stride + kh * hd;
    split_walk<T, VEC, HDP, G>(q_row, k + base, v + base,
                               ContiguousRows{stride}, n, out_row, gc, hd,
                               split, chunk, scale);
  }
}

// A ragged list by its plan: cluster (item, kh) of `split` blocks. An item
// whose first token is dead is a dead run and gives zeros; a single token
// walks its slot's table to pos + 1; a run of 2-16 tokens is a run walk
// when `runs` (bf16, and the block's range fits in shared memory), else
// its tokens walk one after another. Every decision is the same for every
// block of a cluster, so a cluster returns or meets its barriers as one.
template <typename T, bool VEC, int HDP, int G>
__global__ void __launch_bounds__(kThreads, 1)
ragged_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ token_rows,
                    const int32_t* __restrict__ token_pos,
                    const int32_t* __restrict__ plan, T* __restrict__ out,
                    int kvh, int g, int hd, int block_size, int npages,
                    int split, int chunk, int runs, float scale) {
  const int64_t id = blockIdx.x / split;            // (item, kh)
  const int kh = static_cast<int>(id % kvh);
  const int32_t* item = plan + id / kvh * kPlanWidth;
  const int t0 = item[0];
  const int cnt = item[1];
  const int p0 = token_pos[t0];
  const int cap = npages * block_size;
  const int64_t stride = static_cast<int64_t>(kvh) * hd;
  const int64_t hq = static_cast<int64_t>(kvh) * g * hd;   // per token
  const T* kb = k + kh * hd;
  const T* vb = v + kh * hd;
  const int64_t head0 = static_cast<int64_t>(kh) * g * hd;
  if (p0 < 0) {        // a dead run: zeros; every block returns, no barrier
    const int rank = static_cast<int>(cg::this_cluster().block_rank());
    for (int i = rank * kThreads + threadIdx.x; i < cnt * g * hd;
         i += split * kThreads) {
      store1(out + (t0 + i / (g * hd)) * hq + head0 + i % (g * hd), 0.0f);
    }
    return;
  }
  if constexpr (std::is_same<T, bf16>::value) {
    if (cnt > 1 && runs) {
      run_walk<HDP, G, VEC>(
          q, kb, vb,
          TableRows{
              block_tables + static_cast<int64_t>(token_rows[t0]) * npages,
              block_size, stride},
          out, t0, cnt, p0, head0, hq, g, hd, cap, split, chunk, scale);
      return;
    }
  }
  for (int j = 0; j < cnt; ++j) {
    const int64_t t = t0 + j;
    if (j > 0) __syncthreads();
    split_walk<T, VEC, HDP, G>(
        q + t * hq + head0, kb, vb,
        TableRows{block_tables + static_cast<int64_t>(token_rows[t]) * npages,
                  block_size, stride},
        min(token_pos[t] + 1, cap), out + t * hq + head0, g, hd, split, chunk,
        scale);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// `blocks` blocks in clusters of `split` (cudaLaunchKernelEx)
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int64_t blocks,
                            int split, size_t smem, cudaStream_t stream,
                            Args... args) {
  if (split < 1 || split > kMaxSplit) return cudaErrorInvalidValue;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool VEC, int HDP, int G, bool PAGED>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const void* block_tables, const void* cur_len,
                          void* out, int b, int cap, int kvh, int g, int hd,
                          int block_size, int npages, int split, float scale,
                          cudaStream_t stream) {
  const int groups = (g + G - 1) / G;
  return launch_clusters(
      decode_split_kernel<T, VEC, HDP, G, PAGED>,
      int64_t{b} * kvh * groups * split, split,
      walk_smem_bytes(sizeof(T), HDP, G, std::min(g, G)) +
          (PAGED ? sizeof(int32_t) * npages : 0),
      stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(cur_len), static_cast<T*>(out), cap, kvh, g,
      hd, block_size, npages, groups, split, (cap + split - 1) / split,
      scale);
}

// One launcher per form, each templated on the element type, the load
// width, the padded hd and the padded head count. kWide: whether the form
// has instances at hd 256 (contiguous decode only; the paged and ragged
// walks serve no such stack: the reference pages no recurrent or
// sliding-window model).
template <typename T, bool VEC, int HDP, int G>
struct Contiguous {
  static constexpr bool kWide = true;
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* cur_len, void* out, int b, int S,
                         int kvh, int g, int hd, int split, float scale,
                         cudaStream_t stream) {
    return launch_decode<T, VEC, HDP, G, false>(q, k, v, nullptr, cur_len,
                                                out, b, S, kvh, g, hd, 1, 0,
                                                split, scale, stream);
  }
};

template <typename T, bool VEC, int HDP, int G>
struct Paged {
  static constexpr bool kWide = false;
  static cudaError_t run(const void* q, const void* k_pages,
                         const void* v_pages, const void* block_tables,
                         const void* cur_len, void* out, int b, int kvh,
                         int g, int hd, int block_size, int npages, int split,
                         float scale, cudaStream_t stream) {
    return launch_decode<T, VEC, HDP, G, true>(
        q, k_pages, v_pages, block_tables, cur_len, out, b,
        npages * block_size, kvh, g, hd, block_size, npages, split, scale,
        stream);
  }
};

template <typename T, bool VEC, int HDP, int G>
struct Ragged {
  static constexpr bool kWide = false;
  // Runs share their staged K/V (run_walk) in bf16 when the plan holds an
  // item of more than one token (n_items < T) and the block's range fits
  // in shared memory; the launch then takes the run walk's shared memory.
  static cudaError_t run(const void* q, const void* k_pages,
                         const void* v_pages, const void* block_tables,
                         const void* token_rows, const void* token_pos,
                         const void* plan, void* out, int T_, int n_items,
                         int kvh, int g, int hd, int block_size, int npages,
                         int split, float scale, cudaStream_t stream) {
    if (n_items < 1 || n_items > T_) return cudaErrorInvalidValue;
    const int cap = npages * block_size;
    const int chunk = (cap + split - 1) / split;
    const size_t ids = sizeof(int32_t) * npages;  // the page ids of a walk
    size_t smem = walk_smem_bytes(sizeof(T), HDP, G, g) + ids;
    const size_t run_smem = run_smem_bytes(HDP, G, g, chunk) + ids;
    const int runs = std::is_same<T, bf16>::value && n_items < T_ &&
                     run_smem <= kMaxSmem;
    if (runs) smem = std::max(smem, run_smem);
    return launch_clusters(
        ragged_split_kernel<T, VEC, HDP, G>, int64_t{n_items} * kvh * split,
        split, smem, stream, static_cast<const T*>(q),
        static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
        static_cast<const int32_t*>(block_tables),
        static_cast<const int32_t*>(token_rows),
        static_cast<const int32_t*>(token_pos),
        static_cast<const int32_t*>(plan), static_cast<T*>(out), kvh, g, hd,
        block_size, npages, split, chunk, runs, scale);
  }
};

// pick the element type, the load width, hd padded to 64, 128 or (kWide
// forms) 256 and g to 4 or 8 (more than 8 heads: clusters of 8)
template <template <typename, bool, int, int> class F, typename T, int HDP,
          typename... Args>
cudaError_t dispatch_g(int vec, int g, Args... args) {
  if (g <= 4) {
    return vec ? F<T, true, HDP, 4>::run(args...)
               : F<T, false, HDP, 4>::run(args...);
  }
  return vec ? F<T, true, HDP, 8>::run(args...)
             : F<T, false, HDP, 8>::run(args...);
}

template <template <typename, bool, int, int> class F, typename... Args>
cudaError_t dispatch(int bf16_, int vec, int hd, int g, Args... args) {
  if (hd > 128) {
    if constexpr (F<float, true, 64, 4>::kWide) {
      return bf16_ ? dispatch_g<F, bf16, 256>(vec, g, args...)
                   : dispatch_g<F, float, 256>(vec, g, args...);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  if (bf16_) {
    return hd <= 64 ? dispatch_g<F, bf16, 64>(vec, g, args...)
                    : dispatch_g<F, bf16, 128>(vec, g, args...);
  }
  return hd <= 64 ? dispatch_g<F, float, 64>(vec, g, args...)
                  : dispatch_g<F, float, 128>(vec, g, args...);
}

}  // namespace

// q (b, kvh * g, hd); k, v (b, S, kvh, hd); cur_len (b,) int32; out like q.
// hd <= 256; g <= 16 (more than 8 heads of a KV head take clusters of 8).
// split: blocks per (row, KV head, group of heads) cluster, 1 .. 8. bf16 picks bf16 (1) or
// float32 (0) for q, the caches and out. vec: 1 when hd % 8 == 0 and the
// cache pointers are 16-byte aligned.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* cur_len, void* out, int b, int S,
                                int kvh, int g, int hd, int split,
                                float scale, int bf16, int vec,
                                void* stream) {
  return static_cast<int>(dispatch<Contiguous>(
      bf16, vec, hd, g, q, k, v, cur_len, out, b, S, kvh, g, hd, split, scale,
      static_cast<cudaStream_t>(stream)));
}

// q (b, kvh * g, hd); k_pages, v_pages (num_blocks, block_size, kvh, hd);
// block_tables (b, npages) and cur_len (b,) int32; out like q. split:
// blocks per cluster, as above over the capacity npages * block_size. bf16
// and vec as above (vec: the page pointers 16-byte aligned).
extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_tables,
                                      const void* cur_len, void* out, int b,
                                      int kvh, int g, int hd, int block_size,
                                      int npages, int split, float scale,
                                      int bf16, int vec, void* stream) {
  return static_cast<int>(dispatch<Paged>(
      bf16, vec, hd, g, q, k_pages, v_pages, block_tables, cur_len, out, b,
      kvh, g, hd, block_size, npages, split, scale,
      static_cast<cudaStream_t>(stream)));
}

// q (T, kvh * g, hd) packed tokens; k_pages, v_pages (num_blocks,
// block_size, kvh, hd); block_tables (num_slots, npages), token_rows and
// token_pos (T,) int32; plan (n_items, 2) int32, rows of (first token,
// count) covering tokens 0 .. T - 1 once each in order: a dead first token
// a run of dead tokens, count 1 a single token, else a run of count <= 16
// live tokens of the first token's slot at consecutive positions; out like
// q. split, bf16 and vec as above. Each live token's row is bitwise the
// paged decode row of its slot with cur_len = pos + 1, however packed.
extern "C" int ragged_paged_attention(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_tables,
                                      const void* token_rows,
                                      const void* token_pos, const void* plan,
                                      void* out, int T, int n_items, int kvh,
                                      int g, int hd, int block_size,
                                      int npages, int split, float scale,
                                      int bf16, int vec, void* stream) {
  return static_cast<int>(dispatch<Ragged>(
      bf16, vec, hd, g, q, k_pages, v_pages, block_tables, token_rows,
      token_pos, plan, out, T, n_items, kvh, g, hd, block_size, npages, split,
      scale, static_cast<cudaStream_t>(stream)));
}
