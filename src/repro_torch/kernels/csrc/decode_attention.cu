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
// share them: 16 tokens x g heads per K/V tile make a tensor-core product.
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
//   aligned); hd is padded with zeros to 64 or 128 in shared memory. Each
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
// - the four warps merge in shared memory; each block then writes its
//   partial (m, l, acc) into a slot of rank 0's shared memory (distributed
//   shared memory, remote stores that do not wait), and after one cluster
//   barrier rank 0 merges the slots and writes the row: one launch, no
//   global scratch, no counters.
// Ragged lists (ragged_split_kernel) run one launch over a per-tick plan
// that the host builds from its own copies of token_rows and token_pos:
// items of (first token, count), one cluster per (item, KV head, group of
// four query heads); the slot and first position are token_rows and
// token_pos of the first token. A
// single token (count 1) is the split walk of its slot's table to pos + 1:
// bitwise a paged decode row with cur_len = pos + 1. A run of up to 16 tokens of one slot at
// consecutive positions (a prefill chunk, cut into pieces of 16) is one
// token tile (token_tile): each token walking its prefix alone read the
// slot's pages once per token, 256 times at a 256-token chunk, with one
// query row at a time on the CUDA cores. The tile reads them once:
// - warp w owns query head 4 group + w of the item's 16 tokens, so each
//   warp's 16 rows are one m16 tile of mma.sync.m16n8k16 (bf16 in, fp32
//   sums) against the K/V tiles the four warps share; a single token would
//   fill 1 of those 16 rows;
// - S = Q K^T and P V take flash_mma_kernel's fragments (ldmatrix, P in
//   three bf16 parts, a tile accumulator at hd <= 64), staged through the
//   block table as above; the tile's visible positions (not the capacity)
//   are cut into whole kv tiles shared evenly by the cluster's blocks, so
//   no block idles at the barriers while another walks a chunk's prefix;
// - the causal mask (kv position <= the row's own) runs only on kv tiles
//   that cross the first token's position or the range's end; rows of
//   missing tokens (a run shorter than 16) are zeros and never stored;
// - each block leaves its partial in its own shared memory; after a
//   cluster barrier every block merges a share of the output elements,
//   reading the others' partials (distributed shared memory), and a second
//   barrier keeps each partial alive until it has been read;
// - a run of dead tokens (pos < 0), of any length, is one item: group 0's
//   blocks share its zeros and return. Single tokens and float32 runs use
//   group 0 only (at g > 4 group 1's clusters return at once; no served
//   model has g > 4, and one cluster taking both groups' tiles in turn
//   spilled at hd 128).
// float32 keeps every token on the split walk (mma.sync has no fp32 input
// short of TF32, which would miss fp32's 2e-5 tolerance): a run's tokens
// walk one after another in their cluster. No served path runs fp32
// attention.
//
// C interface (ctypes): every pointer and the stream are void*; returns
// cudaGetLastError() after the launch.

#include <cooperative_groups.h>

#include <algorithm>

#include "attention_common.cuh"

namespace {

namespace cg = cooperative_groups;

using attn::kNeg;
using attn::ldsm_x4;
using attn::ldsm_x4_trans;
using attn::load1;
using attn::mma_bf16;
using attn::quad_max;
using attn::quad_sum;
using attn::split3_bf16;
using attn::store1;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSplitTile = 64;   // kv positions per staged tile
constexpr int kMaxSplit = 8;     // blocks per cluster (the portable most)
constexpr int kTileRows = 16;    // tokens of a token tile (one m16 tile)
constexpr int kPlanWidth = 2;    // ints per plan item
// Every kernel is declared with __launch_bounds__(kThreads, 1): without a
// least number of blocks per SM, ptxas capped the paged and float32 walks
// at 64-128 registers to raise their occupancy and spilled 16-64 bytes
// each (shared memory holds a walk to 4 blocks an SM anyway); asking for 3
// blocks (170 registers) made the bf16 token tile at hd 64 spill.

// The split walk: K and V tiles (two stages each), then in fp32 the G q
// rows, each warp's probabilities (G x 16) and partial (acc, m, l), and a
// slot per block of the cluster for the block partials that rank 0 merges
// (a paged walk's page ids follow)
__host__ __device__ inline size_t walk_smem_bytes(size_t elem, int hdp,
                                                  int G, int g) {
  const size_t ld = hdp + 16 / elem;
  const size_t part = static_cast<size_t>(g) * (hdp + 2);
  return elem * 2 * 2 * kSplitTile * ld +
         sizeof(float) * (static_cast<size_t>(G) * (hdp + kWarps * 16) +
                          (kWarps + kMaxSplit) * part);
}

// The token tile (bf16): the same K/V ring, then the four warps' 16 q rows;
// the block's partial (fp32 acc, m, l of 64 rows) reuses the ring and the
// merge weights the q rows (the slot's page ids follow)
__host__ __device__ inline size_t tile_smem_bytes(int hdp) {
  const size_t ld = hdp + 8;
  return sizeof(bf16) * ld * (2 * 2 * kSplitTile + kWarps * kTileRows);
}

// the cluster barrier in two halves: arrive without waiting, wait later
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
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

// This block's share (rank r of `split`: positions [r chunk, (r + 1)
// chunk), cut at n) of one walk; rank 0 writes the g heads to out_row.
// q_row: the token's g query heads of this KV head (g * hd, contiguous);
// kb, vb: channel 0 of this KV head at offset 0; rows: position -> offset.
// HDP: hd padded to 64 or 128. G: g rounded up to 4 or 8; the rows past g
// are zeros, so every loop over the heads runs without a branch. Every
// block of the cluster calls it with the same n.
template <typename T, bool VEC, int HDP, int G, typename Rows>
__device__ __forceinline__ void split_walk(const T* __restrict__ q_row,
                                           const T* __restrict__ kb,
                                           const T* __restrict__ vb, Rows rows,
                                           int n, T* __restrict__ out_row,
                                           int g, int hd, int split, int chunk,
                                           float scale) {
  using L = attn::Tile<T, HDP>;
  constexpr int kE = L::kVecE;            // elements per 16-byte chunk
  constexpr int kLd = L::kLd;
  constexpr int kC = HDP / 64;            // channel pairs per lane in P V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);          // 2 x kSplitTile rows
  T* v_s = k_s + 2 * kSplitTile * kLd;               // 2 x kSplitTile rows
  float* q_s = reinterpret_cast<float*>(v_s + 2 * kSplitTile * kLd);
  float* p_s = q_s + G * HDP;                        // kWarps x G x 16
  float* w_acc = p_s + kWarps * G * 16;              // kWarps x g x HDP
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
  cluster_arrive_relaxed();   // this block has started (see cluster_wait)
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
  for (int i = tid; i < G * HDP; i += kThreads) {
    const int gi = i / HDP;
    const int e = i % HDP;
    q_s[i] = gi < g && e < hd ? load1(q_row + gi * hd + e) : 0.0f;
  }

  float m[G], l[G], acc[G][kC][2];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNeg;
    l[gi] = 0.0f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[gi][c][0] = acc[gi][c][1] = 0.0f;
  }
  const int pw = warp * 16 + (lane & 15);  // this lane's tile position
  const int half = lane >> 4;              // ... and its half of the chunks
  float* pws = p_s + warp * G * 16;        // this warp's probabilities

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int p1 = lo + (t + 1) * kSplitTile;
      const int st = ((t + 1) & 1) * kSplitTile * kLd;
      stage_kv<T, HDP, VEC>(k_s + st, v_s + st, kb, vb, srows, p1, hi, hd,
                            tid);
    }
    attn::cp_async_commit();
    attn::cp_async_wait<1>();             // tile t has landed
    __syncthreads();                      // (and q_s, on the first pass)
    const int p0 = lo + t * kSplitTile;
    const T* kt = k_s + (t & 1) * kSplitTile * kLd;
    const T* vt = v_s + (t & 1) * kSplitTile * kLd;

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
      const float m_new = fmaxf(m[gi], mx[gi]);
      s[gi] = valid ? expf(s[gi] - m_new) : 0.0f;
      ps[gi] = s[gi];
      const float corr = expf(m[gi] - m_new);
      m[gi] = m_new;
      l[gi] = __fmul_rn(l[gi], corr);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        acc[gi][c][0] = __fmul_rn(acc[gi][c][0], corr);
        acc[gi][c][1] = __fmul_rn(acc[gi][c][1], corr);
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
    for (int gi = 0; gi < G; ++gi) l[gi] += ps[gi];
    __syncwarp();
    // ---- acc[gi][channels 64 c + 2 lane + {0, 1}] += p[gi][j] v[j], four
    // positions at a time
#pragma unroll
    for (int j0 = 0; j0 < 16; j0 += 4) {
      float2 vv[4][kC];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T* vr = vt + (warp * 16 + j0 + j) * kLd + 2 * lane;
#pragma unroll
        for (int c = 0; c < kC; ++c) vv[j][c] = load_pair(vr + 64 * c);
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float4 p4 = *reinterpret_cast<const float4*>(pws + gi * 16 + j0);
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            acc[gi][c][0] = fmaf(pj[j], vv[j][c].x, acc[gi][c][0]);
            acc[gi][c][1] = fmaf(pj[j], vv[j][c].y, acc[gi][c][1]);
          }
        }
      }
    }
    __syncthreads();                      // stage t & 1 is free again
  }
  attn::cp_async_wait<0>();

  // ---- the four warps' partials -> the block's partial
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi < g) {
      if (lane == 0) {
        w_m[warp * g + gi] = m[gi];
        w_l[warp * g + gi] = l[gi];
      }
      float* wa = w_acc + (warp * g + gi) * HDP + 2 * lane;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        wa[64 * c] = acc[gi][c][0];
        wa[64 * c + 1] = acc[gi][c][1];
      }
    }
  }
  // every block of the cluster has started, so rank 0's shared memory may
  // be written
  cluster_wait();
  __syncthreads();
  float* slot = cluster.map_shared_rank(parts, 0) + rank * part;
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

  // ---- the cluster's partials -> the row, by rank 0 from its own shared
  // memory, once every block's partial has landed there
  cluster.sync();
  if (rank != 0) return;
  for (int i = tid; i < g * hd; i += kThreads) {
    const int gi = i / hd;
    const int e = i % hd;
    float pm[kMaxSplit];
    float mx = kNeg;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      pm[r] = r < split ? parts[r * part + g * HDP + gi] : kNeg;
      mx = fmaxf(mx, pm[r]);
    }
    float sum = 0.0f, a = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      if (r < split) {
        const float f = expf(pm[r] - mx);
        sum = fmaf(parts[r * part + g * HDP + g + gi], f, sum);
        a = fmaf(parts[r * part + gi * HDP + e], f, a);
      }
    }
    store1(out_row + i, a / fmaxf(sum, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// the token tile: up to 16 tokens of one slot at consecutive positions
// p0 .. p0 + cnt - 1, four of their query heads, on the tensor cores (bf16)
// ---------------------------------------------------------------------------

// This block's share of one tile (rank r of `split`: the r-th run of whole
// kv tiles of the visible range, cut evenly): warp w's rows are query head
// heads0 + w (w < gw) of tokens t0 .. t0 + cnt - 1, row j seeing the kv
// positions <= p0 + j below the capacity. q and out hold hq elements per
// token. Every block of the cluster merges a share of the output elements.
template <int HDP, bool VEC>
__device__ __forceinline__ void token_tile(const bf16* __restrict__ q,
                                           const bf16* __restrict__ kb,
                                           const bf16* __restrict__ vb,
                                           TableRows rows,
                                           bf16* __restrict__ out, int t0,
                                           int cnt, int p0, int heads0,
                                           int gw, int64_t hq, int hd,
                                           int cap, int split, float scale) {
  constexpr int kLd = attn::Tile<bf16, HDP>::kLd;
  constexpr int kKc = HDP / 16;           // 16-channel steps of Q K^T
  constexpr int kNc = HDP / 8;            // 8-channel output tiles of P V
  constexpr int kNt = kSplitTile / 8;     // 8-position score tiles
  constexpr int kRows = kWarps * kTileRows;
  constexpr int kW = kMaxSplit + 1;       // merge weights per row, then 1/l
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);     // 2 x kSplitTile rows
  bf16* v_s = k_s + 2 * kSplitTile * kLd;             // 2 x kSplitTile rows
  bf16* q_s = v_s + 2 * kSplitTile * kLd;             // kRows rows

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = min(p0 + cnt, cap);       // the last token's visible count
  // whole kv tiles of [0, n) per block: a block past the range waits at
  // the cluster barriers for the others, holding its SM
  const int per = ((n + kSplitTile - 1) / kSplitTile + split - 1) / split *
                  kSplitTile;
  const int lo = min(rank * per, n);
  const int hi = min(lo + per, n);
  const int n_tiles = (hi - lo + kSplitTile - 1) / kSplitTile;
  rows = rows.to_shared(
      reinterpret_cast<int32_t*>(smem_raw + tile_smem_bytes(HDP)), n, tid);
  __syncthreads();
  if (n_tiles > 0) {
    stage_kv<bf16, HDP, VEC>(k_s, v_s, kb, vb, rows, lo, hi, hd, tid);
  }
  attn::cp_async_commit();
  // q rows: warp w's row j is token t0 + j's query head heads0 + w; rows of
  // missing tokens or heads, and the padding channels, are zeros
  for (int i = tid; i < kRows * HDP; i += kThreads) {
    const int r = i / HDP;
    const int e = i % HDP;
    const int w = r / kTileRows;
    const int j = r % kTileRows;
    q_s[r * kLd + e] =
        w < gw && j < cnt && e < hd
            ? q[(t0 + j) * hq + static_cast<int64_t>(heads0 + w) * hd + e]
            : __float2bfloat16_rn(0.0f);
  }
  __syncthreads();

  // ---- lane roles in the m16n8k16 fragments: rows (tokens) fg and fg + 8
  // of the warp's 16, columns 2 ft and 2 ft + 1 of each 8-wide tile
  const bool active = warp < gw;          // warp-uniform
  const int fg = lane >> 2;
  const int ft = lane & 3;
  const int qp0 = p0 + fg;                // positions of the two rows
  const int qp1 = qp0 + 8;
  uint32_t qf[kKc][4];                    // Q's A fragments, kept
#pragma unroll
  for (int c = 0; c < kKc; ++c) {
    if (active) {
      ldsm_x4(q_s + (warp * 16 + (lane & 15)) * kLd + c * 16 + (lane >> 4) * 8,
              qf[c]);
    }
  }
  float acc[kNc][4];
#pragma unroll
  for (int nc = 0; nc < kNc; ++nc) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nc][e] = 0.0f;
  }
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int st = ((t + 1) & 1) * kSplitTile * kLd;
      stage_kv<bf16, HDP, VEC>(k_s + st, v_s + st, kb, vb, rows,
                               lo + (t + 1) * kSplitTile, hi, hd, tid);
    }
    attn::cp_async_commit();
    attn::cp_async_wait<1>();             // tile t has landed
    __syncthreads();
    const int k0 = lo + t * kSplitTile;
    const bf16* kt = k_s + (t & 1) * kSplitTile * kLd;
    const bf16* vt = v_s + (t & 1) * kSplitTile * kLd;
    // flash_mma_kernel's step, written out here again: one device function
    // shared by both made flash 9% slower on the card
    if (active) {
      // ---- S = Q K^T: 16 rows x 64 positions per warp
      float s[kNt][4];
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < kKc; ++c) {
#pragma unroll
        for (int np = 0; np < kNt / 2; ++np) {
          uint32_t kf[4];   // B fragments of position tiles 2 np, 2 np + 1
          ldsm_x4(kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                      c * 16 + ((lane >> 3) & 1) * 8,
                  kf);
          mma_bf16(s[2 * np], qf[c], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf[c], kf[2], kf[3]);
        }
      }
      // ---- scale and, on a tile that crosses the first token's position
      // or the range's end, mask (kv position <= the row's, below hi)
      const bool edge = k0 + kSplitTile > hi || k0 + kSplitTile - 1 > p0;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * scale;
          if (edge) {
            const int kpos = k0 + nt * 8 + 2 * ft + (e & 1);
            const int qp = e < 2 ? qp0 : qp1;
            x = kpos < hi && kpos <= qp ? x : kNeg;
          }
          s[nt][e] = x;
        }
      }
      // ---- online softmax on the fragments: each row lives in one quad
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float c0 = expf(m0 - mx0);
      const float c1 = expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= c0;                           // each lane's share of the row sum
      l1 *= c1;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        s[nt][0] = expf(s[nt][0] - m0);
        s[nt][1] = expf(s[nt][1] - m0);
        s[nt][2] = expf(s[nt][2] - m1);
        s[nt][3] = expf(s[nt][3] - m1);
        l0 += s[nt][0] + s[nt][1];
        l1 += s[nt][2] + s[nt][3];
      }
      // ---- acc = acc c + P V, P as three bf16 parts (flash_mma_kernel's
      // step); at hd <= 64 the tile's products sum in an accumulator of
      // their own, which joins acc with one rounding per element
      constexpr bool kTileAcc = HDP <= 64;
      float ta[kNc][4];
      float (&pv)[kNc][4] = kTileAcc ? ta : acc;
#pragma unroll
      for (int nc = 0; nc < kNc; ++nc) {
        pv[nc][0] = kTileAcc ? 0.0f : pv[nc][0] * c0;
        pv[nc][1] = kTileAcc ? 0.0f : pv[nc][1] * c0;
        pv[nc][2] = kTileAcc ? 0.0f : pv[nc][2] * c1;
        pv[nc][3] = kTileAcc ? 0.0f : pv[nc][3] * c1;
      }
#pragma unroll
      for (int j = 0; j < kNt / 2; ++j) {
        uint32_t ph[4], pm[4], pl[4];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float* p2 = s[2 * j + x];
          split3_bf16(p2[0], p2[1], ph[2 * x], pm[2 * x], pl[2 * x]);
          split3_bf16(p2[2], p2[3], ph[2 * x + 1], pm[2 * x + 1],
                      pl[2 * x + 1]);
        }
#pragma unroll
        for (int cp = 0; cp < kNc / 2; ++cp) {
          uint32_t vf[4];   // B fragments of channel tiles 2 cp, 2 cp + 1
          ldsm_x4_trans(vt + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 kLd +
                            cp * 16 + (lane >> 4) * 8,
                        vf);
          mma_bf16(pv[2 * cp], ph, vf[0], vf[1]);
          mma_bf16(pv[2 * cp + 1], ph, vf[2], vf[3]);
          mma_bf16(pv[2 * cp], pm, vf[0], vf[1]);
          mma_bf16(pv[2 * cp + 1], pm, vf[2], vf[3]);
          mma_bf16(pv[2 * cp], pl, vf[0], vf[1]);
          mma_bf16(pv[2 * cp + 1], pl, vf[2], vf[3]);
        }
      }
      if constexpr (kTileAcc) {
#pragma unroll
        for (int nc = 0; nc < kNc; ++nc) {
          acc[nc][0] = fmaf(acc[nc][0], c0, ta[nc][0]);
          acc[nc][1] = fmaf(acc[nc][1], c0, ta[nc][1]);
          acc[nc][2] = fmaf(acc[nc][2], c1, ta[nc][2]);
          acc[nc][3] = fmaf(acc[nc][3], c1, ta[nc][3]);
        }
      }
    }
    __syncthreads();                      // stage t & 1 is free again
  }
  attn::cp_async_wait<0>();
  __syncthreads();                        // the ring is free

  // ---- the block's partial into its own shared memory (the ring): acc
  // (kRows x HDP), m and l per row; an empty range leaves m = kNeg, l = 0
  float* part = reinterpret_cast<float*>(smem_raw);
  float* part_m = part + kRows * HDP;
  float* part_l = part_m + kRows;
  if (active) {
    const int r0 = warp * 16 + fg;
#pragma unroll
    for (int nc = 0; nc < kNc; ++nc) {
      const int ch = nc * 8 + 2 * ft;
      part[r0 * HDP + ch] = acc[nc][0];
      part[r0 * HDP + ch + 1] = acc[nc][1];
      part[(r0 + 8) * HDP + ch] = acc[nc][2];
      part[(r0 + 8) * HDP + ch + 1] = acc[nc][3];
    }
    const float s0 = quad_sum(l0);
    const float s1 = quad_sum(l1);
    if (ft == 0) {
      part_m[r0] = m0;
      part_m[r0 + 8] = m1;
      part_l[r0] = s0;
      part_l[r0 + 8] = s1;
    }
  }
  cluster.sync();                         // every partial is in place

  // ---- each row's weight per block and its denominator, into this block's
  // q rows (read by this block only)
  float* wts = reinterpret_cast<float*>(q_s);        // kRows x kW
  if (tid < kRows) {
    float pm[kMaxSplit];
    float mx = kNeg;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      pm[r] = r < split ? *cluster.map_shared_rank(part_m + tid, r) : kNeg;
      mx = fmaxf(mx, pm[r]);
    }
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      if (r < split) {
        const float f = expf(pm[r] - mx);
        sum = fmaf(*cluster.map_shared_rank(part_l + tid, r), f, sum);
        wts[tid * kW + r] = f;
      }
    }
    wts[tid * kW + kMaxSplit] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  // ---- this block's share of the output: every split-th run of kThreads
  // elements of the real rows
  for (int i = rank * kThreads + tid; i < kRows * hd; i += split * kThreads) {
    const int r = i / hd;
    const int e = i % hd;
    const int w = r / kTileRows;
    const int j = r % kTileRows;
    if (w >= gw || j >= cnt) continue;
    const float* wr = wts + r * kW;
    float a = 0.0f;
#pragma unroll
    for (int rr = 0; rr < kMaxSplit; ++rr) {
      if (rr < split) {
        a = fmaf(*cluster.map_shared_rank(part + r * HDP + e, rr), wr[rr], a);
      }
    }
    out[(t0 + j) * hq + static_cast<int64_t>(heads0 + w) * hd + e] =
        __float2bfloat16_rn(a / wr[kMaxSplit]);
  }
  cluster.sync();                         // no partial leaves while read
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// Contiguous (PAGED false: caches (b, cap, kvh, hd)) or paged (PAGED true:
// pages through block_tables (b, npages), cap = npages * block_size) decode:
// cluster (b, kh) of `split` blocks walks row b's n = min(cur_len[b], cap)
// positions.
template <typename T, bool VEC, int HDP, int G, bool PAGED>
__global__ void __launch_bounds__(kThreads, 1)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ cur_len, T* __restrict__ out,
                    int cap, int kvh, int g, int hd, int block_size,
                    int npages, int split, int chunk, float scale) {
  const int64_t row = blockIdx.x / split;           // b * kvh + kh
  const int64_t bi = row / kvh;
  const int kh = static_cast<int>(row % kvh);
  const int64_t stride = static_cast<int64_t>(kvh) * hd;
  const int n = min(cur_len[bi], cap);
  const T* q_row = q + row * g * hd;
  T* out_row = out + row * g * hd;
  if constexpr (PAGED) {
    split_walk<T, VEC, HDP, G>(
        q_row, k + kh * hd, v + kh * hd,
        TableRows{block_tables + bi * npages, block_size, stride}, n, out_row,
        g, hd, split, chunk, scale);
  } else {
    const int64_t base = bi * cap * stride + kh * hd;
    split_walk<T, VEC, HDP, G>(q_row, k + base, v + base,
                               ContiguousRows{stride}, n, out_row, g, hd,
                               split, chunk, scale);
  }
}

// A ragged list by its plan: cluster (item, kh, group) of `split` blocks.
// An item whose first token is dead is a dead run and gives zeros; a
// single token walks its slot's table to pos + 1; a bf16 run of 2-16
// tokens is a token tile over query heads 4 group .. 4 group + 3 of KV
// head kh (groups = ceil(g / 4)); a float32 run walks its tokens one by
// one. Every decision is the same for every block of a cluster, so a
// cluster returns or meets its barriers as one.
template <typename T, bool VEC, int HDP, int G>
__global__ void __launch_bounds__(kThreads, 1)
ragged_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ token_rows,
                    const int32_t* __restrict__ token_pos,
                    const int32_t* __restrict__ plan, T* __restrict__ out,
                    int kvh, int g, int hd, int block_size, int npages,
                    int groups, int split, int chunk, float scale) {
  const int64_t id = blockIdx.x / split;            // (item, kh, group)
  const int group = static_cast<int>(id % groups);
  const int kh = static_cast<int>((id / groups) % kvh);
  const int32_t* item = plan + id / groups / kvh * kPlanWidth;
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
    if (group != 0) return;
    const int rank = static_cast<int>(cg::this_cluster().block_rank());
    for (int i = rank * kThreads + threadIdx.x; i < cnt * g * hd;
         i += split * kThreads) {
      store1(out + (t0 + i / (g * hd)) * hq + head0 + i % (g * hd), 0.0f);
    }
    return;
  }
  if constexpr (std::is_same<T, bf16>::value) {
    if (cnt > 1) {
      token_tile<HDP, VEC>(
          q, kb, vb,
          TableRows{
              block_tables + static_cast<int64_t>(token_rows[t0]) * npages,
              block_size, stride},
          out, t0, cnt, p0, kh * g + kWarps * group,
          min(kWarps, g - kWarps * group), hq, hd, cap, split, scale);
      return;
    }
  }
  if (group != 0) return;
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
  return launch_clusters(
      decode_split_kernel<T, VEC, HDP, G, PAGED>, int64_t{b} * kvh * split,
      split,
      walk_smem_bytes(sizeof(T), HDP, G, g) +
          (PAGED ? sizeof(int32_t) * npages : 0),
      stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(cur_len), static_cast<T*>(out), cap, kvh, g,
      hd, block_size, npages, split, (cap + split - 1) / split, scale);
}

// One launcher per form, each templated on the element type, the load
// width, the padded hd and the padded head count.
template <typename T, bool VEC, int HDP, int G>
struct Contiguous {
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
  static cudaError_t run(const void* q, const void* k_pages,
                         const void* v_pages, const void* block_tables,
                         const void* token_rows, const void* token_pos,
                         const void* plan, void* out, int T_, int n_items,
                         int kvh, int g, int hd, int block_size, int npages,
                         int split, float scale, cudaStream_t stream) {
    if (n_items < 1 || n_items > T_) return cudaErrorInvalidValue;
    constexpr bool kTiles = std::is_same<T, bf16>::value;
    const int groups = kTiles ? (g + kWarps - 1) / kWarps : 1;
    size_t smem = walk_smem_bytes(sizeof(T), HDP, G, g);
    if (kTiles) smem = std::max(smem, tile_smem_bytes(HDP));
    smem += sizeof(int32_t) * npages;         // the page ids of a walk
    const int cap = npages * block_size;
    return launch_clusters(
        ragged_split_kernel<T, VEC, HDP, G>,
        int64_t{n_items} * kvh * groups * split, split, smem, stream,
        static_cast<const T*>(q), static_cast<const T*>(k_pages),
        static_cast<const T*>(v_pages),
        static_cast<const int32_t*>(block_tables),
        static_cast<const int32_t*>(token_rows),
        static_cast<const int32_t*>(token_pos),
        static_cast<const int32_t*>(plan), static_cast<T*>(out), kvh, g, hd,
        block_size, npages, groups, split, (cap + split - 1) / split, scale);
  }
};

// pick the element type, the load width, hd padded to 64 or 128 and g to 4
// or 8
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
  if (bf16_) {
    return hd <= 64 ? dispatch_g<F, bf16, 64>(vec, g, args...)
                    : dispatch_g<F, bf16, 128>(vec, g, args...);
  }
  return hd <= 64 ? dispatch_g<F, float, 64>(vec, g, args...)
                  : dispatch_g<F, float, 128>(vec, g, args...);
}

}  // namespace

// q (b, kvh * g, hd); k, v (b, S, kvh, hd); cur_len (b,) int32; out like q.
// split: blocks per (row, KV head) cluster, 1 .. 8. bf16 picks bf16 (1) or
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
// q. split, bf16 and vec as above.
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
