// Flash-decode for Hopper (sm_90a): one query token attending over a KV
// history, in three forms: a row of a contiguous cache, a row of a paged
// pool through its block table, and each token of a packed ragged list over
// its slot's pages.
//
// Replaces: decode_attention_kernel, paged_decode_attention_kernel and
// ragged_paged_attention_kernel in src/repro/kernels/decode_attention.py.
// Semantics are the same: the g query heads of KV head kh attend over kv
// positions 0 .. n - 1, where n is cur_len[b] for a decode row and
// token_pos[t] + 1 for a ragged token (token t belongs to slot
// token_rows[t]; a ragged prefill chunk's tokens each walk to their own
// position, so they see their lower-positioned chunk-mates); positions past
// the cache or the table are not there to see; softmax in fp32 with running
// max/sum/accumulator and scale 1/sqrt(hd); a row with n <= 0 (cur_len <= 0,
// a dead padding token with token_pos < 0) gives exact zeros.
//
// Bound on an H100: bytes for decode rows, which read their K/V history once
// per KV head and do about 4 g flops per kv element read (g = 3 for
// smollm-360m), far under the card's ~295 flops per byte of bf16. So the
// card has to keep enough loads in flight to pull 3.35 TB/s. A ragged
// prefill chunk is different: each of its tokens re-reads the same pages,
// so the reads mostly hit L2, and the fp32 dot products on the CUDA cores
// become the limit.
//
// Contiguous decode (decode_split_kernel): one (row, KV head) walk is split
// over a thread-block cluster of `split` blocks (up to 8; the wrapper gives
// each block 256 cache positions of S, since the lengths live on the
// device). One block gave 16 x 5 = 80 blocks of four warps on 132 SMs at
// the static batch, too few loads in flight, and the deepest row set the
// time; the cluster gives 320 (at S 1024; 8 blocks of 128 positions, 640,
// measured slower: they do not all fit on the card at once).
// - block r walks positions [r chunk, (r + 1) chunk), chunk = ceil(S /
//   split), cut at the row's length; a block whose range is empty
//   contributes an empty partial (l = 0);
// - K/V tiles of 64 positions are staged in their own type with cp.async,
//   double-buffered: eight threads cover a 128-byte row, one instruction
//   four rows (a one-element build takes rows that are not 16-byte
//   aligned); hd is padded with zeros to 64 or 128 in shared memory;
// - warp w takes tile positions 16 w .. 16 w + 15, two lanes a position
//   (half the 16-byte chunks each, joined by one shuffle): g dot products
//   on the CUDA cores in fp32 (an m16 tensor-core tile would waste 13 of
//   its 16 rows at g = 3), an online softmax per warp, then P V with one
//   channel pair per lane and register, the probabilities read four at a
//   time from the warp's shared row. The heads are a compile-time G (g
//   rounded up to 4 or 8, the rows past g zeros), so no loop over them
//   branches and the reductions of the G heads overlap;
// - the four warps merge in shared memory; each block then writes its
//   partial (m, l, acc) into a slot of rank 0's shared memory (distributed
//   shared memory, remote stores that do not wait), and after one cluster
//   barrier rank 0 merges the slots and writes the row: one launch, no
//   global scratch, no counters.
// Paged and ragged decode keep the first design (decode_walk): one block of
// four warps per (row or token, KV head), warp w taking kv tiles w, w + 4,
// ... of 32 positions, one position per lane, the four partial softmaxes
// merged at the end; each block walks its block-table row in place. Giving
// them the cluster split and the staged tiles, and grouping a prefill
// chunk's queries into tensor-core tiles, are left for later.
//
// C interface (ctypes): every pointer and the stream are void*; returns
// cudaGetLastError() after the launch.

#include <cooperative_groups.h>

#include "attention_common.cuh"

namespace {

namespace cg = cooperative_groups;

using attn::kNeg;
using attn::kVec;
using attn::load1;
using attn::load8;
using attn::store1;
using attn::warp_max;
using attn::warp_sum;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;   // query heads per KV head

// kv position p of a paged row -> element offset through the block table
struct PagedRows {
  const int32_t* table;  // this row's npages page ids
  int block_size;
  int64_t stride;        // kvh * hd
  __device__ __forceinline__ int64_t operator()(int p) const {
    const int64_t page = table[p / block_size];
    return (page * block_size + p % block_size) * stride;
  }
};

__host__ __device__ inline int padded_stride(int hd) { return hd | 1; }
__host__ __device__ inline int round8(int hd) { return (hd + 7) / 8 * 8; }

size_t smem_bytes(int g, int hd) {
  return sizeof(float) *
         (static_cast<size_t>(g) * round8(hd) +             // q rows
          static_cast<size_t>(kWarps) * 32 * padded_stride(hd) +  // V tiles
          static_cast<size_t>(kWarps) * kMaxG * 32 +          // p per warp
          2 * static_cast<size_t>(kWarps) * kMaxG);           // m, l per warp
}

// The whole (row, KV head) walk. q_row: the row's g query heads of this KV
// head (g * hd, contiguous); k_base / v_base: position 0 of this KV head;
// out_row: where the g output heads go. C = channels per lane (hd <= 32 C).
template <typename T, bool VEC, int C, typename Rows>
__device__ void decode_walk(const T* __restrict__ q_row,
                            const T* __restrict__ k_base,
                            const T* __restrict__ v_base, Rows rows, int n_kv,
                            T* __restrict__ out_row, int g, int hd,
                            float scale) {
  extern __shared__ float smem[];
  const int hd8 = round8(hd);
  const int hs = padded_stride(hd);
  float* q_s = smem;                          // g * hd8, zero padded
  float* v_s = q_s + g * hd8;                 // kWarps * 32 * hs
  float* p_s = v_s + kWarps * 32 * hs;        // kWarps * kMaxG * 32
  float* m_w = p_s + kWarps * kMaxG * 32;     // kWarps * kMaxG
  float* l_w = m_w + kWarps * kMaxG;          // kWarps * kMaxG

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gh = g * hd;
  if (n_kv <= 0) {                            // nothing to see: exact zeros
    for (int i = tid; i < gh; i += kThreads) store1(out_row + i, 0.0f);
    return;
  }
  for (int i = tid; i < g * hd8; i += kThreads) {
    const int gi = i / hd8;
    const int e = i % hd8;
    q_s[i] = e < hd ? load1(q_row + gi * hd + e) : 0.0f;
  }
  __syncthreads();

  float m[kMaxG], l[kMaxG], acc[kMaxG][C];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    m[gi] = kNeg;
    l[gi] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[gi][c] = 0.0f;
  }
  float* vw = v_s + warp * 32 * hs;           // this warp's V tile
  float* pw = p_s + warp * kMaxG * 32;        // this warp's probabilities

  for (int base = warp * 32; base < n_kv; base += kWarps * 32) {
    const int p = base + lane;
    const int n = min(32, n_kv - base);
    float s[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) s[gi] = 0.0f;
    if (p < n_kv) {
      const int64_t off = rows(p);
      const T* kr = k_base + off;
      const T* vr = v_base + off;
      float* vrow = vw + lane * hs;
      if constexpr (VEC) {
        for (int e = 0; e < hd; e += kVec) {
          float k8[kVec], v8[kVec];
          load8(kr + e, k8);
          load8(vr + e, v8);
#pragma unroll
          for (int gi = 0; gi < kMaxG; ++gi) {
            if (gi < g) {
              const float* qg = q_s + gi * hd8 + e;
#pragma unroll
              for (int x = 0; x < kVec; ++x) s[gi] = fmaf(qg[x], k8[x], s[gi]);
            }
          }
#pragma unroll
          for (int x = 0; x < kVec; ++x) vrow[e + x] = v8[x];
        }
      } else {
        for (int e = 0; e < hd; ++e) {
          const float kk = load1(kr + e);
#pragma unroll
          for (int gi = 0; gi < kMaxG; ++gi) {
            if (gi < g) s[gi] = fmaf(q_s[gi * hd8 + e], kk, s[gi]);
          }
          vrow[e] = load1(vr + e);
        }
      }
    }
    // ---- online softmax, one query row at a time across the warp's lanes
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
        const float sv = p < n_kv ? s[gi] * scale : kNeg;
        const float m_new = fmaxf(m[gi], warp_max(sv));
        const float pr = expf(sv - m_new);
        const float corr = expf(m[gi] - m_new);
        l[gi] = l[gi] * corr + warp_sum(pr);
        m[gi] = m_new;
        pw[gi * 32 + lane] = pr;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[gi][c] *= corr;
      }
    }
    __syncwarp();
    // ---- acc[gi][e] += sum_j p[gi][j] * v[j][e], e = lane + 32 c
    for (int j = 0; j < n; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = lane + 32 * c;
        const float vv = e < hd ? vw[j * hs + e] : 0.0f;
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) {
          if (gi < g) acc[gi][c] = fmaf(pw[gi * 32 + j], vv, acc[gi][c]);
        }
      }
    }
    __syncwarp();
  }

  // ---- merge the four warps' partial softmaxes (the V tiles become the
  // accumulator exchange)
  __syncthreads();
  float* acc_w = v_s;                         // kWarps * g * hd
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    if (gi < g) {
      if (lane == 0) {
        m_w[warp * kMaxG + gi] = m[gi];
        l_w[warp * kMaxG + gi] = l[gi];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = lane + 32 * c;
        if (e < hd) acc_w[(warp * g + gi) * hd + e] = acc[gi][c];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < gh; i += kThreads) {
    const int gi = i / hd;
    float mx = kNeg;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w * kMaxG + gi]);
    float sum = 0.0f, a = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_w[w * kMaxG + gi] - mx);
      sum = fmaf(l_w[w * kMaxG + gi], f, sum);
      a = fmaf(acc_w[w * gh + i], f, a);
    }
    store1(out_row + i, a / fmaxf(sum, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// contiguous decode: one (row, KV head) walk split over a cluster
// ---------------------------------------------------------------------------

constexpr int kSplitTile = 64;   // kv positions per staged tile
constexpr int kMaxSplit = 8;     // blocks per cluster (the portable most)

// K and V tiles (two stages each), then in fp32: the G q rows, each warp's
// probabilities (G x 16) and partial (acc, m, l), and a slot per block of
// the cluster for the block partials that rank 0 merges
size_t split_smem_bytes(size_t elem, int hdp, int G, int g) {
  const size_t ld = hdp + 16 / elem;
  const size_t part = static_cast<size_t>(g) * (hdp + 2);
  return elem * 2 * 2 * kSplitTile * ld +
         sizeof(float) * (static_cast<size_t>(G) * (hdp + kWarps * 16) +
                          (kWarps + kMaxSplit) * part);
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

// K and V rows p0 .. p0 + kSplitTile - 1 of one (row, KV head) into one
// stage of the ring (rows from hi on as zeros)
template <typename T, int HDP, bool VEC>
__device__ __forceinline__ void stage_kv(T* ks, T* vs, const T* kb,
                                         const T* vb, int64_t stride, int p0,
                                         int hi, int hd, int tid) {
  attn::stage_rows<T, HDP, kSplitTile, kThreads, VEC>(
      ks, kb + p0 * stride, stride, hi - p0, hd, tid);
  attn::stage_rows<T, HDP, kSplitTile, kThreads, VEC>(
      vs, vb + p0 * stride, stride, hi - p0, hd, tid);
}

// Block r of cluster (b, kh), launched with `split` blocks a cluster, walks
// positions [r chunk, (r + 1) chunk) of row b, cut at n = min(cur_len[b],
// S). HDP: hd padded to 64 or 128. G: g rounded up to 4 or 8; the rows
// past g are zeros, so every loop over the heads runs without a branch.
template <typename T, bool VEC, int HDP, int G>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ cur_len,
                    T* __restrict__ out, int S, int kvh, int g, int hd,
                    int split, int chunk, float scale) {
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
  const int64_t row = blockIdx.x / split;           // b * kvh + kh
  const int64_t bi = row / kvh;
  const int kh = static_cast<int>(row % kvh);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = min(cur_len[bi], S);
  T* out_row = out + row * g * hd;
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
  const int64_t stride = static_cast<int64_t>(kvh) * hd;
  const T* kb = k + bi * S * stride + kh * hd;
  const T* vb = v + bi * S * stride + kh * hd;
  if (n_tiles > 0) {
    stage_kv<T, HDP, VEC>(k_s, v_s, kb, vb, stride, lo, hi, hd, tid);
  }
  attn::cp_async_commit();
  for (int i = tid; i < G * HDP; i += kThreads) {
    const int gi = i / HDP;
    const int e = i % HDP;
    q_s[i] = gi < g && e < hd ? load1(q + (row * g + gi) * hd + e) : 0.0f;
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
      stage_kv<T, HDP, VEC>(k_s + st, v_s + st, kb, vb, stride, p1, hi, hd,
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
      s[gi] = valid ? s[gi] * scale : kNeg;
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
      l[gi] *= corr;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        acc[gi][c][0] *= corr;
        acc[gi][c][1] *= corr;
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

template <typename T, bool VEC, int C>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int32_t* __restrict__ block_tables,
                              const int32_t* __restrict__ cur_len,
                              T* __restrict__ out, int kvh, int g, int hd,
                              int block_size, int npages, float scale) {
  const int64_t b = blockIdx.x / kvh;
  const int kh = blockIdx.x % kvh;
  const int64_t head0 = (b * kvh + kh) * static_cast<int64_t>(g);
  const int64_t stride = static_cast<int64_t>(kvh) * hd;
  // a length past the table sees the whole table, as the gathered
  // reference does
  const int64_t cap = static_cast<int64_t>(npages) * block_size;
  const int n_kv = static_cast<int>(cur_len[b] < cap ? cur_len[b] : cap);
  const PagedRows rows{block_tables + b * npages, block_size, stride};
  decode_walk<T, VEC, C>(q + head0 * hd, k_pages + kh * hd,
                         v_pages + kh * hd, rows, n_kv, out + head0 * hd, g,
                         hd, scale);
}

// token t of a packed ragged list: its slot's pages, to its own position
template <typename T, bool VEC, int C>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int32_t* __restrict__ block_tables,
                              const int32_t* __restrict__ token_rows,
                              const int32_t* __restrict__ token_pos,
                              T* __restrict__ out, int kvh, int g, int hd,
                              int block_size, int npages, float scale) {
  const int64_t t = blockIdx.x / kvh;
  const int kh = blockIdx.x % kvh;
  const int64_t head0 = (t * kvh + kh) * static_cast<int64_t>(g);
  const int64_t stride = static_cast<int64_t>(kvh) * hd;
  const int64_t cap = static_cast<int64_t>(npages) * block_size;
  const int pos = token_pos[t];
  // a dead token sees nothing; a position past the table sees the whole
  // table, as the gathered reference does
  const int n_kv =
      pos < 0 ? 0 : static_cast<int>(pos + 1 < cap ? pos + 1 : cap);
  const int64_t row = pos < 0 ? 0 : token_rows[t];
  const PagedRows rows{block_tables + row * npages, block_size, stride};
  decode_walk<T, VEC, C>(q + head0 * hd, k_pages + kh * hd,
                         v_pages + kh * hd, rows, n_kv, out + head0 * hd, g,
                         hd, scale);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int blocks, int g, int hd,
                   cudaStream_t stream, Args... args) {
  const size_t smem = smem_bytes(g, hd);
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// One launcher per form, each templated on the element type, the load width
// and the channels per lane.
template <typename T, bool VEC, int HDP, int G>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const void* cur_len, void* out, int b, int S,
                         int kvh, int g, int hd, int split, float scale,
                         cudaStream_t stream) {
  if (split < 1 || split > kMaxSplit) return cudaErrorInvalidValue;
  const int64_t blocks = int64_t{b} * kvh * split;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  auto kernel = decode_split_kernel<T, VEC, HDP, G>;
  const size_t smem = split_smem_bytes(sizeof(T), HDP, G, g);
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
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q),
                           static_cast<const T*>(k), static_cast<const T*>(v),
                           static_cast<const int32_t*>(cur_len),
                           static_cast<T*>(out), S, kvh, g, hd, split,
                           (S + split - 1) / split, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool VEC, int C>
struct Contiguous {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* cur_len, void* out, int b, int S,
                         int kvh, int g, int hd, int split, float scale,
                         cudaStream_t stream) {
    auto launch_g = g <= 4 ? launch_split<T, VEC, 32 * C, 4>
                           : launch_split<T, VEC, 32 * C, 8>;
    return launch_g(q, k, v, cur_len, out, b, S, kvh, g, hd, split, scale,
                    stream);
  }
};

template <typename T, bool VEC, int C>
struct Paged {
  static cudaError_t run(const void* q, const void* k_pages,
                         const void* v_pages, const void* block_tables,
                         const void* cur_len, void* out, int b, int kvh,
                         int g, int hd, int block_size, int npages,
                         float scale, cudaStream_t stream) {
    return launch(paged_decode_attention_kernel<T, VEC, C>, b * kvh, g, hd,
                  stream, static_cast<const T*>(q),
                  static_cast<const T*>(k_pages),
                  static_cast<const T*>(v_pages),
                  static_cast<const int32_t*>(block_tables),
                  static_cast<const int32_t*>(cur_len), static_cast<T*>(out),
                  kvh, g, hd, block_size, npages, scale);
  }
};

template <typename T, bool VEC, int C>
struct Ragged {
  static cudaError_t run(const void* q, const void* k_pages,
                         const void* v_pages, const void* block_tables,
                         const void* token_rows, const void* token_pos,
                         void* out, int T_, int kvh, int g, int hd,
                         int block_size, int npages, float scale,
                         cudaStream_t stream) {
    return launch(ragged_paged_attention_kernel<T, VEC, C>, T_ * kvh, g, hd,
                  stream, static_cast<const T*>(q),
                  static_cast<const T*>(k_pages),
                  static_cast<const T*>(v_pages),
                  static_cast<const int32_t*>(block_tables),
                  static_cast<const int32_t*>(token_rows),
                  static_cast<const int32_t*>(token_pos), static_cast<T*>(out),
                  kvh, g, hd, block_size, npages, scale);
  }
};

// pick the element type, the load width and the channels per lane
template <template <typename, bool, int> class F, typename... Args>
cudaError_t dispatch(int bf16, int vec, int hd, Args... args) {
  if (bf16) {
    if (hd <= 64) {
      return vec ? F<__nv_bfloat16, true, 2>::run(args...)
                 : F<__nv_bfloat16, false, 2>::run(args...);
    }
    return vec ? F<__nv_bfloat16, true, 4>::run(args...)
               : F<__nv_bfloat16, false, 4>::run(args...);
  }
  if (hd <= 64) {
    return vec ? F<float, true, 2>::run(args...)
               : F<float, false, 2>::run(args...);
  }
  return vec ? F<float, true, 4>::run(args...)
             : F<float, false, 4>::run(args...);
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
      bf16, vec, hd, q, k, v, cur_len, out, b, S, kvh, g, hd, split, scale,
      static_cast<cudaStream_t>(stream)));
}

// q (b, kvh * g, hd); k_pages, v_pages (num_blocks, block_size, kvh, hd);
// block_tables (b, npages) and cur_len (b,) int32; out like q. bf16 and vec
// as above (vec: the page pointers 16-byte aligned).
extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_tables,
                                      const void* cur_len, void* out, int b,
                                      int kvh, int g, int hd, int block_size,
                                      int npages, float scale, int bf16,
                                      int vec, void* stream) {
  return static_cast<int>(dispatch<Paged>(
      bf16, vec, hd, q, k_pages, v_pages, block_tables, cur_len, out, b, kvh,
      g, hd, block_size, npages, scale, static_cast<cudaStream_t>(stream)));
}

// q (T, kvh * g, hd) packed tokens; k_pages, v_pages (num_blocks,
// block_size, kvh, hd); block_tables (num_slots, npages), token_rows and
// token_pos (T,) int32; out like q. bf16 and vec as above.
extern "C" int ragged_paged_attention(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_tables,
                                      const void* token_rows,
                                      const void* token_pos, void* out, int T,
                                      int kvh, int g, int hd, int block_size,
                                      int npages, float scale, int bf16,
                                      int vec, void* stream) {
  return static_cast<int>(dispatch<Ragged>(
      bf16, vec, hd, q, k_pages, v_pages, block_tables, token_rows,
      token_pos, out, T, kvh, g, hd, block_size, npages, scale,
      static_cast<cudaStream_t>(stream)));
}
