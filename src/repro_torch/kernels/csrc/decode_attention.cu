// Flash-decode for Hopper (sm_90a): one query token attending over a KV
// history, in three forms that share one device walk: a row of a contiguous
// cache, a row of a paged pool through its block table, and each token of a
// packed ragged list over its slot's pages.
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
// smollm-360m), far under the card's ~295 flops per byte of bf16. A ragged
// prefill chunk is different: each of its tokens re-reads the same pages,
// so the reads mostly hit L2, and the fp32 dot products on the CUDA cores
// (not the tensor cores) become the limit.
//
// Design, right and simple first:
// - one block (four warps) per (row or token, KV head); the block loads its
//   length (and, paged, walks its block-table row) itself: no scalar
//   prefetch on this card;
// - the g query rows sit in shared memory in fp32 for the whole walk;
// - the walk is split over the four warps: warp w takes kv tiles w, w + 4,
//   ... of 32 positions, one position per lane, and keeps its own running
//   max, sum and accumulator; the four partial softmaxes are merged once at
//   the end. Only tiles below the length are read;
// - each lane reads its own position's K row (16-byte loads when hd % 8 ==
//   0 and the pointers allow it) straight into its g scores, and stages its
//   V row in the warp's shared tile (row stride hd | 1, so the 32 lanes hit
//   32 banks); the accumulate is one (query row, channel) pair per lane and
//   register;
// - the cache and the pool are read in their native (b, S, kvh, hd) and
//   (num_blocks, block_size, kvh, hd) layouts: no transpose of the pool, no
//   padding of S to a tile multiple (the TPU wrappers' copies are gone);
// - offsets are 64-bit; g <= 8, hd <= 128, any S and any block_size.
// Splitting one row's walk over several blocks (for few rows and long
// histories), grouping a prefill chunk's queries into tensor-core tiles and
// TMA staging are left for later.
//
// C interface (ctypes): every pointer and the stream are void*; returns
// cudaGetLastError() after the launch.

#include "attention_common.cuh"

namespace {

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

// kv position p of a contiguous cache row -> element offset of its K/V row
struct ContiguousRows {
  int64_t stride;  // kvh * hd
  __device__ __forceinline__ int64_t operator()(int p) const {
    return p * stride;
  }
};

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

template <typename T, bool VEC, int C>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ cur_len,
                        T* __restrict__ out, int S, int kvh, int g, int hd,
                        float scale) {
  const int64_t b = blockIdx.x / kvh;
  const int kh = blockIdx.x % kvh;
  const int64_t head0 = (b * kvh + kh) * static_cast<int64_t>(g);
  const int64_t stride = static_cast<int64_t>(kvh) * hd;
  const int64_t base = b * S * stride + kh * hd;
  const int n_kv = min(cur_len[b], S);
  decode_walk<T, VEC, C>(q + head0 * hd, k + base, v + base,
                         ContiguousRows{stride}, n_kv, out + head0 * hd, g,
                         hd, scale);
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
template <typename T, bool VEC, int C>
struct Contiguous {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* cur_len, void* out, int b, int S,
                         int kvh, int g, int hd, float scale,
                         cudaStream_t stream) {
    return launch(decode_attention_kernel<T, VEC, C>, b * kvh, g, hd, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v),
                  static_cast<const int32_t*>(cur_len), static_cast<T*>(out),
                  S, kvh, g, hd, scale);
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
// bf16 picks bf16 (1) or float32 (0) for q, the caches and out. vec: 1 when
// hd % 8 == 0 and the cache pointers are 16-byte aligned.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* cur_len, void* out, int b, int S,
                                int kvh, int g, int hd, float scale, int bf16,
                                int vec, void* stream) {
  return static_cast<int>(dispatch<Contiguous>(
      bf16, vec, hd, q, k, v, cur_len, out, b, S, kvh, g, hd, scale,
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
