// Ragged paged attention for Hopper (sm_90a): one packed token list, each
// token attending causally over its own slot's pages of a paged KV pool.
//
// Replaces: ragged_paged_attention_kernel in
// src/repro/kernels/decode_attention.py. Semantics are the same: token t
// belongs to slot token_rows[t] at absolute position token_pos[t]; its g query
// heads of KV head kh attend over kv positions 0..token_pos[t] of that slot,
// read through the slot's block table; softmax in fp32 with running
// max/sum/accumulator and scale 1/sqrt(hd); token_pos < 0 (a dead padding
// token) gives exact zeros.
//
// Bound on an H100: bytes for decode tokens, which read their slot's whole
// K/V history once per KV head (arithmetic intensity about g flops per byte,
// far under the card's ~295 flops per byte of bf16). A prefill chunk is
// different: each of its tokens re-reads the same pages, so the reads mostly
// hit L2, and the fp32 dot products on the CUDA cores (not the tensor cores)
// become the limit.
//
// Design, right and simple first:
// - one block (128 threads) per (token, KV head); the block loads its
//   token's position and slot and walks that slot's block-table row itself
//   (no scalar prefetch on this card);
// - the g query rows stay in shared memory in fp32 for the whole walk;
// - kv positions are walked in tiles of 32 (one per lane); each tile's K and
//   V rows are staged into shared memory as fp32, row by row through the
//   block table, so any block_size works and a tile may straddle pages;
//   positions past the token's own are never read;
// - the pool is read in its native (num_blocks, block_size, kvh, hd) layout:
//   the TPU wrapper's transpose of the whole pool on every call is gone;
// - scores: one (query row, kv position) pair per thread over a padded K
//   tile (stride hd + 1, so a warp's 32 positions hit 32 banks);
//   online softmax: one warp per query row, shuffles for max and sum;
//   accumulate: one (query row, channel) pair per thread;
// - offsets are 64-bit; any g, any hd up to 128, any block_size.
// Grouping a prefill chunk's queries into tensor-core tiles (wgmma), TMA
// staging and a split over kv for long decode rows are left for later.
//
// C interface (ctypes): every pointer and the stream are void*; returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 32;      // kv positions per tile: one per lane
constexpr int kThreads = 128;  // four warps
constexpr int kVec = 8;        // elements per 16-byte bf16 load
constexpr float kNeg = -1e30f;

template <typename T>
__device__ __forceinline__ float load1(const T* p) {
  if constexpr (std::is_same<T, float>::value) {
    return *p;
  } else {
    return __bfloat162float(*p);
  }
}

template <typename T>
__device__ __forceinline__ void store1(T* p, float x) {
  if constexpr (std::is_same<T, float>::value) {
    *p = x;
  } else {
    *p = __float2bfloat16_rn(x);
  }
}

// 8 consecutive elements from a 16-byte aligned address
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&f)[kVec]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float((w[i] & 0xffffu) << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int32_t* __restrict__ block_tables,
                              const int32_t* __restrict__ token_rows,
                              const int32_t* __restrict__ token_pos,
                              T* __restrict__ out, int kvh, int g, int hd,
                              int block_size, int npages, float scale) {
  extern __shared__ float smem[];
  const int hs = hd + 1;               // padded K row stride
  float* q_s = smem;                   // g * hd
  float* acc = q_s + g * hd;           // g * hd
  float* k_s = acc + g * hd;           // kTile * hs
  float* v_s = k_s + kTile * hs;       // kTile * hd
  float* p_s = v_s + kTile * hd;       // g * kTile
  float* m_s = p_s + g * kTile;        // g
  float* l_s = m_s + g;                // g
  float* c_s = l_s + g;                // g

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t t = blockIdx.x / kvh;
  const int kh = blockIdx.x % kvh;
  const int64_t head0 = (t * kvh + kh) * static_cast<int64_t>(g);  // first q head
  T* o = out + head0 * hd;
  const int gh = g * hd;

  const int pos = token_pos[t];
  if (pos < 0) {                       // dead padding token: exact zeros
    for (int i = tid; i < gh; i += kThreads) store1(o + i, 0.0f);
    return;
  }
  // a position past the table sees the whole table, as the gathered
  // reference does
  const int64_t cap = static_cast<int64_t>(npages) * block_size;
  const int n_kv = static_cast<int>(pos + 1 < cap ? pos + 1 : cap);
  const int32_t* table = block_tables + static_cast<int64_t>(token_rows[t]) * npages;
  const T* qr = q + head0 * hd;
  for (int i = tid; i < gh; i += kThreads) {
    q_s[i] = load1(qr + i);
    acc[i] = 0.0f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNeg;
    l_s[i] = 0.0f;
  }
  __syncthreads();

  for (int base = 0; base < n_kv; base += kTile) {
    const int n = min(kTile, n_kv - base);
    // ---- stage K and V rows base .. base + n - 1 through the block table
    if constexpr (VEC) {
      const int per_row = hd / kVec;
      for (int i = tid; i < n * per_row; i += kThreads) {
        const int j = i / per_row;
        const int e = (i % per_row) * kVec;
        const int p = base + j;
        const int64_t page = table[p / block_size];
        const int64_t off =
            ((page * block_size + p % block_size) * kvh + kh) * hd + e;
        float kv8[kVec];
        load8(k_pages + off, kv8);
#pragma unroll
        for (int x = 0; x < kVec; ++x) k_s[j * hs + e + x] = kv8[x];
        load8(v_pages + off, kv8);
#pragma unroll
        for (int x = 0; x < kVec; ++x) v_s[j * hd + e + x] = kv8[x];
      }
    } else {
      for (int i = tid; i < n * hd; i += kThreads) {
        const int j = i / hd;
        const int e = i % hd;
        const int p = base + j;
        const int64_t page = table[p / block_size];
        const int64_t off =
            ((page * block_size + p % block_size) * kvh + kh) * hd + e;
        k_s[j * hs + e] = load1(k_pages + off);
        v_s[j * hd + e] = load1(v_pages + off);
      }
    }
    __syncthreads();
    // ---- scores s[i][j] = q_i . k_j * scale (masked past the token)
    for (int idx = tid; idx < g * kTile; idx += kThreads) {
      const int i = idx / kTile;
      const int j = idx % kTile;
      float s = kNeg;
      if (j < n) {
        const float* qi = q_s + i * hd;
        const float* kj = k_s + j * hs;
        float dot = 0.0f;
        for (int e = 0; e < hd; ++e) dot = fmaf(qi[e], kj[e], dot);
        s = dot * scale;
      }
      p_s[idx] = s;
    }
    __syncthreads();
    // ---- online softmax: one warp per query row
    for (int i = warp; i < g; i += kThreads / 32) {
      const float s = p_s[i * kTile + lane];
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = expf(s - m_new);
      const float sum = warp_sum(p);
      p_s[i * kTile + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[i] = l_s[i] * corr + sum;
        m_s[i] = m_new;
        c_s[i] = corr;
      }
    }
    __syncthreads();
    // ---- acc[i][e] = acc[i][e] * corr_i + sum_j p[i][j] * v[j][e]
    for (int idx = tid; idx < gh; idx += kThreads) {
      const int i = idx / hd;
      const int e = idx % hd;
      const float* pi = p_s + i * kTile;
      float a = acc[idx] * c_s[i];
      for (int j = 0; j < n; ++j) a = fmaf(pi[j], v_s[j * hd + e], a);
      acc[idx] = a;
    }
    __syncthreads();
  }
  for (int idx = tid; idx < gh; idx += kThreads) {
    store1(o + idx, acc[idx] / fmaxf(l_s[idx / hd], 1e-30f));
  }
}

size_t smem_bytes(int g, int hd) {
  return sizeof(float) *
         (2 * static_cast<size_t>(g) * hd + kTile * (hd + 1) + kTile * hd +
          static_cast<size_t>(g) * kTile + 3 * static_cast<size_t>(g));
}

template <typename T, bool VEC>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_tables, const void* token_rows,
                   const void* token_pos, void* out, int T_, int kvh, int g,
                   int hd, int block_size, int npages, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(g, hd);
  auto kernel = ragged_paged_attention_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<T_ * kvh, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(token_rows),
      static_cast<const int32_t*>(token_pos), static_cast<T*>(out), kvh, g,
      hd, block_size, npages, scale);
  return cudaGetLastError();
}

}  // namespace

// q (T, kvh * g, hd); k_pages, v_pages (num_blocks, block_size, kvh, hd);
// block_tables (num_slots, npages), token_rows and token_pos (T,) int32;
// out (T, kvh * g, hd). bf16 picks bf16 (1) or float32 (0) for q, the pages
// and out. vec: 1 when hd % 8 == 0 and the page pointers are 16-byte aligned.
extern "C" int ragged_paged_attention(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_tables,
                                      const void* token_rows,
                                      const void* token_pos, void* out, int T,
                                      int kvh, int g, int hd, int block_size,
                                      int npages, float scale, int bf16,
                                      int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = vec ? launch<__nv_bfloat16, true>(q, k_pages, v_pages, block_tables,
                                            token_rows, token_pos, out, T, kvh,
                                            g, hd, block_size, npages, scale, s)
              : launch<__nv_bfloat16, false>(q, k_pages, v_pages, block_tables,
                                             token_rows, token_pos, out, T, kvh,
                                             g, hd, block_size, npages, scale, s);
  } else {
    err = vec ? launch<float, true>(q, k_pages, v_pages, block_tables,
                                    token_rows, token_pos, out, T, kvh, g, hd,
                                    block_size, npages, scale, s)
              : launch<float, false>(q, k_pages, v_pages, block_tables,
                                     token_rows, token_pos, out, T, kvh, g, hd,
                                     block_size, npages, scale, s);
  }
  return static_cast<int>(err);
}
