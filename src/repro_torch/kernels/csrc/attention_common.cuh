// Device helpers shared by the port's attention kernels (sm_90a): element
// loads and stores in float32 or bfloat16, 16-byte loads of 8 elements,
// warp reductions, asynchronous staging of (positions, channels) tiles into
// padded shared rows (cp.async) from any per-row source, the bf16
// tensor-core fragments (ldmatrix, mma.sync, P in three bf16 parts), and
// the opt-in to more than 48 KB of dynamic shared memory. Every kernel
// computes in float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace attn {

constexpr int kVec = 8;        // elements per 16-byte bf16 load
constexpr float kNeg = -1e30f;  // the reference kernels' mask value

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

// ---- asynchronous copies (cp.async) into shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst without a register on the way;
// src_bytes 0 writes 16 zero bytes (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared row of a staged tile: HDP channels (hd padded with zeros to 64 or
// 128) and 16 bytes more, so that rows read 16 bytes at a time (ldmatrix or
// a vector load), eight rows at once, start in eight different 4-bank
// groups: no bank conflicts.
template <typename T, int HDP>
struct Tile {
  static constexpr int kVecE = 16 / static_cast<int>(sizeof(T));
  static constexpr int kLd = HDP + kVecE;   // elements per shared row
};

// Stage ROWS rows of a (positions, channels) matrix into dst[r * kLd + e]:
// channels e < hd of rows r < count (count >= 1), row r read from src(r)
// (a pointer to its channel 0: a strided matrix, or a page through a block
// table), zeros elsewhere (the padding channels and the rows past the
// end; src is never called for those). VEC: 16-byte cp.async copies (every
// row start and hd in whole 16-byte units; eight consecutive threads cover
// a 128-byte row), left in flight for the caller to commit and wait on;
// else element loads stored synchronously, for rows that are not 16-byte
// aligned. THREADS threads take part.
template <typename T, int HDP, int ROWS, int THREADS, bool VEC, typename Src>
__device__ __forceinline__ void stage_rows(T* dst, Src src, int count, int hd,
                                           int tid) {
  using L = Tile<T, HDP>;
  if constexpr (VEC) {
    constexpr int kChunks = HDP / L::kVecE;
    static_assert(ROWS * kChunks % THREADS == 0, "whole passes");
    const T* any = src(0);    // a valid address for the zero-filling copies
#pragma unroll
    for (int it = 0; it < ROWS * kChunks / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / kChunks;
      const int c = i % kChunks;
      const bool ok = r < count && c * L::kVecE < hd;
      cp_async16(dst + r * L::kLd + c * L::kVecE,
                 ok ? src(r) + c * L::kVecE : any, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * HDP; i += THREADS) {
      const int r = i / HDP;
      const int e = i % HDP;
      store1(dst + r * L::kLd + e,
             r < count && e < hd ? load1(src(r) + e) : 0.0f);
    }
  }
}

// rows of a strided matrix: row r at base + r * stride
template <typename T>
struct StridedRows {
  const T* base;
  int64_t stride;
  __device__ __forceinline__ const T* operator()(int r) const {
    return base + r * stride;
  }
};

// ---- bf16 tensor-core fragments (mma.sync.m16n8k16, ldmatrix)

__device__ __forceinline__ void ldsm_x4(const __nv_bfloat16* p,
                                        uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(const __nv_bfloat16* p,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row major) * b (16 x 8, column major), bf16 in, fp32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two fp32 values as three bf16 pairs whose sum holds them to about 24
// bits: hi, their rounding to bf16, then mid and lo, the rounding of what
// is left at each step. So P V taken as hi V + mid V + lo V matches an
// fp32 P V (V is bf16, exact in both); one bf16 P alone moves the output
// by up to 2^-9 of itself, enough to take a model's logits outside bf16's
// tolerance.
__device__ __forceinline__ void split3_bf16(float a, float b, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(a, b);
  a -= __uint_as_float(hi << 16);
  b -= __uint_as_float(hi & 0xffff0000u);
  mid = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(mid << 16),
                 b - __uint_as_float(mid & 0xffff0000u));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Channels ch, ch + 1 of one bf16 output row (ch even), those below hd.
// VEC: hd % 8 == 0, so both or neither are, and the pair is 4-byte aligned.
template <bool VEC>
__device__ __forceinline__ void store_pair(__nv_bfloat16* o, int ch, int hd,
                                           float x, float y) {
  if constexpr (VEC) {
    if (ch < hd) {
      *reinterpret_cast<__nv_bfloat162*>(o + ch) =
          __floats2bfloat162_rn(x, y);
    }
  } else {
    if (ch < hd) o[ch] = __float2bfloat16_rn(x);
    if (ch + 1 < hd) o[ch + 1] = __float2bfloat16_rn(y);
  }
}

// A launch above 48 KB of dynamic shared memory must opt in first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace attn
