// Device helpers shared by the port's attention kernels (sm_90a): element
// loads and stores in float32 or bfloat16, 16-byte loads of 8 elements,
// warp reductions, asynchronous staging of (positions, channels) tiles into
// padded shared rows (cp.async), and the opt-in to more than 48 KB of
// dynamic shared memory. Every kernel computes in float32.

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

// Stage ROWS rows of a (positions, channels) matrix, row r at src + r *
// stride, into dst[r * kLd + e]: channels e < hd of rows r < count, zeros
// elsewhere (the padding channels and the rows past the end). VEC: 16-byte
// cp.async copies (src, stride and hd all in whole 16-byte units; eight
// consecutive threads cover a 128-byte row), left in flight for the caller
// to commit and wait on; else element loads stored synchronously, for
// rows that are not 16-byte aligned. THREADS threads take part.
template <typename T, int HDP, int ROWS, int THREADS, bool VEC>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           int64_t stride, int count, int hd,
                                           int tid) {
  using L = Tile<T, HDP>;
  if constexpr (VEC) {
    constexpr int kChunks = HDP / L::kVecE;
    static_assert(ROWS * kChunks % THREADS == 0, "whole passes");
#pragma unroll
    for (int it = 0; it < ROWS * kChunks / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / kChunks;
      const int c = i % kChunks;
      const bool ok = r < count && c * L::kVecE < hd;
      cp_async16(dst + r * L::kLd + c * L::kVecE,
                 ok ? src + r * stride + c * L::kVecE : src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * HDP; i += THREADS) {
      const int r = i / HDP;
      const int e = i % HDP;
      store1(dst + r * L::kLd + e,
             r < count && e < hd ? load1(src + r * stride + e) : 0.0f);
    }
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
