// Multi-task AoT gather-add: out[t] = h[t] + tables[task_ids[t], ids[t]]
// (the paper's Eq. 1 across tasks), for Hopper (sm_90a).
//
// Replaces: aot_gather_add_multitask_kernel in src/repro/kernels/aot_bias.py,
// which scalar-prefetches the (task, token) pairs so that each TPU grid step
// DMAs exactly one table row and adds it in VMEM.
//
// Bound on an H100: bytes. A token reads one row of h and one table row and
// writes one row, 3 * d elements, and does one addition per element. At the
// serving tick's few hundred tokens a call moves about a megabyte, so in
// practice it is bound by the launch, not by the 3.35 TB/s of the card.
//
// Design: one block per token row. The block reads its (task, id) pair once,
// wraps a negative index once and clamps both into range (what the XLA
// gather it stands in for does), and streams the row with 16-byte loads where
// d and the pointers allow it, one element per load otherwise. Row offsets
// are 64-bit. The table element is converted to h's type first and the sum
// is rounded to h's type, so the result is bitwise that of the plain version
// (h + table[task, id].to(h.dtype)). Fusing this pass into the RMSNorm that
// follows it is left for later.
//
// C interface (ctypes): every pointer and the stream are void*; returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kVec = 8;  // elements per vector access (16 bytes of bf16)

__device__ __forceinline__ float bf16_bits_to_float(unsigned bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ unsigned float_to_bf16_bits(float x) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

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
      f[2 * i] = bf16_bits_to_float(w[i] & 0xffffu);
      f[2 * i + 1] = bf16_bits_to_float(w[i] >> 16);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&f)[kVec]) {
  if constexpr (std::is_same<T, float>::value) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  } else {
    uint4 u;
    u.x = float_to_bf16_bits(f[0]) | (float_to_bf16_bits(f[1]) << 16);
    u.y = float_to_bf16_bits(f[2]) | (float_to_bf16_bits(f[3]) << 16);
    u.z = float_to_bf16_bits(f[4]) | (float_to_bf16_bits(f[5]) << 16);
    u.w = float_to_bf16_bits(f[6]) | (float_to_bf16_bits(f[7]) << 16);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// x rounded to the type TH, returned as the float of equal value
template <typename TH>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<TH, float>::value) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

// h + p in h's type, p already of h's type: the float sum of two values of
// type TH rounded once to TH (exact for float; for bf16 the float sum is
// rounded to nearest even, as bf16 addition is)
template <typename TH>
__device__ __forceinline__ float add_in(float h, float p) {
  return round_to<TH>(__fadd_rn(h, p));
}

// numpy/XLA gather index rule: a negative index wraps once, then clamps
__device__ __forceinline__ int64_t gather_index(int32_t i, int n) {
  int64_t j = i < 0 ? static_cast<int64_t>(i) + n : static_cast<int64_t>(i);
  j = j < 0 ? 0 : j;
  return j > n - 1 ? n - 1 : j;
}

template <typename TH, typename TT, bool VEC>
__global__ void aot_gather_add_mt_kernel(const TH* __restrict__ h,
                                         const TT* __restrict__ tables,
                                         const int32_t* __restrict__ task_ids,
                                         const int32_t* __restrict__ ids,
                                         TH* __restrict__ out, int n_tasks,
                                         int vocab, int d) {
  const int64_t t = blockIdx.x;
  const int64_t task = gather_index(task_ids[t], n_tasks);
  const int64_t id = gather_index(ids[t], vocab);
  const TT* row = tables + (task * vocab + id) * static_cast<int64_t>(d);
  const TH* hrow = h + t * d;
  TH* orow = out + t * d;
  if constexpr (VEC) {
    for (int c = threadIdx.x * kVec; c < d; c += blockDim.x * kVec) {
      float hv[kVec], pv[kVec];
      load8(hrow + c, hv);
      load8(row + c, pv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) hv[i] = add_in<TH>(hv[i], round_to<TH>(pv[i]));
      store8(orow + c, hv);
    }
  } else {
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      store1(orow + c, add_in<TH>(load1(hrow + c), round_to<TH>(load1(row + c))));
    }
  }
}

template <typename TH, typename TT>
void launch(const void* h, const void* tables, const void* task_ids,
            const void* ids, void* out, int T, int n_tasks, int vocab, int d,
            bool vec, cudaStream_t stream) {
  const int per = vec ? kVec : 1;
  int threads = ((d / per + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const auto* hp = static_cast<const TH*>(h);
  const auto* tp = static_cast<const TT*>(tables);
  const auto* tid = static_cast<const int32_t*>(task_ids);
  const auto* iid = static_cast<const int32_t*>(ids);
  auto* op = static_cast<TH*>(out);
  if (vec) {
    aot_gather_add_mt_kernel<TH, TT, true><<<T, threads, 0, stream>>>(
        hp, tp, tid, iid, op, n_tasks, vocab, d);
  } else {
    aot_gather_add_mt_kernel<TH, TT, false><<<T, threads, 0, stream>>>(
        hp, tp, tid, iid, op, n_tasks, vocab, d);
  }
}

}  // namespace

// h (T, d), tables (n_tasks, vocab, d), task_ids and ids (T,) int32, out
// (T, d) of h's type. h_bf16 / table_bf16 pick bf16 (1) or float32 (0).
// vec: 1 when d % 8 == 0 and every pointer is 16-byte aligned.
extern "C" int aot_gather_add_multitask(const void* h, const void* tables,
                                        const void* task_ids, const void* ids,
                                        void* out, int T, int n_tasks,
                                        int vocab, int d, int h_bf16,
                                        int table_bf16, int vec,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  if (h_bf16 && table_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(h, tables, task_ids, ids, out, T,
                                         n_tasks, vocab, d, v, s);
  } else if (h_bf16) {
    launch<__nv_bfloat16, float>(h, tables, task_ids, ids, out, T, n_tasks,
                                 vocab, d, v, s);
  } else if (table_bf16) {
    launch<float, __nv_bfloat16>(h, tables, task_ids, ids, out, T, n_tasks,
                                 vocab, d, v, s);
  } else {
    launch<float, float>(h, tables, task_ids, ids, out, T, n_tasks, vocab, d,
                         v, s);
  }
  return static_cast<int>(cudaGetLastError());
}
