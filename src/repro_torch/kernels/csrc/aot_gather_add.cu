// AoT gather-add: out[t] = h[t] + P[ids[t]] (the paper's Eq. 1), for one
// task's table or across tasks, fused with the RMSNorm that each layer
// applies to that sum next, for Hopper (sm_90a).
//
// Replaces, in src/repro/kernels/aot_bias.py, both TPU kernels, which
// scalar-prefetch the indices so that each TPU grid step DMAs exactly one
// table row and adds it in VMEM:
// - aot_gather_add_kernel: one table (V, d), C entries aot_gather_add and
//   aot_gather_add_norm;
// - aot_gather_add_multitask_kernel: tables (n_tasks, V, d) indexed by
//   (task, token), C entries aot_gather_add_multitask and
//   aot_gather_add_multitask_norm.
// The entries without _norm are the exact counterparts of the TPU kernels.
// A third mode reads no table: C entry rms_norm, the norm alone (no TPU
// kernel; the reference leaves its norms to XLA), which the methods without
// AoT take for their block's input norm.
//
// Bound on an H100: bytes. A token reads one row of h and one table row and
// writes one row (3 d elements; 4 d with the norm, which also writes the
// normed row x) and does a few operations per element. At the serving
// tick's few hundred tokens a call moves about a megabyte, so the gather-add
// alone is bound by the launch, not by the 3.35 TB/s of the card, and
// cannot come much closer to its bound. What it can take out is the pass
// that follows it: the block's input RMSNorm, which PyTorch runs as eight
// elementwise launches, each reading and writing the whole activation.
//
// Design: one block per token row; every entry shares the device body,
// templated on whether a task index exists and on the mode (add, add and
// norm, norm alone). The block reads its index (or (task, id) pair) once
// and streams the row with 16-byte loads where d and the pointers allow it,
// one element per load otherwise. Row offsets are 64-bit. The index rules
// are those of the reference's XLA gathers:
// - multi-task (table[task_ids, ids]): a negative index wraps once, then
//   both clamp into range;
// - one table (jnp.take(table, ids, axis=0), the model's rows_fused): a
//   negative id wraps once, and an id still outside [0, V) reads a row of
//   NaN, which jnp.take fills in for an out-of-range index.
// The table element is converted to h's type first and the sum s is rounded
// to h's type, so s is bitwise that of the plain version
// (h + row.to(h.dtype)). With the norm, the block keeps s on chip, in
// float32 in d floats of shared memory, sums s * s in float32 (warp
// shuffles, then across warps, in one fixed order: a row gives the same
// bits in every mode), takes r = rsqrtf(sum / d + eps) and writes
// x = (s * r) * scale rounded to h's type: layers.apply_norm's float32
// steps in its order, so x differs from apply_norm(s) only by the order of
// the reduction and the rounding of rsqrtf.
//
// C interface (ctypes): every pointer and the stream are void*; returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kVec = 8;             // elements per vector access (16 bytes of bf16)
constexpr int kMaxThreads = 256;
constexpr size_t kSmemNoOptIn = 48 * 1024;  // dynamic shared memory without opt-in

// what a launch computes: s = h + row, written to out (kAdd); s and its
// norm x, both written (kAddNorm); the norm x of s = h alone (kNorm)
enum Mode { kAdd, kAddNorm, kNorm };

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

// jnp.take's rule: a negative index wraps once; -1 when still out of range
__device__ __forceinline__ int64_t take_index(int32_t i, int n) {
  const int64_t j =
      i < 0 ? static_cast<int64_t>(i) + n : static_cast<int64_t>(i);
  return j < 0 || j >= n ? -1 : j;
}

// The sum of v over the block (blockDim.x a multiple of 32), the same bits
// in every thread: each warp sums by butterfly shuffles (partners add the
// same two values, so every lane holds the same sum), then every warp adds
// the warps' sums in the same fixed order.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[kMaxThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  if (lane == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? part[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// TASK: tables (n_tasks, vocab, d) indexed by (task_ids[t], ids[t]), else
// one table (vocab, d) indexed by ids[t] (task_ids and n_tasks unused).
// kNorm reads no table (tables, task_ids and ids unused; TT is TH) and
// writes no out; kAdd reads no scale and writes no x. The modes with the
// norm keep the row's s in ``srow``, d floats of dynamic shared memory;
// each thread reads back only the elements it wrote.
template <typename TH, typename TT, bool VEC, bool TASK, Mode MODE>
__global__ void aot_gather_add_kernel(const TH* __restrict__ h,
                                      const TT* __restrict__ tables,
                                      const int32_t* __restrict__ task_ids,
                                      const int32_t* __restrict__ ids,
                                      const float* __restrict__ scale,
                                      TH* __restrict__ out,
                                      TH* __restrict__ x, int n_tasks,
                                      int vocab, int d, float eps) {
  extern __shared__ __align__(16) float srow[];
  constexpr bool kTable = MODE != kNorm;
  constexpr bool kNormed = MODE != kAdd;
  const int64_t t = blockIdx.x;
  int64_t r = 0;                  // row of the (rows, d) table, -1: NaN row
  if constexpr (kTable) {
    if constexpr (TASK) {
      r = gather_index(task_ids[t], n_tasks) * vocab +
          gather_index(ids[t], vocab);
    } else {
      r = take_index(ids[t], vocab);
    }
  }
  const bool nan_row = r < 0;
  const float qnan = __int_as_float(0x7fc00000);  // a quiet NaN
  const TT* row =
      kTable ? tables + (nan_row ? 0 : r) * static_cast<int64_t>(d) : nullptr;
  const TH* hrow = h + t * d;
  TH* orow = kTable ? out + t * d : nullptr;
  float ss = 0.f;                 // this thread's share of sum(s * s)
  if constexpr (VEC) {
    for (int c = threadIdx.x * kVec; c < d; c += blockDim.x * kVec) {
      float s[kVec];
      load8(hrow + c, s);
      if constexpr (kTable) {
        float p[kVec];
        if (nan_row) {
#pragma unroll
          for (int i = 0; i < kVec; ++i) p[i] = qnan;
        } else {
          load8(row + c, p);
        }
#pragma unroll
        for (int i = 0; i < kVec; ++i) s[i] = add_in<TH>(s[i], round_to<TH>(p[i]));
        store8(orow + c, s);
      }
      if constexpr (kNormed) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) ss = fmaf(s[i], s[i], ss);
        store8(srow + c, s);
      }
    }
  } else {
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      float s = load1(hrow + c);
      if constexpr (kTable) {
        s = add_in<TH>(s, round_to<TH>(nan_row ? qnan : load1(row + c)));
        store1(orow + c, s);
      }
      if constexpr (kNormed) {
        ss = fmaf(s, s, ss);
        srow[c] = s;
      }
    }
  }
  if constexpr (kNormed) {
    const float rs =
        rsqrtf(block_sum(ss) / static_cast<float>(d) + eps);
    TH* xrow = x + t * d;
    if constexpr (VEC) {
      for (int c = threadIdx.x * kVec; c < d; c += blockDim.x * kVec) {
        float s[kVec], g[kVec];
        load8(srow + c, s);
        load8(scale + c, g);
#pragma unroll
        for (int i = 0; i < kVec; ++i) s[i] = __fmul_rn(__fmul_rn(s[i], rs), g[i]);
        store8(xrow + c, s);
      }
    } else {
      for (int c = threadIdx.x; c < d; c += blockDim.x) {
        store1(xrow + c, __fmul_rn(__fmul_rn(srow[c], rs), scale[c]));
      }
    }
  }
}

// one launch's arguments, as the C entries receive them
struct Args {
  const void* h;
  const void* tables;
  const void* task_ids;
  const void* ids;
  const float* scale;
  void* out;
  void* x;
  int T, n_tasks, vocab, d;
  float eps;
  bool vec;
  cudaStream_t stream;
};

template <bool TASK, Mode MODE, typename TH, typename TT>
int launch(const Args& a) {
  const int per = a.vec ? kVec : 1;
  int threads = ((a.d / per + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  const size_t smem = MODE == kAdd ? 0 : static_cast<size_t>(a.d) * sizeof(float);
  auto* kernel = a.vec ? &aot_gather_add_kernel<TH, TT, true, TASK, MODE>
                       : &aot_gather_add_kernel<TH, TT, false, TASK, MODE>;
  if (smem > kSmemNoOptIn) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<a.T, threads, smem, a.stream>>>(
      static_cast<const TH*>(a.h), static_cast<const TT*>(a.tables),
      static_cast<const int32_t*>(a.task_ids),
      static_cast<const int32_t*>(a.ids), a.scale, static_cast<TH*>(a.out),
      static_cast<TH*>(a.x), a.n_tasks, a.vocab, a.d, a.eps);
  return static_cast<int>(cudaGetLastError());
}

// h_bf16 / table_bf16 pick bf16 (1) or float32 (0) for h and the table
template <bool TASK, Mode MODE>
int dispatch(const Args& a, int h_bf16, int table_bf16) {
  if (h_bf16 && table_bf16) {
    return launch<TASK, MODE, __nv_bfloat16, __nv_bfloat16>(a);
  } else if (h_bf16) {
    return launch<TASK, MODE, __nv_bfloat16, float>(a);
  } else if (table_bf16) {
    return launch<TASK, MODE, float, __nv_bfloat16>(a);
  }
  return launch<TASK, MODE, float, float>(a);
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
  const Args a{h, tables, task_ids, ids, nullptr, out, nullptr, T, n_tasks,
               vocab, d, 0.f, vec != 0, static_cast<cudaStream_t>(stream)};
  return dispatch<true, kAdd>(a, h_bf16, table_bf16);
}

// h (T, d), table (vocab, d), ids (T,) int32, out (T, d) of h's type; the
// other arguments as for aot_gather_add_multitask.
extern "C" int aot_gather_add(const void* h, const void* table,
                              const void* ids, void* out, int T, int vocab,
                              int d, int h_bf16, int table_bf16, int vec,
                              void* stream) {
  const Args a{h, table, nullptr, ids, nullptr, out, nullptr, T, 1, vocab,
               d, 0.f, vec != 0, static_cast<cudaStream_t>(stream)};
  return dispatch<false, kAdd>(a, h_bf16, table_bf16);
}

// aot_gather_add_multitask, and also x (T, d) of h's type, the RMSNorm of
// out: x = out * rsqrt(mean(out^2) + eps) * scale, scale (d,) float32.
// vec also needs scale and x 16-byte aligned.
extern "C" int aot_gather_add_multitask_norm(
    const void* h, const void* tables, const void* task_ids, const void* ids,
    const void* scale, void* out, void* x, int T, int n_tasks, int vocab,
    int d, float eps, int h_bf16, int table_bf16, int vec, void* stream) {
  const Args a{h, tables, task_ids, ids, static_cast<const float*>(scale),
               out, x, T, n_tasks, vocab, d, eps, vec != 0,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true, kAddNorm>(a, h_bf16, table_bf16);
}

// aot_gather_add, and also x as for aot_gather_add_multitask_norm.
extern "C" int aot_gather_add_norm(const void* h, const void* table,
                                   const void* ids, const void* scale,
                                   void* out, void* x, int T, int vocab,
                                   int d, float eps, int h_bf16,
                                   int table_bf16, int vec, void* stream) {
  const Args a{h, table, nullptr, ids, static_cast<const float*>(scale),
               out, x, T, 1, vocab, d, eps, vec != 0,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false, kAddNorm>(a, h_bf16, table_bf16);
}

// x (T, d) of h's type, the RMSNorm of h (T, d) with scale (d,) float32, as
// aot_gather_add_norm computes it from its sum; no table.
extern "C" int rms_norm(const void* h, const void* scale, void* x, int T,
                        int d, float eps, int h_bf16, int vec, void* stream) {
  const Args a{h, nullptr, nullptr, nullptr, static_cast<const float*>(scale),
               nullptr, x, T, 1, 1, d, eps, vec != 0,
               static_cast<cudaStream_t>(stream)};
  return h_bf16 ? launch<false, kNorm, __nv_bfloat16, __nv_bfloat16>(a)
                : launch<false, kNorm, float, float>(a);
}
