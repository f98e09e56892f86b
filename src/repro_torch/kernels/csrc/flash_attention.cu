// Flash attention (prefill / forward) for Hopper (sm_90a): online-softmax
// attention of a whole prompt, GQA, causal or not, optional sliding window.
//
// Replaces: flash_attention_kernel in src/repro/kernels/flash_attention.py.
// Semantics are the same: q (b, sq, h, hd) against k, v (b, skv, kvh, hd),
// query head kh * g + i reading KV head kh; query row i sits at position
// qpos = q_offset + i and sees kv position kpos < skv when kpos <= qpos
// (causal, aligned at the top left: kv positions count from 0 and queries
// from q_offset, whatever sq and skv are) and kpos > qpos - window (window
// > 0); softmax in fp32 with running max/sum/accumulator; out = acc /
// max(l, 1e-30) in q's type. q_offset is P-Tuning v2's prefix length: its
// prefill attends over [prefix | k], which the reference sends to XLA.
//
// Bound on an H100: at the prefill's shapes (512-token prompts, hd 64) the
// work is about 2 * 2 * hd flops per visible (query head, kv) pair against
// each q, k, v and out element moved once: a few hundred flops per byte,
// near the card's bf16 ridge. This simple kernel runs its products in fp32
// on the CUDA cores, so it is bound by their issue rate, not by either.
//
// Design, right and simple first:
// - one block (eight warps) per (query tile, KV head, batch row); the tile
//   is 96 // g query positions, so its R = (96 // g) * g query rows (g = 3:
//   32 positions x 3 heads = 96 rows) share every staged K/V tile;
// - q, k and v are read in their native (b, s, heads, hd) layouts through
//   the strides the wrapper passes, the ragged ends masked here: the TPU
//   wrapper's transposes and padding copies are gone;
// - kv tiles of 32 positions, one per lane, walked in a loop from the first
//   position any row's window reaches to the last the causal mask lets the
//   tile's last query see: tiles that every row masks are never read;
// - row r of the tile belongs to warp r % 8 for the whole walk: its scores
//   (lane = kv position, K staged transposed so lanes read 32 banks), its
//   softmax (warp shuffles for max and sum), its probabilities (through the
//   warp's own shared rows) and its accumulator (lane = channels lane +
//   32 c) stay with that warp, so only the K/V staging needs the block;
// - q is staged once in fp32, zero padded to a multiple of 4 channels for
//   16-byte shared loads; everything accumulates in fp32.
// Tensor cores (mma.sync or wgmma on bf16 tiles), TMA and pipelining are
// left for later.
//
// C interface (ctypes): every pointer and the stream are void*; returns
// cudaGetLastError() after the launch.

#include "attention_common.cuh"

namespace {

using attn::kNeg;
using attn::load1;
using attn::store1;
using attn::warp_max;
using attn::warp_sum;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 96;                 // query rows per block at most
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kTile = 32;                 // kv positions per tile
constexpr int kKt = kTile + 1;            // transposed K row stride

__host__ __device__ inline int round4(int hd) { return (hd + 3) / 4 * 4; }

size_t smem_bytes(int hd) {
  const size_t hd4 = round4(hd);
  return sizeof(float) * (kRows * hd4 +           // q rows
                          hd4 * kKt +             // K tile, transposed
                          kTile * static_cast<size_t>(hd) +  // V tile
                          kRows * kTile);         // probabilities
}

struct Strides {
  int64_t b, s, h;  // elements; the channel stride is 1
};

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       Strides qs, Strides ks, Strides vs, int sq, int skv,
                       int h, int kvh, int hd, int causal, int window,
                       int q_offset, float scale) {
  extern __shared__ float smem[];
  const int hd4 = round4(hd);
  float* q_s = smem;                      // kRows * hd4
  float* k_t = q_s + kRows * hd4;         // hd4 * kKt
  float* v_s = k_t + hd4 * kKt;           // kTile * hd
  float* p_s = v_s + kTile * hd;          // kRows * kTile

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = h / kvh;
  const int bq = kRows / g;               // query positions per tile
  const int R = bq * g;
  const int q_lo = blockIdx.x * bq;
  const int kh = blockIdx.y;
  const int64_t bi = blockIdx.z;

  // ---- stage the tile's query rows (row r = position r / g, head r % g)
  const T* qb = q + bi * qs.b + static_cast<int64_t>(kh) * g * qs.h;
  for (int i = tid; i < kRows * hd4; i += kThreads) {
    const int r = i / hd4;
    const int e = i % hd4;
    const int qpos = q_lo + r / g;
    float x = 0.0f;
    if (r < R && qpos < sq && e < hd) {
      x = load1(qb + qpos * qs.s + (r % g) * qs.h + e);
    }
    q_s[i] = x;
  }
  for (int i = tid; i < (hd4 - hd) * kKt; i += kThreads) {
    k_t[hd * kKt + i] = 0.0f;             // padding channels stay zero
  }

  // ---- the kv range some row of the tile can see (positions, not rows)
  const int q_hi = min(q_lo + bq, sq) - 1;
  const int k_end = causal ? min(skv, q_offset + q_hi + 1) : skv;
  const int k_beg = window > 0 ? max(0, q_offset + q_lo - window + 1) : 0;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][C];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[rr][c] = 0.0f;
  }
  const T* kb = k + bi * ks.b + kh * ks.h;
  const T* vb = v + bi * vs.b + kh * vs.h;

  for (int k0 = k_beg; k0 < k_end; k0 += kTile) {
    const int n = min(kTile, k_end - k0);
    __syncthreads();                      // the last tile is consumed
    for (int i = tid; i < kTile * hd; i += kThreads) {
      const int j = i / hd;
      const int e = i % hd;
      float kx = 0.0f, vx = 0.0f;
      if (j < n) {
        const int64_t p = k0 + j;
        kx = load1(kb + p * ks.s + e);
        vx = load1(vb + p * vs.s + e);
      }
      k_t[e * kKt + j] = kx;
      v_s[j * hd + e] = vx;
    }
    __syncthreads();
    // ---- scores: row warp + 8 rr against kv position k0 + lane
    float s[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = 0.0f;
    for (int e = 0; e < hd4; e += 4) {
      const float k0v = k_t[e * kKt + lane];
      const float k1v = k_t[(e + 1) * kKt + lane];
      const float k2v = k_t[(e + 2) * kKt + lane];
      const float k3v = k_t[(e + 3) * kKt + lane];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(
            q_s + (warp + kWarps * rr) * hd4 + e);
        s[rr] = fmaf(qv.x, k0v, s[rr]);
        s[rr] = fmaf(qv.y, k1v, s[rr]);
        s[rr] = fmaf(qv.z, k2v, s[rr]);
        s[rr] = fmaf(qv.w, k3v, s[rr]);
      }
    }
    // ---- mask and online softmax, one row at a time across the lanes
    const int kpos = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp + kWarps * rr;
      const int qrow = q_lo + r / g;
      const int qpos = q_offset + qrow;
      bool ok = lane < n && r < R && qrow < sq;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      const float sv = ok ? s[rr] * scale : kNeg;
      const float m_new = fmaxf(m[rr], warp_max(sv));
      const float pr = expf(sv - m_new);
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + warp_sum(pr);
      m[rr] = m_new;
      p_s[r * kTile + lane] = pr;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[rr][c] *= corr;
    }
    __syncwarp();
    // ---- acc[r][e] += sum_j p[r][j] * v[j][e], e = lane + 32 c (V rows
    // past n were staged as zeros, so the last step of 4 may run over them)
    for (int j = 0; j < n; j += 4) {
      float vv[4][C];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int e = lane + 32 * c;
          vv[x][c] = e < hd ? v_s[(j + x) * hd + e] : 0.0f;
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 pv = *reinterpret_cast<const float4*>(
            p_s + (warp + kWarps * rr) * kTile + j);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float a = acc[rr][c];
          a = fmaf(pv.x, vv[0][c], a);
          a = fmaf(pv.y, vv[1][c], a);
          a = fmaf(pv.z, vv[2][c], a);
          a = fmaf(pv.w, vv[3][c], a);
          acc[rr][c] = a;
        }
      }
    }
  }

  // ---- out = acc / l for the tile's real rows
  T* ob = out + (bi * sq) * static_cast<int64_t>(h) * hd;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + kWarps * rr;
    const int qpos = q_lo + r / g;
    if (r < R && qpos < sq) {
      const float den = fmaxf(l[rr], 1e-30f);
      T* o = ob + (static_cast<int64_t>(qpos) * h + kh * g + r % g) * hd;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = lane + 32 * c;
        if (e < hd) store1(o + e, acc[rr][c] / den);
      }
    }
  }
}

template <typename T, int C>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   Strides qs, Strides ks, Strides vs, int b, int sq,
                   int skv, int h, int kvh, int hd, int causal, int window,
                   int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  auto kernel = flash_attention_kernel<T, C>;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int bq = kRows / (h / kvh);
  const dim3 grid((sq + bq - 1) / bq, kvh, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, sq, skv, h,
      kvh, hd, causal, window, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// q (b, sq, h, hd), k and v (b, skv, kvh, hd), each with the channel stride
// 1 and the given batch, sequence and head strides (elements); out (b, sq,
// h, hd) contiguous. bf16 picks bf16 (1) or float32 (0) for all four.
// q_offset (>= 0): query row i sits at position q_offset + i.
// Requires h % kvh == 0, h / kvh <= 96 and hd <= 128.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int b, int sq, int skv, int h,
                               int kvh, int hd, int64_t q_sb, int64_t q_ss,
                               int64_t q_sh, int64_t k_sb, int64_t k_ss,
                               int64_t k_sh, int64_t v_sb, int64_t v_ss,
                               int64_t v_sh, int causal, int window,
                               int q_offset, float scale, int bf16,
                               void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = hd <= 64 ? launch<__nv_bfloat16, 2>(q, k, v, out, qs, ks, vs, b, sq,
                                              skv, h, kvh, hd, causal, window,
                                              q_offset, scale, s)
                   : launch<__nv_bfloat16, 4>(q, k, v, out, qs, ks, vs, b, sq,
                                              skv, h, kvh, hd, causal, window,
                                              q_offset, scale, s);
  } else {
    err = hd <= 64 ? launch<float, 2>(q, k, v, out, qs, ks, vs, b, sq, skv, h,
                                      kvh, hd, causal, window, q_offset,
                                      scale, s)
                   : launch<float, 4>(q, k, v, out, qs, ks, vs, b, sq, skv, h,
                                      kvh, hd, causal, window, q_offset,
                                      scale, s);
  }
  return static_cast<int>(err);
}
