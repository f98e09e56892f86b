// Flash attention (prefill / forward) for Hopper (sm_90a): online-softmax
// attention of a whole prompt, GQA, causal or not, optional sliding window.
//
// Replaces: flash_attention_kernel in src/repro/kernels/flash_attention.py.
// Semantics are the same: q (b, sq, h, hd) against k, v (b, skv, kvh, hd),
// query head kh * g + i reading KV head kh; query row i sits at position
// qpos = q_offset + i and sees kv position kpos < skv when kpos <= qpos
// (causal, aligned at the top left: kv positions count from 0 and queries
// from q_offset, whatever sq and skv are) and kpos > qpos - window (window
// > 0); masked scores take the finite value -1e30; softmax in fp32 with
// running max/sum/accumulator; out = acc / max(l, 1e-30) in q's type.
// q_offset is P-Tuning v2's prefix length: its prefill attends over [prefix
// | k], which the reference sends to XLA.
//
// Bound on an H100: at the prefill's shapes (512-token prompts, hd 64) the
// work is 4 hd flops per visible (query head, kv) pair against each q, k, v
// and out element moved once: a few hundred flops per byte, near the card's
// bf16 ridge (~295 flops per byte), so the tensor cores' 989 TFLOP/s and
// the 3.35 TB/s bound it about equally. Run on the CUDA cores in fp32 (67
// TFLOP/s), as the first port of this kernel did, it was 56x over that
// bound and 19x slower than one SDPA call.
//
// bf16, on the tensor cores (flash_mma_kernel), FlashAttention-2's forward:
// - one block of four warps per (tile of 64 query positions, query head,
//   batch row); warp w owns query rows 16 w .. 16 w + 15. The g query heads
//   of one KV head are neighbouring blocks, so their re-reads of its K/V
//   come from L2. The block index runs over heads, then rows, then query
//   tiles from the last to the first: causally the heaviest tiles start
//   first and the short ones fill the tail;
// - q, k and v are read in their native (b, s, heads, hd) layouts through
//   the strides the wrapper passes; hd is padded with zeros to 64 or 128
//   (one instance each) in shared memory, whose rows carry 16 bytes of
//   padding so that ldmatrix reads them free of bank conflicts;
// - K/V tiles of 64 positions are staged in bf16 with cp.async (16 bytes a
//   thread) in a ring of three stages at hd <= 64 (63 KB: three blocks an
//   SM, as many as their registers allow) and two at hd 128: the next
//   tiles load while this one is multiplied. A second build takes element
//   loads into the same layout where rows are not 16-byte aligned (hd % 8
//   != 0, an odd stride or pointer);
// - both products are mma.sync.m16n8k16 on bf16 with fp32 accumulators:
//   Q's A fragments are loaded once with ldmatrix and kept in registers;
//   S = Q K^T takes K's B fragments by ldmatrix; the online softmax runs on
//   the S fragments in registers (row max and sum over the quad that holds
//   a row, by shuffles; expf as the plain version takes it); P is split in
//   registers into three bf16 parts (hi, mid, lo: about 24 bits together)
//   fed straight back as the A operands of P V, with V's B fragments by
//   ldmatrix.trans; at hd <= 64 a tile's P V sums in an accumulator of its
//   own that joins the running one with one rounding per element;
// - the walk runs from the first position any row's window reaches to the
//   last the causal mask lets the tile's last row see: tiles that every row
//   masks are never read, and only tiles that cross the diagonal, a window
//   edge or the end of k apply the mask.
// Numerics: the plain version is fp32. One bf16 P (2^-9 of itself) keeps
// every output within bf16's 2e-2 of it, but puts 38% of them an ulp of
// bf16 away from it (0.03% with three parts; chip_smoke.py phase 4 on an
// H100), and a 2-layer full-width model's logits through the kernels then
// miss the bf16 tolerance against the plain versions' at every seed that
// chip_seeds.py tried. The three parts and the tile accumulator bring the
// kernel back near fp32; they cost two more products per P V step, about
// a third of the kernel's time. Neither removes greedy-token flips at near
// ties, which the first port's fp32 kernel shows about as often.
// fp32 keeps the first port's body on the CUDA cores (flash_simt_kernel):
// mma.sync has no fp32 input short of TF32, which would miss fp32's 2e-5
// tolerance. No served path runs fp32 attention.
// What holds it back (chip_smoke.py phase 4 on an H100 80GB HBM3 at 700
// W): with one bf16 P it took about 0.06 ms at (16, 512) causal against
// SDPA's 0.036 and a bound of 0.0125, and that time barely moved with two
// 16-row tiles a warp, 128 registers a thread, tiles of 32 positions or a
// folded scale: stalls between the dependent phases of each tile (S, then
// softmax, then P V), not one unit's rate, bound it. Left for later: wgmma
// on 64-row warpgroup tiles with TMA staging and a producer warp, two
// warpgroups overlapping one's softmax with the other's products, and a
// persistent schedule over the tiles.
//
// C interface (ctypes): every pointer and the stream are void*; returns
// cudaGetLastError() after the launch.

#include "attention_common.cuh"

namespace {

using attn::kNeg;
using attn::ldsm_x4;
using attn::ldsm_x4_trans;
using attn::load1;
using attn::mma_bf16;
using attn::quad_max;
using attn::quad_sum;
using attn::split3_bf16;
using attn::store1;
using attn::store_pair;
using attn::warp_max;
using attn::warp_sum;

struct Strides {
  int64_t b, s, h;  // elements; the channel stride is 1
};

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;          // four warps, 16 query rows each
constexpr int kBq = 64;                   // query positions per block
constexpr int kBk = 64;                   // kv positions per staged tile

// K/V tiles in flight: three at hd <= 64 (63 KB of shared memory, three
// blocks an SM, as many as their registers allow), two at hd 128 (87 KB)
template <int HDP>
struct Stages {
  static constexpr int k = HDP <= 64 ? 3 : 2;
};

template <int HDP>
size_t mma_smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(HDP + 8) *
         (kBq + 2 * Stages<HDP>::k * kBk);
}

template <int HDP, bool VEC>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 Strides qs, Strides ks, Strides vs, int b, int sq, int skv,
                 int h, int kvh, int hd, int causal, int window, int q_offset,
                 float scale) {
  constexpr int kLd = attn::Tile<bf16, HDP>::kLd;
  constexpr int kKc = HDP / 16;           // 16-channel steps of Q K^T
  constexpr int kNc = HDP / 8;            // 8-channel output tiles of P V
  constexpr int kNt = kBk / 8;            // 8-position score tiles
  constexpr int kStages = Stages<HDP>::k;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // kBq rows
  bf16* k_s = q_s + kBq * kLd;                       // kStages x kBk rows
  bf16* v_s = k_s + kStages * kBk * kLd;             // kStages x kBk rows

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_qt = (sq + kBq - 1) / kBq;
  const int64_t id = blockIdx.x;
  const int head = static_cast<int>(id % h);
  const int64_t bi = (id / h) % b;
  const int q_lo = (n_qt - 1 - static_cast<int>(id / (int64_t{h} * b))) * kBq;
  const int kh = head / (h / kvh);

  // ---- the kv range some row of the tile can see (positions, not rows)
  const int q_hi = min(q_lo + kBq, sq) - 1;
  const int k_end = causal ? min(skv, q_offset + q_hi + 1) : skv;
  const int k_beg = window > 0 ? max(0, q_offset + q_lo - window + 1) : 0;
  const int n_tiles = k_end > k_beg ? (k_end - k_beg + kBk - 1) / kBk : 0;

  const bf16* kb = k + bi * ks.b + kh * ks.h;
  const bf16* vb = v + bi * vs.b + kh * vs.h;
  auto stage_kv = [&](int t) {
    const int k0 = k_beg + t * kBk;
    const int st = t % kStages;
    attn::stage_rows<bf16, HDP, kBk, kMmaThreads, VEC>(
        k_s + st * kBk * kLd, attn::StridedRows<bf16>{kb + k0 * ks.s, ks.s},
        k_end - k0, hd, tid);
    attn::stage_rows<bf16, HDP, kBk, kMmaThreads, VEC>(
        v_s + st * kBk * kLd, attn::StridedRows<bf16>{vb + k0 * vs.s, vs.s},
        k_end - k0, hd, tid);
  };

  // ---- lane roles in the m16n8k16 fragments: rows g and g + 8 of the
  // warp's 16, columns 2 t and 2 t + 1 of each 8-wide tile
  const int fg = lane >> 2;
  const int ft = lane & 3;
  const int row0 = q_lo + warp * 16 + fg;
  const int qp0 = q_offset + row0;        // positions of the two rows
  const int qp1 = qp0 + 8;

  float acc[kNc][4];
#pragma unroll
  for (int n = 0; n < kNc; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;

  if (n_tiles > 0) {
    attn::stage_rows<bf16, HDP, kBq, kMmaThreads, VEC>(
        q_s,
        attn::StridedRows<bf16>{q + bi * qs.b + q_lo * qs.s + head * qs.h,
                                qs.s},
        sq - q_lo, hd, tid);
    attn::cp_async_commit();
#pragma unroll
    for (int t = 0; t + 1 < kStages; ++t) {   // one group per tile
      if (t < n_tiles) stage_kv(t);
      attn::cp_async_commit();
    }
    attn::cp_async_wait<kStages - 1>();   // q has landed
    __syncthreads();
  }
  // Q's A fragments for every 16-channel step, kept for the whole walk
  uint32_t qf[kKc][4];
#pragma unroll
  for (int c = 0; c < kKc; ++c) {
    if (n_tiles > 0) {
      ldsm_x4(q_s + (warp * 16 + (lane & 15)) * kLd + c * 16 + (lane >> 4) * 8,
              qf[c]);
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + kStages - 1 < n_tiles) stage_kv(t + kStages - 1);
    attn::cp_async_commit();
    attn::cp_async_wait<kStages - 1>();   // tile t has landed
    __syncthreads();
    const int k0 = k_beg + t * kBk;
    const bf16* kt = k_s + (t % kStages) * kBk * kLd;
    const bf16* vt = v_s + (t % kStages) * kBk * kLd;

    // ---- S = Q K^T: 16 rows x 64 positions per warp
    float s[kNt][4];
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    }
#pragma unroll
    for (int c = 0; c < kKc; ++c) {
#pragma unroll
      for (int np = 0; np < kNt / 2; ++np) {
        uint32_t kf[4];   // B fragments of position tiles 2 np and 2 np + 1
        ldsm_x4(kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                    c * 16 + ((lane >> 3) & 1) * 8,
                kf);
        mma_bf16(s[2 * np], qf[c], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[c], kf[2], kf[3]);
      }
    }

    // ---- scale and, on an edge tile only, mask
    const bool edge =
        k0 + kBk > skv || (causal && k0 + kBk - 1 > q_offset + q_lo) ||
        (window > 0 && k0 <= q_offset + q_lo + kBq - 1 - window);
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge) {
          const int kpos = k0 + n * 8 + 2 * ft + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          bool ok = kpos < skv;
          if (causal) ok = ok && kpos <= qp;
          if (window > 0) ok = ok && kpos > qp - window;
          x = ok ? x : kNeg;
        }
        s[n][e] = x;
      }
    }

    // ---- online softmax on the fragments: each row lives in one quad
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c0 = expf(m0 - mx0);
    const float c1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;                             // each lane's share of the row sum
    l1 *= c1;
    // P, in place of the scores
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      s[n][0] = expf(s[n][0] - m0);
      s[n][1] = expf(s[n][1] - m0);
      s[n][2] = expf(s[n][2] - m1);
      s[n][3] = expf(s[n][3] - m1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }

    // ---- acc = acc c + P V: 16-position step j takes P's score tiles 2 j
    // (A fragment registers 0, 1) and 2 j + 1 (2, 3), as three bf16 parts;
    // V's B fragments by ldmatrix.trans. At hd <= 64 the tile's products
    // sum in an accumulator of their own (pv), which joins acc with one
    // rounding per element, not one truncation per product; hd 128 has no
    // registers left for it and scales acc first
    constexpr bool kTileAcc = HDP <= 64;
    float ta[kNc][4];
    float (&pv)[kNc][4] = kTileAcc ? ta : acc;
#pragma unroll
    for (int n = 0; n < kNc; ++n) {
      pv[n][0] = kTileAcc ? 0.0f : pv[n][0] * c0;
      pv[n][1] = kTileAcc ? 0.0f : pv[n][1] * c0;
      pv[n][2] = kTileAcc ? 0.0f : pv[n][2] * c1;
      pv[n][3] = kTileAcc ? 0.0f : pv[n][3] * c1;
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
        uint32_t vf[4];   // B fragments of channel tiles 2 cp and 2 cp + 1
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
      for (int n = 0; n < kNc; ++n) {
        acc[n][0] = fmaf(acc[n][0], c0, ta[n][0]);
        acc[n][1] = fmaf(acc[n][1], c0, ta[n][1]);
        acc[n][2] = fmaf(acc[n][2], c1, ta[n][2]);
        acc[n][3] = fmaf(acc[n][3], c1, ta[n][3]);
      }
    }
    __syncthreads();                      // stage t % kStages is free again
  }
  attn::cp_async_wait<0>();

  // ---- out = acc / l for the tile's real rows
  const float d0 = fmaxf(quad_sum(l0), 1e-30f);
  const float d1 = fmaxf(quad_sum(l1), 1e-30f);
  const int64_t row_stride = static_cast<int64_t>(h) * hd;
  bf16* ob = out + (bi * sq) * row_stride + static_cast<int64_t>(head) * hd;
#pragma unroll
  for (int n = 0; n < kNc; ++n) {
    const int ch = n * 8 + 2 * ft;
    if (row0 < sq) {
      store_pair<VEC>(ob + row0 * row_stride, ch, hd, acc[n][0] / d0,
                      acc[n][1] / d0);
    }
    if (row0 + 8 < sq) {
      store_pair<VEC>(ob + (row0 + 8) * row_stride, ch, hd, acc[n][2] / d1,
                      acc[n][3] / d1);
    }
  }
}

template <int HDP, bool VEC>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, Strides qs, Strides ks, Strides vs, int b,
                       int sq, int skv, int h, int kvh, int hd, int causal,
                       int window, int q_offset, float scale,
                       cudaStream_t stream) {
  const int64_t blocks = int64_t{(sq + kBq - 1) / kBq} * h * b;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const size_t smem = mma_smem_bytes<HDP>();
  auto kernel = flash_mma_kernel<HDP, VEC>;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), qs, ks, vs, b, sq,
      skv, h, kvh, hd, causal, window, q_offset, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores: the first port's design, kept for float32 inputs.
// One block (eight warps) per (query tile, KV head, batch row); the tile is
// 96 // g query positions, so its R = (96 // g) * g query rows share every
// staged K/V tile; kv tiles of 32 positions, one per lane; row r of the
// tile belongs to warp r % 8 for the whole walk (scores with K staged
// transposed, softmax by warp shuffles, probabilities through the warp's
// own shared rows, accumulator lane = channels lane + 32 c); q staged once
// in fp32, zero padded to a multiple of 4 channels.
// ---------------------------------------------------------------------------

namespace simt {

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

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, Strides qs,
                  Strides ks, Strides vs, int sq, int skv, int h, int kvh,
                  int hd, int causal, int window, int q_offset, float scale) {
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

template <int C>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   Strides qs, Strides ks, Strides vs, int b, int sq,
                   int skv, int h, int kvh, int hd, int causal, int window,
                   int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  auto kernel = flash_simt_kernel<float, C>;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int bq = kRows / (h / kvh);
  const dim3 grid((sq + bq - 1) / bq, kvh, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), qs, ks, vs, sq,
      skv, h, kvh, hd, causal, window, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace simt

}  // namespace

// q (b, sq, h, hd), k and v (b, skv, kvh, hd), each with the channel stride
// 1 and the given batch, sequence and head strides (elements); out (b, sq,
// h, hd) contiguous. bf16 picks bf16 (1: tensor cores) or float32 (0: CUDA
// cores) for all four. vec (bf16 only): 1 when hd % 8 == 0 and every
// pointer and stride of q, k and v is in whole 16-byte units, for the
// cp.async build; 0 takes element loads. q_offset (>= 0): query row i sits
// at position q_offset + i. Requires h % kvh == 0, h / kvh <= 96 and hd <=
// 128.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int b, int sq, int skv, int h,
                               int kvh, int hd, int64_t q_sb, int64_t q_ss,
                               int64_t q_sh, int64_t k_sb, int64_t k_ss,
                               int64_t k_sh, int64_t v_sb, int64_t v_ss,
                               int64_t v_sh, int causal, int window,
                               int q_offset, float scale, int bf16, int vec,
                               void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    if (hd <= 64) {
      err = vec ? launch_mma<64, true>(q, k, v, out, qs, ks, vs, b, sq, skv,
                                       h, kvh, hd, causal, window, q_offset,
                                       scale, s)
                : launch_mma<64, false>(q, k, v, out, qs, ks, vs, b, sq, skv,
                                        h, kvh, hd, causal, window, q_offset,
                                        scale, s);
    } else {
      err = vec ? launch_mma<128, true>(q, k, v, out, qs, ks, vs, b, sq, skv,
                                        h, kvh, hd, causal, window, q_offset,
                                        scale, s)
                : launch_mma<128, false>(q, k, v, out, qs, ks, vs, b, sq,
                                         skv, h, kvh, hd, causal, window,
                                         q_offset, scale, s);
    }
  } else {
    err = hd <= 64 ? simt::launch<2>(q, k, v, out, qs, ks, vs, b, sq, skv, h,
                                     kvh, hd, causal, window, q_offset, scale,
                                     s)
                   : simt::launch<4>(q, k, v, out, qs, ks, vs, b, sq, skv, h,
                                     kvh, hd, causal, window, q_offset, scale,
                                     s);
  }
  return static_cast<int>(err);
}
