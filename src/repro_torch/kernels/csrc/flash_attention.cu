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
// Bound on an H100: 4 hd flops per visible (query head, kv) pair against
// each q, k, v and out element moved once. At a 512-token prompt and hd 64
// that is a few hundred flops per byte, near the card's bf16 ridge (~295),
// so the tensor cores' 989 TFLOP/s and the 3.35 TB/s bound it about
// equally; long prompts, windows of thousands and hd 256 are bound by the
// products.
//
// bf16 with rows in whole 16-byte units (flash_wgmma_kernel), after
// FlashAttention-3's forward:
// - a work item is (tile of query positions, query head, batch row); the
//   item index runs over heads, then rows, then query tiles from the last
//   to the first, so the g query heads of one KV head are neighbours (their
//   re-reads of its K/V come from L2) and causally the heaviest tiles start
//   first. Blocks are persistent, one an SM, each walking items blockIdx.x,
//   + gridDim.x, ...;
// - a block is NWG consumer warpgroups of 64 query rows and a producer
//   warpgroup: 128-row tiles (NWG 2) where they give every SM an item, else
//   64-row tiles (NWG 1, twice the items), and always at hd 256
//   (flash_attention.tile_rows picks);
// - one thread of the producer loads each item's Q tile (two buffers where
//   shared memory allows, so the next item's Q lands during this one), then
//   the K and V tiles of its walk, by TMA: 4-d tensor maps over (hd, s,
//   heads, b), built on the host per call from the wrapper's strides, read
//   in boxes of 64 channels with 128-byte swizzle into a ring of 3-4 stages.
//   A stage's K and V land on one mbarrier; its K and its V are released on
//   two, as each is consumed;
// - S = Q K^T is wgmma m64nNk16 with Q and K from shared memory, fp32 in
//   registers; the online softmax runs on the accumulator fragments, whose
//   rows each live in one quad (max and sum by shuffles, exponentials as
//   ex2 of scores taken in log2 units). Only tiles that cross the
//   diagonal, a window edge or the end of k apply the mask (q_offset moves
//   the first two);
// - P V is wgmma with P in registers: S's fragments already have the A
//   operand's layout, so P is split in place into bf16 parts (kParts: hi =
//   bf16(p), lo = bf16(p - hi), about 16 bits together), and V is read
//   from shared memory as an MN-major B operand through the descriptor's
//   transpose. At hd 64 a tile's P V sums in an accumulator of its own that
//   joins the running one with one rounding per element;
// - a warpgroup's turn t issues S of tile t and P V of tile t - 1, so that
//   the softmax of tile t runs while the tensor cores do the P V of tile t
//   - 1, and the two consumer warpgroups take turns to issue (named
//   barriers): one's softmax runs while the other's products are in
//   flight. The tiles a warpgroup sees are peeled into a first turn (S
//   alone), the turns of both and a last (P V alone), so that every wgmma
//   group is waited for where ptxas can see it;
// - hd 64, 80, 128 and 256 each have an instance. Products run over hd's
//   own 16-channel steps and output width (hd 80: five steps of Q K^T, P V
//   at N = 80); shared memory holds whole 64-channel column blocks, the
//   swizzle's width, so hd 80's second block is 48 channels of TMA's zero
//   fill (filled without a read). At hd 256 one warpgroup owns all 256
//   output columns, 128 registers a thread, and S is computed once;
// - the walk runs from the first position any row's window reaches to the
//   last the causal mask lets the item's last row see: tiles that every
//   row masks are never loaded, and a warpgroup skips (waits for and
//   releases) the tiles that every one of its own rows masks.
// Registers bound the design: ptxas gives a thread of a 384-thread block
// 168 registers and does not raise that budget after setmaxnreg (the same
// spills with and without it), so the kernel does without setmaxnreg, and
// two warpgroups a block take K/V stages of 64 positions (S and P of two
// tiles live at once); one warpgroup a block has 255 and takes 128.
// What holds it back (a clock64 probe of the hd 64 walk on an H100): a
// warpgroup's turn is mostly its own instruction stream, the softmax and
// P's split, then the issue of the turn's wgmmas; the tensor cores idle
// much of the time, and with two warpgroups an SM there are too few warps
// to hide that latency (PERF.md, section 7).
// Numerics: the plain version is fp32. One bf16 P (2^-9 of itself) kept
// every output within bf16's 2e-2 of it but took a 2-layer full-width
// model's logits outside the bf16 tolerance against the plain versions' at
// 29 of 56 method-seed pairs (chip_seeds.py, seeds 0-7); P in parts brings
// the kernel back near fp32 (PERF.md holds the measurement of two parts
// against three).
// Other bf16 rows (hd % 8 != 0, a stride or pointer off 16 bytes: no
// served model) take flash_mma_kernel: mma.sync.m16n8k16, element loads
// into padded shared rows, P in three parts. fp32 keeps the first port's
// body on the CUDA cores (flash_simt_kernel): the tensor cores take no
// fp32 short of TF32, which would miss fp32's 2e-5 tolerance. No served
// path runs fp32 attention.
//
// C interface (ctypes): every pointer and the stream are void*; returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue when a
// tensor map cannot be built.

#include <cuda.h>

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
// bf16 with element loads (mma.sync), for rows that are not in whole
// 16-byte units
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kBq = 64;                   // query positions per block
constexpr int kBk = 64;                   // kv positions per staged tile

// K/V tiles in flight: three at hd <= 64 (63 KB of shared memory, three
// blocks an SM, as many as their registers allow), two at hd 128 (87 KB)
// and at hd 256 (165 KB: one block an SM)
template <int HDP>
struct Stages {
  static constexpr int k = HDP <= 64 ? 3 : 2;
};

// Output columns per warp: all of them at hd <= 128 (four warps, 16 query
// rows each); at hd 256 a warp's 16 x 256 fp32 accumulator alone would be
// 128 registers a lane, and with S, P and Q's fragments it spilled, so
// eight warps split the columns: warp w owns rows 16 (w % 4) .. + 15 and
// columns 128 (w / 4) .. + 127, and the two warps of a row tile each
// compute its S and softmax (the same values), then P V on their halves.
// Q's A fragments stay in registers for the whole walk at hd <= 128; at hd
// 256 they are read from the staged Q tile at each 16-channel step
template <int HDP>
struct ColSplit {
  static constexpr int k = HDP > 128 ? 2 : 1;
};

template <int HDP>
struct MmaThreads {
  static constexpr int k = 128 * ColSplit<HDP>::k;
};

template <int HDP>
struct QInRegisters {
  static constexpr bool k = HDP <= 128;
};

template <int HDP>
size_t mma_smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(HDP + 8) *
         (kBq + 2 * Stages<HDP>::k * kBk);
}

template <int HDP>
__global__ void __launch_bounds__(MmaThreads<HDP>::k)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 Strides qs, Strides ks, Strides vs, int b, int sq, int skv,
                 int h, int kvh, int hd, int causal, int window, int q_offset,
                 float scale) {
  constexpr int kLd = attn::Tile<bf16, HDP>::kLd;
  constexpr int kKc = HDP / 16;           // 16-channel steps of Q K^T
  constexpr int kCols = HDP / ColSplit<HDP>::k;     // a warp's out columns
  constexpr int kNc = kCols / 8;          // 8-channel output tiles of P V
  constexpr int kNt = kBk / 8;            // 8-position score tiles
  constexpr int kStages = Stages<HDP>::k;
  constexpr int kMmaThreads = MmaThreads<HDP>::k;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // kBq rows
  bf16* k_s = q_s + kBq * kLd;                       // kStages x kBk rows
  bf16* v_s = k_s + kStages * kBk * kLd;             // kStages x kBk rows

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;        // the warp's 16-row tile
  const int col0 = (tid >> 7) * kCols;    // ... and its first out column
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
    attn::stage_rows<bf16, HDP, kBk, kMmaThreads, false>(
        k_s + st * kBk * kLd, attn::StridedRows<bf16>{kb + k0 * ks.s, ks.s},
        k_end - k0, hd, tid);
    attn::stage_rows<bf16, HDP, kBk, kMmaThreads, false>(
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
    attn::stage_rows<bf16, HDP, kBq, kMmaThreads, false>(
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
  // (QInRegisters), else read again at each step from q_s
  constexpr bool kQRegs = QInRegisters<HDP>::k;
  const bf16* q_frag = q_s + (warp * 16 + (lane & 15)) * kLd + (lane >> 4) * 8;
  uint32_t qf[kQRegs ? kKc : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int c = 0; c < kKc; ++c) {
      if (n_tiles > 0) ldsm_x4(q_frag + c * 16, qf[c]);
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
      uint32_t qc[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qc[e] = qf[c][e];
      } else {
        ldsm_x4(q_frag + c * 16, qc);
      }
#pragma unroll
      for (int np = 0; np < kNt / 2; ++np) {
        uint32_t kf[4];   // B fragments of position tiles 2 np and 2 np + 1
        ldsm_x4(kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                    c * 16 + ((lane >> 3) & 1) * 8,
                kf);
        mma_bf16(s[2 * np], qc, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qc, kf[2], kf[3]);
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
    // rounding per element, not one truncation per product; hd 128 and 256
    // have no registers left for it and scale acc first
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
                          col0 + cp * 16 + (lane >> 4) * 8,
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
    const int ch = col0 + n * 8 + 2 * ft;
    if (row0 < sq) {
      store_pair<false>(ob + row0 * row_stride, ch, hd, acc[n][0] / d0,
                      acc[n][1] / d0);
    }
    if (row0 + 8 < sq) {
      store_pair<false>(ob + (row0 + 8) * row_stride, ch, hd, acc[n][2] / d1,
                      acc[n][3] / d1);
    }
  }
}

template <int HDP>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, Strides qs, Strides ks, Strides vs, int b,
                       int sq, int skv, int h, int kvh, int hd, int causal,
                       int window, int q_offset, float scale,
                       cudaStream_t stream) {
  const int64_t blocks = int64_t{(sq + kBq - 1) / kBq} * h * b;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const size_t smem = mma_smem_bytes<HDP>();
  auto kernel = flash_mma_kernel<HDP>;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), MmaThreads<HDP>::k, smem,
           stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), qs, ks, vs, b, sq,
      skv, h, kvh, hd, causal, window, q_offset, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Hopper's building blocks: mbarriers, TMA tile loads, wgmma
// ---------------------------------------------------------------------------

namespace hop {

using attn::smem_addr;

// A wait that has not ended after about this many cycles (some seconds)
// traps: a lost arrival fails the launch instead of hanging the card.
constexpr long long kWaitCycles = 1LL << 34;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of TMA transfers in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// one box of a 4-d tensor map at coordinates (c0 innermost .. c3) into
// shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// 2^x, flushing results below 2^-126 to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers in place around wgmma's asynchronous reads and writes: the
// compiler may not move their other uses across this point.
template <int R>
__device__ __forceinline__ void pin(float (&x)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(x[i]) :: "memory");
}

template <int R>
__device__ __forceinline__ void pin(uint32_t (&x)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(x[i][e]) :: "memory");
  }
}

// End the basic block on a branch that depends on x: ptxas schedules
// within a block, so whatever x is computed from is issued before the
// instructions that follow (the branch is never taken: no arithmetic gives
// this NaN's bits).
__device__ __forceinline__ void issue_before_next(float x) {
  if (__float_as_uint(x) == 0xffffffffu) asm volatile("trap;");
}

// Shared-memory matrix descriptor of a tile of 128-byte rows written by TMA
// with 128-byte swizzle (its base 1024-byte aligned): 8-row groups 1024
// bytes apart (SBO); `lbo` is the distance between 64-element column
// blocks, which only an MN-major operand wider than 64 reads.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | uint64_t{1} << 62;
}

// wgmma.mma_async m64nNk16, bf16 inputs, fp32 accumulators d (N / 2 a
// thread); `acc` 0 overwrites d. ss: A (64 x 16) and B (N x 16) both
// K-major in shared memory (ss0: d overwritten, never read). rs: A from
// registers (the m16n8k16 A fragment of each warp's 16 rows), B (16 x N)
// MN-major in shared memory.
#define WG_R0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_R1 "%8, %9, %10, %11, %12, %13, %14, %15"
#define WG_R2 "%16, %17, %18, %19, %20, %21, %22, %23"
#define WG_R3 "%24, %25, %26, %27, %28, %29, %30, %31"
#define WG_R4 "%32, %33, %34, %35, %36, %37, %38, %39"
#define WG_R5 "%40, %41, %42, %43, %44, %45, %46, %47"
#define WG_R6 "%48, %49, %50, %51, %52, %53, %54, %55"
#define WG_R7 "%56, %57, %58, %59, %60, %61, %62, %63"
#define WG_R8 "%64, %65, %66, %67, %68, %69, %70, %71"
#define WG_R9 "%72, %73, %74, %75, %76, %77, %78, %79"
#define WG_R10 "%80, %81, %82, %83, %84, %85, %86, %87"
#define WG_R11 "%88, %89, %90, %91, %92, %93, %94, %95"
#define WG_R12 "%96, %97, %98, %99, %100, %101, %102, %103"
#define WG_R13 "%104, %105, %106, %107, %108, %109, %110, %111"
#define WG_R14 "%112, %113, %114, %115, %116, %117, %118, %119"
#define WG_R15 "%120, %121, %122, %123, %124, %125, %126, %127"
#define WG_ACC32 "{" WG_R0 ", " WG_R1 ", " WG_R2 ", " WG_R3 "}"
#define WG_ACC40 "{" WG_R0 ", " WG_R1 ", " WG_R2 ", " WG_R3 ", " WG_R4 "}"
#define WG_ACC64                                                            \
  "{" WG_R0 ", " WG_R1 ", " WG_R2 ", " WG_R3 ", " WG_R4 ", " WG_R5 ", " \
  WG_R6 ", " WG_R7 "}"
#define WG_ACC128                                                           \
  "{" WG_R0 ", " WG_R1 ", " WG_R2 ", " WG_R3 ", " WG_R4 ", " WG_R5 ", " \
  WG_R6 ", " WG_R7 ", " WG_R8 ", " WG_R9 ", " WG_R10 ", " WG_R11 ", "   \
  WG_R12 ", " WG_R13 ", " WG_R14 ", " WG_R15 "}"
#define WG_F4(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define WG_F8(c, i) WG_F4(c, i), WG_F4(c, i + 4)
#define WG_F32(c, i) \
  WG_F8(c, i), WG_F8(c, i + 8), WG_F8(c, i + 16), WG_F8(c, i + 24)
#define WG_SS(N, ACC, A, B, SC, ...)                                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SC ", 0;\n"             \
               "wgmma.mma_async.sync.aligned.m64n" #N                      \
               "k16.f32.bf16.bf16 " ACC ", " A ", " B ", p, 1, 1, 0, 0;\n}\n" \
               : __VA_ARGS__                                               \
               : "l"(a), "l"(b), "r"(acc))
#define WG_RS(N, ACC, A, B, SC, ...)                                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SC ", 0;\n"             \
               "wgmma.mma_async.sync.aligned.m64n" #N                      \
               "k16.f32.bf16.bf16 " ACC ", " A ", " B ", p, 1, 1, 1;\n}\n" \
               : __VA_ARGS__                                               \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),       \
                 "r"(acc))

template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int acc) {
    WG_SS(64, WG_ACC32, "%32", "%33", "%34", WG_F32("+f", 0));
  }
  static __device__ __forceinline__ void ss0(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    const int acc = 0;
    WG_SS(64, WG_ACC32, "%32", "%33", "%34", WG_F32("=f", 0));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    WG_RS(64, WG_ACC32, "{%32, %33, %34, %35}", "%36", "%37",
          WG_F32("+f", 0));
  }
};

template <>
struct Wgmma<80> {
  static __device__ __forceinline__ void rs(float (&d)[40],
                                            const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    WG_RS(80, WG_ACC40, "{%40, %41, %42, %43}", "%44", "%45",
          WG_F32("+f", 0), WG_F8("+f", 32));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int acc) {
    WG_SS(128, WG_ACC64, "%64", "%65", "%66", WG_F32("+f", 0),
          WG_F32("+f", 32));
  }
  static __device__ __forceinline__ void ss0(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    const int acc = 0;
    WG_SS(128, WG_ACC64, "%64", "%65", "%66", WG_F32("=f", 0),
          WG_F32("=f", 32));
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    WG_RS(128, WG_ACC64, "{%64, %65, %66, %67}", "%68", "%69",
          WG_F32("+f", 0), WG_F32("+f", 32));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    WG_RS(256, WG_ACC128, "{%128, %129, %130, %131}", "%132", "%133",
          WG_F32("+f", 0), WG_F32("+f", 32), WG_F32("+f", 64),
          WG_F32("+f", 96));
  }
};

}  // namespace hop

// ---------------------------------------------------------------------------
// bf16 on wgmma, K/V staged by TMA: rows in whole 16-byte units
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;        // query rows of one consumer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// The tile of an instance: kv positions a stage, 64-channel column blocks
// in shared memory, 16-channel steps of Q K^T (hd 80: five), and whether a
// tile's P V sums in an accumulator of its own before it joins the running
// one (hd 64). ptxas gives a thread of a 384-thread block 168 registers
// (setmaxnreg does not raise that budget: measured, the same spills with
// and without it), so with two consumer warpgroups a stage holds 64
// positions (S and P 32 registers each, both live while the last tile's
// P V runs), with one (255 registers) 128, and 64 at hd 256, where the 64 x
// 256 output accumulator takes 128 registers and one warpgroup is all a
// block holds.
// Shared memory holds two Q tiles where it can with three K/V stages (the
// next item's Q loads while this one runs; not at hd 256) and a ring of
// kStages K and V tiles, as many as fit up to 4, so that TMA's latency
// stays behind the walk.
template <int HD, int NWG>
struct WgTile {
  static constexpr int kBk = NWG == 2 || HD > 128 ? 64 : 128;
  static constexpr int kCb = (HD + 63) / 64;
  static constexpr int kKs = HD / 16;
  static constexpr bool kTileAcc = HD <= 64;
  static constexpr int kRoom = 226 * 1024;
  static constexpr int kQBytes = 128 * kCb * kWgRows * NWG;
  static constexpr int kStageBytes = 2 * 128 * kCb * kBk;     // K and V
  static constexpr int kQBufs =
      2 * kQBytes + 3 * kStageBytes <= kRoom ? 2 : 1;
  static constexpr int kFit = (kRoom - kQBufs * kQBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "a ring of two stages at least");
};

// P enters P V as this many bf16 parts: hi = bf16(p), lo = bf16(p - hi)
// (3: split3_bf16's hi, mid, lo, about 24 bits; chip_seeds.py finds two
// enough, PERF.md)
constexpr int kParts = 2;
static_assert(kParts == 2 || kParts == 3, "two or three parts of P");

template <int HD, int NWG>
constexpr size_t wgmma_smem_bytes() {
  // 1024 bytes of slack to align the tiles for the 128-byte swizzle
  using Tl = WgTile<HD, NWG>;
  return 1024 + size_t{Tl::kQBytes} * Tl::kQBufs +
         size_t{Tl::kStageBytes} * Tl::kStages;
}

// P's fragments for P V: 16-position step j of the tile is A's registers
// {S chunk 2 j rows g / g + 8, S chunk 2 j + 1 rows g / g + 8}, each a bf16
// pair, split into kParts parts (hi first)
template <int NJ>
__device__ __forceinline__ void split_p(const float* s,
                                        uint32_t (&p)[kParts][NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = s[8 * j + 2 * r];
      const float y = s[8 * j + 2 * r + 1];
      if constexpr (kParts == 3) {
        attn::split3_bf16(x, y, p[0][j][r], p[1][j][r], p[2][j][r]);
      } else {
        const uint32_t hi = attn::pack_bf16(x, y);
        p[0][j][r] = hi;
        p[1][j][r] = attn::pack_bf16(x - __uint_as_float(hi << 16),
                                     y - __uint_as_float(hi & 0xffff0000u));
      }
    }
  }
}

// Issue d (+)= P V over one tile, not waiting: 16-position step j takes P's
// registers p[.][j] (every part) and V's rows 16 j .. 16 j + 15 (`v_addr`:
// the tile's first column block, `block` bytes to the next); `overwrite`
// starts d from 0
template <int HD, int NJ>
__device__ __forceinline__ void issue_pv(float (&d)[HD / 2],
                                         const uint32_t (&p)[kParts][NJ][4],
                                         uint32_t v_addr, uint32_t block,
                                         bool overwrite) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      hop::Wgmma<HD>::rs(d, p[part][j],
                         hop::desc_sw128(v_addr + j * 16 * 128, block),
                         !overwrite || j > 0 || part > 0);
    }
  }
  hop::wg_commit();
}

// The two consumer warpgroups take turns to issue their products (named
// barriers 1 and 2, 256 threads: one warpgroup waits, the other arrives),
// so that one's softmax runs while the other's products are in flight
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - wg) : "memory");
}

// One work item of the persistent walk: (query tile, head, batch row) from
// its index, and the kv range some row of its tile can see
struct WgItem {
  int head, bi, q_lo, kh, k_beg, n_tiles;
};

template <int ROWS, int BK>
__device__ __forceinline__ WgItem wg_item(int id, int b, int sq, int skv,
                                          int h, int kvh, int causal,
                                          int window, int q_offset) {
  WgItem w;
  const int n_qt = (sq + ROWS - 1) / ROWS;
  w.head = id % h;
  w.bi = (id / h) % b;
  w.q_lo = (n_qt - 1 - id / (h * b)) * ROWS;
  w.kh = w.head / (h / kvh);
  const int q_hi = min(w.q_lo + ROWS, sq) - 1;
  const int k_end = causal ? min(skv, q_offset + q_hi + 1) : skv;
  w.k_beg = window > 0 ? max(0, q_offset + w.q_lo - window + 1) : 0;
  w.n_tiles = k_end > w.k_beg ? (k_end - w.k_beg + BK - 1) / BK : 0;
  return w;
}

template <int HD, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   bf16* __restrict__ out, int b, int sq, int skv, int h,
                   int kvh, int hd, int causal, int window, int q_offset,
                   float scale) {
  using Tl = WgTile<HD, NWG>;
  constexpr int kWgStages = Tl::kStages;
  constexpr int kBkW = Tl::kBk;
  constexpr int kCb = Tl::kCb;
  constexpr int kQRows = kWgRows * NWG;
  constexpr uint32_t kQBlock = kQRows * 128;   // bytes: one column block
  constexpr uint32_t kKvBlock = kBkW * 128;
  constexpr uint32_t kTile = kCb * kKvBlock;   // one K or V tile
  constexpr int kNs = kBkW / 8;                // 8-position chunks of S
  constexpr int kNj = kBkW / 16;               // 16-position steps of P V
  extern __shared__ unsigned char smem_raw[];
  constexpr int kQBufs = Tl::kQBufs;
  __shared__ __align__(8) uint64_t bars[4 + 3 * kWgStages];
  uint64_t* q_full = bars;                     // one a Q buffer
  uint64_t* q_empty = bars + 2;
  uint64_t* kv_full = bars + 4;                // K and V of a stage landed
  uint64_t* k_empty = kv_full + kWgStages;     // K of a stage consumed
  uint64_t* v_empty = k_empty + kWgStages;     // V of a stage consumed
  unsigned char* q_s =
      smem_raw + ((1024 - (attn::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = q_s + kQBufs * kCb * kQBlock;
  unsigned char* v_s = k_s + kWgStages * kTile;
  const int items = (sq + kQRows - 1) / kQRows * h * b;
  auto item = [&](int id) {
    return wg_item<kQRows, kBkW>(id, b, sq, skv, h, kvh, causal, window,
                                 q_offset);
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kQBufs; ++i) {
      hop::mbar_init(&q_full[i], 1);
      hop::mbar_init(&q_empty[i], 4 * NWG);   // one arrival a consumer warp
    }
#pragma unroll
    for (int s = 0; s < kWgStages; ++s) {
      hop::mbar_init(&kv_full[s], 1);
      hop::mbar_init(&k_empty[s], 4 * NWG);
      hop::mbar_init(&v_empty[s], 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroup-uniform in the compiler's eyes too
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128,
                             0);
  if (wg == NWG) {
    // ================= producer: one thread issues every TMA load, items
    // in the consumers' order, running ahead of them by the ring's depth
    if (threadIdx.x % 128 == 0) {
      int it = 0, ic = 0;      // kv tiles and items (with tiles) so far
      for (int id = blockIdx.x; id < items; id += gridDim.x) {
        const WgItem w = item(id);
        if (w.n_tiles == 0) continue;
        const int qb = ic % kQBufs;
        if (ic >= kQBufs) {
          hop::mbar_wait(&q_empty[qb], ((ic / kQBufs) + 1) & 1);
        }
        hop::mbar_expect_tx(&q_full[qb], kCb * kQBlock);
#pragma unroll
        for (int c = 0; c < kCb; ++c) {
          hop::tma_load_4d(q_s + (qb * kCb + c) * kQBlock, &tm_q, &q_full[qb],
                           64 * c, w.q_lo, w.head, w.bi);
        }
        ++ic;
        for (int t = 0; t < w.n_tiles; ++t, ++it) {
          const int st = it % kWgStages;
          const uint32_t ph = ((it / kWgStages) + 1) & 1;   // the last round
          const int k0 = w.k_beg + t * kBkW;
          if (it >= kWgStages) {
            hop::mbar_wait(&k_empty[st], ph);
            hop::mbar_wait(&v_empty[st], ph);
          }
          hop::mbar_expect_tx(&kv_full[st], 2 * kTile);
#pragma unroll
          for (int c = 0; c < kCb; ++c) {
            hop::tma_load_4d(k_s + st * kTile + c * kKvBlock, &tm_k,
                             &kv_full[st], 64 * c, k0, w.kh, w.bi);
            hop::tma_load_4d(v_s + st * kTile + c * kKvBlock, &tm_v,
                             &kv_full[st], 64 * c, k0, w.kh, w.bi);
          }
        }
      }
    }
  } else {
    // ================= consumer warpgroup wg: rows q_lo + 64 wg .. + 63 of
    // each item
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int fg = lane >> 2;              // rows fg and fg + 8 of the warp's
    const int ft = lane & 3;               // 16; columns 2 ft, 2 ft + 1 of 8
    const float sl = scale * kLog2e;       // scores in log2 units
    const uint32_t q_base = attn::smem_addr(q_s) + wg * kWgRows * 128;
    uint32_t q_addr = q_base;              // this item's Q buffer
    if (NWG == 2 && wg == 1) turn_pass(wg);   // warpgroup 0 goes first
    int it = 0, ic = 0;        // kv tiles and items (with tiles) so far

    // the ring's stage of the item's tile t, and the parity of its round
    auto stage = [&](int t) { return (it + t) % kWgStages; };
    auto parity = [&](int t) -> uint32_t {
      return ((it + t) / kWgStages) & 1;
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(bar);
    };
    auto turn_begin = [&] {
      if constexpr (NWG == 2) turn_wait(wg);
    };
    auto turn_end = [&] {
      if constexpr (NWG == 2) turn_pass(wg);
    };

    float acc[HD / 2];
    float ta[Tl::kTileAcc ? HD / 2 : 1];   // a tile's P V (hd 64)
    float s[kBkW / 2];                     // scores, then P, of one tile
    uint32_t p[kParts][kNj][4];            // P of the tile whose P V is next
    auto pin_pv = [&] {
      hop::pin(acc);
      if constexpr (Tl::kTileAcc) hop::pin(ta);
#pragma unroll
      for (int part = 0; part < kParts; ++part) hop::pin(p[part]);
    };
    // S = Q K^T of tile t: hd / 16 steps, both operands K-major
    auto issue_s = [&](int t) {
      const uint32_t k_addr = attn::smem_addr(k_s + stage(t) * kTile);
#pragma unroll
      for (int kc = 0; kc < Tl::kKs; ++kc) {
        const uint32_t off = (kc % 4) * 32;   // inside the swizzle atom
        const uint64_t a =
            hop::desc_sw128(q_addr + (kc / 4) * kQBlock + off, 16);
        const uint64_t b =
            hop::desc_sw128(k_addr + (kc / 4) * kKvBlock + off, 16);
        if (kc == 0) {
          hop::Wgmma<kBkW>::ss0(s, a, b);
        } else {
          hop::Wgmma<kBkW>::ss(s, a, b, 1);
        }
      }
      hop::wg_commit();
    };
    // acc (+)= P V of tile t; at hd 64 into ta, which joins acc later
    auto issue_pv_of = [&](int t) {
      const uint32_t v_addr = attn::smem_addr(v_s + stage(t) * kTile);
      if constexpr (Tl::kTileAcc) {
        issue_pv<HD>(ta, p, v_addr, kKvBlock, true);
      } else {
        issue_pv<HD>(acc, p, v_addr, kKvBlock, false);
      }
    };

    for (int id = blockIdx.x; id < items; id += gridDim.x) {
      const WgItem w = item(id);
      const int n = w.n_tiles;
      const int wq_lo = w.q_lo + kWgRows * wg;
      const int row0 = wq_lo + warp * 16 + fg;
      const int qp0 = q_offset + row0;
      const int qp1 = qp0 + 8;
      // the tiles some row of this warpgroup sees, [t_on, t_off]; the
      // block's other tiles are waited for and released only
      const int w_hi = min(wq_lo + kWgRows, sq) - 1;
      const int w_end = causal ? min(skv, q_offset + w_hi + 1) : skv;
      const int w_beg =
          window > 0 ? max(0, q_offset + wq_lo - window + 1) : 0;
      int t_on = n, t_off = n - 1;
      if (wq_lo < sq && w_end > w_beg && n > 0) {
        t_on = max(0, (w_beg - w.k_beg) / kBkW);
        t_off = min(n - 1, (w_end - 1 - w.k_beg) / kBkW);
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
      float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;
      float c0 = 1.0f, c1 = 1.0f;          // acc's scale before the next P V

      // the kv positions each of the lane's two rows sees: [vlo, vhi)
      const int vhi0 = causal ? min(skv, qp0 + 1) : skv;
      const int vhi1 = causal ? min(skv, qp1 + 1) : skv;
      const int vlo0 = window > 0 ? qp0 - window + 1 : -(1 << 30);
      const int vlo1 = window > 0 ? qp1 - window + 1 : -(1 << 30);
      // scale, mask (an edge tile only) and the online softmax of tile t on
      // S's fragments (a row lives in one quad); P in place of the scores,
      // (c0, c1) the factor the running sums take
      auto softmax = [&](int t, float& c0n, float& c1n) {
        const int k0 = w.k_beg + t * kBkW;
        const bool edge = k0 + kBkW > skv ||
                          (causal && k0 + kBkW - 1 > q_offset + wq_lo) ||
                          (window > 0 && k0 <= q_offset + w_hi - window);
        if (edge) {
          // element (i, e) sits at kv position k0 + 2 ft + 8 i + (e & 1)
          const int base = k0 + 2 * ft;
          const int hi0 = vhi0 - base, hi1 = vhi1 - base;
          const int lo0 = vlo0 - base, lo1 = vlo1 - base;
#pragma unroll
          for (int i = 0; i < kNs; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = 8 * i + (e & 1);
              const bool ok = e < 2 ? (c < hi0) & (c >= lo0)
                                    : (c < hi1) & (c >= lo1);
              s[4 * i + e] = ok ? s[4 * i + e] * sl : kNeg;
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < kBkW / 2; ++i) s[i] *= sl;
        }
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int i = 0; i < kNs; ++i) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
        }
        mx0 = quad_max(mx0);
        mx1 = quad_max(mx1);
        c0n = hop::ex2(m0 - mx0);
        c1n = hop::ex2(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        l0 *= c0n;                         // each lane's share of the row sum
        l1 *= c1n;
#pragma unroll
        for (int i = 0; i < kNs; ++i) {
          s[4 * i] = hop::ex2(s[4 * i] - m0);
          s[4 * i + 1] = hop::ex2(s[4 * i + 1] - m0);
          s[4 * i + 2] = hop::ex2(s[4 * i + 2] - m1);
          s[4 * i + 3] = hop::ex2(s[4 * i + 3] - m1);
          l0 += s[4 * i] + s[4 * i + 1];
          l1 += s[4 * i + 2] + s[4 * i + 3];
        }
      };
      // acc's update around one tile's P V: scaled first, or at hd 64 the
      // tile's own sum joined with one rounding per element
      auto scale_acc = [&] {
        if constexpr (!Tl::kTileAcc) {
#pragma unroll
          for (int i = 0; i < HD / 8; ++i) {
            acc[4 * i] *= c0;
            acc[4 * i + 1] *= c0;
            acc[4 * i + 2] *= c1;
            acc[4 * i + 3] *= c1;
          }
        }
      };
      auto join_acc = [&] {
        if constexpr (Tl::kTileAcc) {
#pragma unroll
          for (int i = 0; i < HD / 8; ++i) {
            acc[4 * i] = fmaf(acc[4 * i], c0, ta[4 * i]);
            acc[4 * i + 1] = fmaf(acc[4 * i + 1], c0, ta[4 * i + 1]);
            acc[4 * i + 2] = fmaf(acc[4 * i + 2], c1, ta[4 * i + 2]);
            acc[4 * i + 3] = fmaf(acc[4 * i + 3], c1, ta[4 * i + 3]);
          }
        }
      };
      // a tile this warpgroup does not see: one turn, nothing issued
      auto skip = [&](int t) {
        hop::mbar_wait(&kv_full[stage(t)], parity(t));
        turn_begin();
        turn_end();
        release(&k_empty[stage(t)]);
        release(&v_empty[stage(t)]);
      };

      uint64_t* q_free = &q_empty[ic % kQBufs];
      if (n > 0) {
        hop::mbar_wait(&q_full[ic % kQBufs], (ic / kQBufs) & 1);
        q_addr = q_base + (ic % kQBufs) * kCb * kQBlock;
        if (t_on > t_off) release(q_free);           // Q is not needed
      }
      // n + 1 turns an item for every warpgroup: turn t issues S of tile t
      // and P V of tile t - 1, so that the softmax of tile t overlaps the
      // P V of tile t - 1
      for (int t = 0; t < t_on; ++t) skip(t);
      if (t_on <= t_off) {
        // ---- turn t_on: S of the first tile alone
        hop::mbar_wait(&kv_full[stage(t_on)], parity(t_on));
        turn_begin();
        hop::wg_fence();
        issue_s(t_on);
        turn_end();
        hop::wg_wait_all();
        hop::pin(s);
        release(&k_empty[stage(t_on)]);
        if (t_on == t_off) release(q_free);
        softmax(t_on, c0, c1);
        split_p<kNj>(s, p);
        // ---- turns t_on + 1 .. t_off: S of tile t, P V of tile t - 1
        for (int t = t_on + 1; t <= t_off; ++t) {
          hop::mbar_wait(&kv_full[stage(t)], parity(t));   // V t - 1: before
          scale_acc();
          turn_begin();
          pin_pv();
          hop::wg_fence();
          issue_s(t);
          issue_pv_of(t - 1);
          turn_end();
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          hop::pin(s);                      // S of tile t is in
          release(&k_empty[stage(t)]);
          if (t == t_off) release(q_free);
          float c0n, c1n;
          softmax(t, c0n, c1n);
          // at hd 256 the softmax is issued before the wait, or ptxas sinks
          // it past the wait and the long P V no longer hides it (measured
          // faster at recurrentgemma's rows; slower at hd <= 128, where P V
          // is short)
          if constexpr (HD > 128) hop::issue_before_next(l0 + l1);
          hop::wg_wait_all();
          pin_pv();                         // P V of tile t - 1 is in
          join_acc();
          release(&v_empty[stage(t - 1)]);
          split_p<kNj>(s, p);
          c0 = c0n;
          c1 = c1n;
        }
        // ---- turn t_off + 1: P V of the last tile alone
        scale_acc();
        turn_begin();
        pin_pv();
        hop::wg_fence();
        issue_pv_of(t_off);
        turn_end();
        hop::wg_wait_all();
        pin_pv();
        join_acc();
        release(&v_empty[stage(t_off)]);
      } else {
        turn_begin();                      // the (n + 1)-th turn
        turn_end();
      }
      for (int t = t_off + 1; t < n; ++t) skip(t);
      if (n > 0) {
        it += n;
        ++ic;
      }

      // ---- out = acc / l for the warpgroup's real rows
      const float d0 = fmaxf(quad_sum(l0), 1e-30f);
      const float d1 = fmaxf(quad_sum(l1), 1e-30f);
      const int64_t row_stride = static_cast<int64_t>(h) * hd;
      bf16* ob = out + (int64_t{w.bi} * sq) * row_stride +
                 static_cast<int64_t>(w.head) * hd;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const int ch = i * 8 + 2 * ft;
        if (row0 < sq) {
          store_pair<true>(ob + row0 * row_stride, ch, hd, acc[4 * i] / d0,
                           acc[4 * i + 1] / d0);
        }
        if (row0 + 8 < sq) {
          store_pair<true>(ob + (row0 + 8) * row_stride, ch, hd,
                           acc[4 * i + 2] / d1, acc[4 * i + 3] / d1);
        }
      }
    }
    if (NWG == 2 && wg == 0) turn_wait(wg);   // warpgroup 1's last pass
  }
}

// ---- tensor maps, built on the host per call

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// (b, s, heads, hd) bf16 with element strides `st` (channel stride 1) as a
// 4-d map over (hd, s, heads, b), read in boxes of 64 channels x `rows`
// positions of one head, 128-byte swizzle; what lies past hd or s reads as
// zeros. A dimension of size 1 is never stepped: its stride is set to a
// valid one. Every stride in whole 16-byte units, as the wrapper's vec
// build guarantees.
bool encode_rows(CUtensorMap* map, const void* base, int b, int s, int heads,
                 int hd, Strides st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dim[4] = {static_cast<cuuint64_t>(hd),
                             static_cast<cuuint64_t>(s > 1 ? s : 1),
                             static_cast<cuuint64_t>(heads),
                             static_cast<cuuint64_t>(b)};
  const int64_t elems[3] = {st.s, st.h, st.b};
  cuuint64_t stride[3];
  for (int i = 0; i < 3; ++i) {
    const int64_t bytes = elems[i] * static_cast<int64_t>(sizeof(bf16));
    stride[i] = dim[i + 1] == 1 && (bytes <= 0 || bytes % 16 != 0)
                    ? 16
                    : static_cast<cuuint64_t>(bytes);
  }
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dim, stride, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

template <int HD, int NWG>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, Strides qs, Strides ks, Strides vs, int b,
                         int sq, int skv, int h, int kvh, int hd, int causal,
                         int window, int q_offset, float scale,
                         cudaStream_t stream) {
  constexpr int kQRows = kWgRows * NWG;
  const int64_t items = int64_t{(sq + kQRows - 1) / kQRows} * h * b;
  if (items > 0x7fffffff) return cudaErrorInvalidConfiguration;
  static int sms_of[kMaxDevices];       // SMs of each device, read once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int sms = sms_of[dev];
  CUtensorMap tq, tk, tv;
  if (!encode_rows(&tq, q, b, sq, h, hd, qs, kQRows) ||
      !encode_rows(&tk, k, b, skv, kvh, hd, ks, WgTile<HD, NWG>::kBk) ||
      !encode_rows(&tv, v, b, skv, kvh, hd, vs, WgTile<HD, NWG>::kBk)) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t smem = wgmma_smem_bytes<HD, NWG>();
  auto kernel = flash_wgmma_kernel<HD, NWG>;
  static bool smem_allowed[kMaxDevices];  // the opt-in, once a device
  if (!smem_allowed[dev]) {
    err = attn::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    smem_allowed[dev] = true;
  }
  // persistent: one block an SM walks items blockIdx.x, + gridDim.x, ...
  const unsigned grid = static_cast<unsigned>(items < sms ? items : sms);
  kernel<<<grid, 128 * (NWG + 1), smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), b, sq, skv, h, kvh, hd, causal,
      window, q_offset, scale);
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
// pointer and stride of q, k and v is in whole 16-byte units, for the TMA
// and wgmma build; 0 takes element loads (mma.sync). rows (vec 1): query
// positions a block, 128 (two consumer warpgroups) or 64 (one). q_offset
// (>= 0): query row i sits at position q_offset + i. Requires h % kvh == 0,
// h / kvh <= 96 and hd <= 256.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int b, int sq, int skv, int h,
                               int kvh, int hd, int64_t q_sb, int64_t q_ss,
                               int64_t q_sh, int64_t k_sb, int64_t k_ss,
                               int64_t k_sh, int64_t v_sb, int64_t v_ss,
                               int64_t v_sh, int causal, int window,
                               int q_offset, float scale, int bf16, int vec,
                               int rows, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16 && vec) {
    if (rows != 64 && (rows != 128 || hd > 128)) return cudaErrorInvalidValue;
    auto wg = [&](auto hdc) {
      constexpr int HD = decltype(hdc)::value;
      if constexpr (HD <= 128) {
        if (rows == 128) {
          return launch_wgmma<HD, 2>(q, k, v, out, qs, ks, vs, b, sq, skv, h,
                                     kvh, hd, causal, window, q_offset, scale,
                                     s);
        }
      }
      return launch_wgmma<HD, 1>(q, k, v, out, qs, ks, vs, b, sq, skv, h, kvh,
                                 hd, causal, window, q_offset, scale, s);
    };
    err = hd <= 64    ? wg(std::integral_constant<int, 64>{})
          : hd <= 80  ? wg(std::integral_constant<int, 80>{})
          : hd <= 128 ? wg(std::integral_constant<int, 128>{})
                      : wg(std::integral_constant<int, 256>{});
  } else if (bf16) {
    auto mma = [&](auto hdp) {
      return launch_mma<decltype(hdp)::value>(q, k, v, out, qs, ks, vs, b, sq,
                                              skv, h, kvh, hd, causal, window,
                                              q_offset, scale, s);
    };
    err = hd <= 64    ? mma(std::integral_constant<int, 64>{})
          : hd <= 128 ? mma(std::integral_constant<int, 128>{})
                      : mma(std::integral_constant<int, 256>{});
  } else {
    auto simt_c = [&](auto c) {
      return simt::launch<decltype(c)::value>(q, k, v, out, qs, ks, vs, b, sq,
                                              skv, h, kvh, hd, causal, window,
                                              q_offset, scale, s);
    };
    err = hd <= 64    ? simt_c(std::integral_constant<int, 2>{})
          : hd <= 128 ? simt_c(std::integral_constant<int, 4>{})
                      : simt_c(std::integral_constant<int, 8>{});
  }
  return static_cast<int>(err);
}
