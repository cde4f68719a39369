// The gradient of attention with an online softmax (flash_attention.cu):
// given q, k, v, the forward's output o, each row's log-sum-exp lse (which
// the forward writes under grad) and the output's gradient dO, the
// gradients dq, dk and dv in q's type.  P is never formed beyond one tile.
//
// Replaces no TPU kernel: the JAX package differentiates its jnp attention
// with XLA's autodiff.  It replaces the port's plain backward
// (kernels/flash_attention.py::flash_attention_backward: autograd through
// the f32 version, recomputed from q, k and v with each head's S x S
// logits, mask, probabilities and their gradients in device memory).
//
// The FlashAttention-2/3 backward, on this port's conventions: the mask
// is the forward's (key j is seen by the query at position q_pos =
// q_offset + i when j > q_pos - window and, if causal, j <= q_pos; one
// comparison each), grouped KV heads (query head h reads KV head
// h / (H / KH)), any Sq and Sk, and D != Dv (MLA).  Three launches:
//
// 1. delta_kernel: delta = rowsum(dO o) in f32 for every query row (0 on
//    the padding rows), and the f32 dq accumulator zeroed.
// 2. flash_attention_bwd_kernel: one block of two warpgroups per (b *
//    KH + KV head, tile of 128 keys).  Its first thread loads the block's
//    K and V tiles once by TMA, then the query tiles of 64 rows that may
//    see those keys (from the first row at or past the tile when causal,
//    to the last inside the window), for each of the G = H / KH query
//    heads of the KV head, keeping their q, dO, lse and delta in a ring of
//    2-4 shared-memory stages that it refills as both warpgroups release
//    them.  Each warpgroup owns 64 of the keys and, for each stage:
//      S^T  = K q^T                 (64 x 64, wgmma from shared memory)
//      dP^T = V dO^T
//      P^T  = 2^(S^T * scale * log2 e - lse)
//      dS^T = P^T (dP^T - delta)
//      dV  += P^T dO,  dK += dS^T q (P^T and dS^T as register operands)
//    with dV and dK in f32 registers across the walk.  S^T puts the keys
//    on wgmma's M so that P^T and dS^T already lie as the register operand
//    of the two products that accumulate over queries.  Only dq += dS K
//    needs dS from shared memory: each warpgroup stores its dS^T there
//    (an MN-major operand, under the 128-byte swizzle), and after a
//    barrier each computes half of dq's columns over all 128 keys, stages
//    them in shared memory and adds them to the f32 accumulator by TMA
//    reductions (the L2 adds), 64 x D floats a stage for the block.
// 3. dq_cast_kernel: dq = scale * accumulator, in q's type.
//
// dq is not deterministic: the blocks of a KV head's key tiles add into
// the same rows of the accumulator, and the reductions land in whatever
// order the blocks reach them, so two runs of one call may differ in dq
// by the rounding of f32 sums in another order (and in a bf16 dq by one
// rounding where that moves it across a boundary).  dk and dv are
// deterministic: each is summed in one block's registers, over query
// tiles and heads in a fixed order.  Every other kernel of the port sums
// in a fixed order; this dq is the one exception.
//
// Masking: only the (warpgroup, stage) pairs that straddle the causal
// diagonal, the window, Sk, Sq or a row that sees no key compare per
// element; a masked pair gets P = 0 and dS = 0.  A row that sees no key
// (q_pos - window >= Sk - 1) got the mean of v forward: P = 1 / Sk on each
// key and dS = 0 (masked_fill passes no gradient to the logits), as the
// plain version's gradient has it.  Stages in which no row sees a key of
// the block are skipped.  P and dS are rounded to bf16 only as wgmma
// operands (the forward rounds P the same way for P V); every sum is f32.
//
// Head dims: q, K and dO, V are each read both K-major (S^T and dP^T
// reduce over the head dim) and MN-major (dK, dV and dq's products run
// the head dim on N).  A tile is kept as column blocks of the 128-byte
// swizzle's 64 elements where 64 divides the width (D 128, 192; Dv 64,
// 128), else of the 32-byte swizzle's 16 (stablelm-3b's and zamba2's D
// 80, and D 64, so that dq's columns split on whole blocks): both
// readings then take the same bytes, and N = 80 needs no padding.
//
// What bounds it on an H100: operations.  At stablelm-3b's training shape
// (B 2, H 32, S 4096, D = Dv = 80, causal) a call's five products take
// 2 B H S^2 (3 D + 2 Dv) / 2 = 429 GFLOP, 0.43 ms at the bf16 tensor-core
// peak, against 0.34 GB of q, k, v, o, dO and the gradients.  Two
// warpgroups and no producer warpgroup: a third would cap a thread at 168
// registers (an SM sub-partition's share with 12 warps), and a warpgroup
// holds dK and dV (D / 2 + Dv / 2 registers) across the walk beside S^T
// and dP^T (64).

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemBudget = 227 * 1024 - 2048;
constexpr int kBQ = 64;    // query rows a stage
constexpr int kBK = 128;   // keys a block, 64 a warpgroup
static_assert(kRowPad % kBQ == 0, "stages copy whole padded row tiles");

template <int DQ, int DV>
struct BwdTile {
  static_assert(DQ % 16 == 0 && DV % 16 == 0 && DQ <= 256 && DV <= 128, "");
  // two warpgroups, whose first thread also issues the loads: a thread
  // may hold 255 registers (a third warpgroup, or a producer warp, would
  // cap the threads of an SM sub-partition at 168)
  static constexpr int kThreads = 2 * 128;
  // column-block widths (elements) of q / K and of dO / V: 64 under the
  // 128-byte swizzle, or 16 under the 32-byte one (D 64 too, so that dq's
  // columns split between the warpgroups on whole blocks)
  static constexpr int kQW = DQ % 64 == 0 && DQ > 64 ? 64 : 16;
  static constexpr int kVW = DV % 64 == 0 ? 64 : 16;
  // dq's columns: warpgroup 0 takes the first kCols0 (half the blocks,
  // rounded up), warpgroup 1 the rest, each over all 128 keys, in wgmmas of
  // at most 64 columns
  static constexpr int kCols0 = (DQ / kQW + 1) / 2 * kQW;
  static constexpr int kCols1 = DQ - kCols0;
  static constexpr int kKBytes = kBK * DQ * 2;
  static constexpr int kVBytes = kBK * DV * 2;
  static constexpr int kDSBytes = 64 * kBQ * 2;   // a warpgroup's dS^T
  static constexpr int kQBytes = kBQ * DQ * 2;
  static constexpr int kOBytes = kBQ * DV * 2;
  static constexpr int kRowBytes = kBQ * 4;       // lse or delta of a stage
  static_assert(kKBytes % 1024 == 0 && kVBytes % 1024 == 0 &&
                    kQBytes % 1024 == 0 && kOBytes % 1024 == 0,
                "tiles stay 1024-byte aligned");
  // dq's (kBQ x DQ) f32 staging, as 16-column blocks of kBQ rows (the
  // boxes its TMA reductions add)
  static constexpr int kStgBytes = kBQ * DQ * 4;
  static constexpr int kFixed = kKBytes + kVBytes + 2 * kDSBytes + kStgBytes;
  // a stage: q and dO tiles in the ring, lse and delta rows after it
  static constexpr int kStageBytes = kQBytes + kOBytes;
  static constexpr int kStageTx = kStageBytes + 2 * kRowBytes;
  static constexpr int kFit = (kSmemBudget - kFixed) / kStageTx;
  static constexpr int kStages = kFit > 4 ? 4 : kFit;
  static_assert(kStages >= 2, "two stages must fit");
  static constexpr int kSmem =
      1024 + kFixed + kStages * kStageTx + 8 * (1 + 2 * kStages);
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int kN>
__device__ __forceinline__ void keep_regs(const uint32_t (&a)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
    asm volatile("" ::"r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3])
                 : "memory");
}

// The descriptor of k-step kk of a K-major operand: a tile of `rows` rows
// kept as column blocks W elements wide, from row `row0`.
template <int W>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int rows, int row0,
                                           int kk) {
  constexpr sm90::Swizzle sw = W == 64 ? sm90::kSw128 : sm90::kSw32;
  const int col = 16 * kk;
  return sm90::make_desc(base + (col / W) * rows * W * 2 + row0 * W * 2 +
                             (col % W) * 2,
                         16, 8 * W * 2, sw);
}

// The descriptor of k-step kk (rows 16 kk on) of an MN-major operand: the
// same tile read with its columns on M or N, from column block `cb0`.
template <int W>
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int rows, int kk,
                                            int cb0 = 0) {
  constexpr sm90::Swizzle sw = W == 64 ? sm90::kSw128 : sm90::kSw32;
  return sm90::make_desc(base + cb0 * rows * W * 2 + 16 * kk * W * 2,
                         rows * W * 2, 8 * W * 2, sw);
}

// delta[bh, i] = sum_d dO[bh, i, d] o[bh, i, d] (0 for i in [Sq, Sqp)); and
// the dq accumulator's row zeroed.  One warp a padded row.
__global__ void __launch_bounds__(256)
    delta_kernel(const __nv_bfloat16* __restrict__ o,
                 const __nv_bfloat16* __restrict__ dout,
                 float* __restrict__ delta, float* __restrict__ dq_acc,
                 int rows, int Sq, int Sqp, int D, int Dv) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int bh = row / Sqp, i = row % Sqp;
  float sum = 0.f;
  if (i < Sq) {
    const size_t r = static_cast<size_t>(bh) * Sq + i;
    const __nv_bfloat162* op =
        reinterpret_cast<const __nv_bfloat162*>(o + r * Dv);
    const __nv_bfloat162* gp =
        reinterpret_cast<const __nv_bfloat162*>(dout + r * Dv);
    for (int d = lane; 2 * d < Dv; d += 32) {
      const float2 a = __bfloat1622float2(op[d]);
      const float2 g = __bfloat1622float2(gp[d]);
      sum = fmaf(a.x, g.x, fmaf(a.y, g.y, sum));
    }
    float2* acc = reinterpret_cast<float2*>(dq_acc + r * D);
    for (int d = lane; 2 * d < D; d += 32) acc[d] = make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

// dq = scale * accumulator, in bf16: n2 pairs.
__global__ void __launch_bounds__(256)
    dq_cast_kernel(const float* __restrict__ dq_acc,
                   __nv_bfloat16* __restrict__ dq, size_t n2, float scale) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n2; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float2 a = reinterpret_cast<const float2*>(dq_acc)[i];
    reinterpret_cast<__nv_bfloat162*>(dq)[i] =
        __floats2bfloat162_rn(a.x * scale, a.y * scale);
  }
}

// dq's columns [C0, C0 + NC) for the stage's kBQ query rows, over the
// block's 128 keys: dS (both warpgroups' dS^T, MN-major, at ds_addr) times
// K (MN-major, column blocks W wide, at ks_addr), in wgmmas of at most 64
// columns, written to the f32 staging as 16-column blocks.
template <int NC, int C0, int W>
__device__ __forceinline__ void dq_cols(uint32_t ds_addr, uint32_t ks_addr,
                                        float* stg, int warp, int lane) {
  using namespace sm90;
  constexpr int kN = NC > 64 ? 64 : NC;
  static_assert(NC % kN == 0 && C0 % 16 == 0 && kN % 16 == 0, "");
#pragma unroll
  for (int c = 0; c < NC / kN; ++c) {
    float dqa[kN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      WgmmaSS<kN>::template mma<1, 1>(
          dqa, make_desc(ds_addr + kk * 16 * 128, 64 * 128, 1024, kSw128),
          desc_mn<W>(ks_addr, kBK, kk, (C0 + c * kN) / W), kk > 0 ? 1 : 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + lane / 4 + 8 * r;
        const int col = C0 + c * kN + 8 * j + 2 * (lane % 4);
        *reinterpret_cast<float2*>(stg + (col / 16) * kBQ * 16 + row * 16 +
                                   col % 16) =
            make_float2(dqa[4 * j + 2 * r], dqa[4 * j + 2 * r + 1]);
      }
  }
}

template <int DQ, int DV>
__global__ void __launch_bounds__(BwdTile<DQ, DV>::kThreads, 1)
    flash_attention_bwd_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap omap,
                               const __grid_constant__ CUtensorMap dqmap,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int H, int KH,
                               int Sq, int Sk, int D, int Dv, float scale,
                               int causal, int window, int q_offset) {
  using T = BwdTile<DQ, DV>;
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ks = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* vs = ks + T::kKBytes;
  uint8_t* dss = vs + T::kVBytes;            // [128 keys][kBQ] bf16: dS^T
  float* stg = reinterpret_cast<float*>(dss + 2 * T::kDSBytes);
  uint8_t* ring = reinterpret_cast<uint8_t*>(stg) + T::kStgBytes;
  float* rows_s = reinterpret_cast<float*>(ring + T::kStages * T::kStageBytes);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(rows_s + T::kStages * 2 * kBQ);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + T::kStages;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int kvh = blockIdx.x;                // b * KH + KV head
  const int b = kvh / KH, G = H / KH, h0 = (kvh % KH) * G;
  const int k0 = blockIdx.y * kBK;
  const int Sqp = (Sq + kRowPad - 1) / kRowPad * kRowPad;

  // The query rows that may see a key of this tile, and the rows that see
  // no key at all (from i_dead on), which every key tile visits.
  const long long k_last = min(k0 + kBK, Sk) - 1;
  long long i_lo = causal ? max(0, k0 - q_offset) : 0;
  long long i_hi = min(static_cast<long long>(Sq) - 1,
                       k_last + window - 1 - q_offset);
  const long long i_dead = static_cast<long long>(Sk) - 1 + window - q_offset;
  if (i_dead < Sq) {
    i_lo = min(i_lo, max(0LL, i_dead));
    i_hi = Sq - 1;
  }
  const int qt_lo = static_cast<int>(i_lo / kBQ);
  const int nq = i_lo > i_hi ? 0 : static_cast<int>(i_hi / kBQ) - qt_lo + 1;
  const int nsteps = G * nq;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Thread 0 loads: K and V once, then each step's q, dO, lse and delta
  // into its stage, kStages steps ahead of the warpgroups (the stage of step
  // it is refilled for step it + kStages once both warpgroups released it).
  auto load_stage = [&](int it) {
    const int s = it % T::kStages;
    const int bh = b * H + h0 + it / nq;
    const int q0 = (qt_lo + it % nq) * kBQ;
    uint8_t* qs = ring + s * T::kStageBytes;
    uint8_t* os = qs + T::kQBytes;
    float* rs = rows_s + s * 2 * kBQ;   // lse, then delta
    mbar_expect_tx(&full[s], T::kStageTx);
#pragma unroll
    for (int cb = 0; cb < DQ / T::kQW; ++cb)
      tma_load_3d(qs + cb * kBQ * T::kQW * 2, &qmap, &full[s], T::kQW * cb,
                  q0, bh);
#pragma unroll
    for (int cb = 0; cb < DV / T::kVW; ++cb)
      tma_load_3d(os + cb * kBQ * T::kVW * 2, &omap, &full[s], T::kVW * cb,
                  q0, bh);
    const size_t r0 = static_cast<size_t>(bh) * Sqp + q0;
    bulk_load(rs, lse + r0, T::kRowBytes, &full[s]);
    bulk_load(rs + kBQ, delta + r0, T::kRowBytes, &full[s]);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kvbar, T::kKBytes + T::kVBytes);
#pragma unroll
    for (int cb = 0; cb < DQ / T::kQW; ++cb)
      tma_load_3d(ks + cb * kBK * T::kQW * 2, &kmap, kvbar, T::kQW * cb, k0,
                  kvh);
#pragma unroll
    for (int cb = 0; cb < DV / T::kVW; ++cb)
      tma_load_3d(vs + cb * kBK * T::kVW * 2, &vmap, kvbar, T::kVW * cb, k0,
                  kvh);
    for (int it = 0; it < T::kStages && it < nsteps; ++it) load_stage(it);
  }

  const int warp = t / 32, lane = t % 32;
  const float sl2 = scale * kLog2e;
  const float inv_sk = 1.f / static_cast<float>(Sk);
  const int kw0 = k0 + 64 * wg;              // this warpgroup's first key
  const int kw_last = min(kw0 + 63, Sk - 1);
  const uint32_t ks_addr = smem_u32(ks), vs_addr = smem_u32(vs);
  uint8_t* my_ds = dss + wg * T::kDSBytes;
  const uint32_t ds_addr = smem_u32(dss);
  float dka[DQ / 2], dva[DV / 2];
#pragma unroll
  for (int j = 0; j < DQ / 2; ++j) dka[j] = 0.f;
#pragma unroll
  for (int j = 0; j < DV / 2; ++j) dva[j] = 0.f;
  mbar_wait(kvbar, 0);

  for (int it = 0; it < nsteps; ++it) {
    const int s = it % T::kStages;
    const uint32_t ph = (it / T::kStages) & 1;
    const int bh = b * H + h0 + it / nq;
    const int q0 = (qt_lo + it % nq) * kBQ;
    const int rows = min(kBQ, Sq - q0);
    const int qlo = q_offset + q0, qhi = qlo + rows - 1;
    const bool dead_in = i_dead <= q0 + rows - 1;
    // both warpgroups take a stage in which a row sees a key of the block
    // (dq's product runs over all of the block's keys)
    const bool work =
        dead_in || (!(causal && k0 > qhi) &&
                    k_last > static_cast<long long>(qlo) - window);
    mbar_wait(&full[s], ph);
    if (work) {
      const uint32_t qs = smem_u32(ring + s * T::kStageBytes);
      const uint32_t os = qs + T::kQBytes;
      const float* lse_s = rows_s + s * 2 * kBQ;
      const float* del_s = lse_s + kBQ;

      // S^T = K q^T and dP^T = V dO^T (64 keys x kBQ queries, f32)
      float sacc[kBQ / 2], dpa[kBQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ / 16; ++kk)
        WgmmaSS<kBQ>::template mma<0>(
            sacc, desc_k<T::kQW>(ks_addr, kBK, 64 * wg, kk),
            desc_k<T::kQW>(qs, kBQ, 0, kk), kk > 0 ? 1 : 0);
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        WgmmaSS<kBQ>::template mma<0>(
            dpa, desc_k<T::kVW>(vs_addr, kBK, 64 * wg, kk),
            desc_k<T::kVW>(os, kBQ, 0, kk), kk > 0 ? 1 : 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(dpa);

      // P^T into sacc, dS^T into dpa: thread t holds keys kp (rows) and
      // queries (columns) 8 j + 2 (lane % 4) + (e & 1) of the tile
      const bool masked = kw0 + 63 >= Sk || rows < kBQ ||
                          (causal && kw_last > qlo) ||
                          static_cast<long long>(kw0) <=
                              static_cast<long long>(qhi) - window ||
                          dead_in;
      if (!masked) {
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j) {
          const float2 ls = *reinterpret_cast<const float2*>(
              lse_s + 8 * j + 2 * (lane % 4));
          const float2 dl = *reinterpret_cast<const float2*>(
              del_s + 8 * j + 2 * (lane % 4));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(sacc[4 * j + e], sl2, -((e & 1) ? ls.y : ls.x)));
            sacc[4 * j + e] = p;
            dpa[4 * j + e] = p * (dpa[4 * j + e] - ((e & 1) ? dl.y : dl.x));
          }
        }
      } else {
        const int kr = kw0 + 16 * warp + lane / 4;
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j) {
          const float2 ls = *reinterpret_cast<const float2*>(
              lse_s + 8 * j + 2 * (lane % 4));
          const float2 dl = *reinterpret_cast<const float2*>(
              del_s + 8 * j + 2 * (lane % 4));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = kr + 8 * (e >> 1);
            const int qi = q0 + 8 * j + 2 * (lane % 4) + (e & 1);
            const int qp = q_offset + qi;
            float p = 0.f, ds = 0.f;
            if (kp >= Sk || qi >= Sq) {
              // not a key, or not a query: nothing
            } else if (qi >= i_dead) {
              p = inv_sk;   // a row that sees no key: the mean of v
            } else if (!((causal && kp > qp) ||
                         static_cast<long long>(kp) <=
                             static_cast<long long>(qp) - window)) {
              p = ex2(fmaf(sacc[4 * j + e], sl2, -((e & 1) ? ls.y : ls.x)));
              ds = p * (dpa[4 * j + e] - ((e & 1) ? dl.y : dl.x));
            }
            sacc[4 * j + e] = p;
            dpa[4 * j + e] = ds;
          }
        }
      }

      // bf16 register operands, and dS^T into shared memory (rows of kBQ
      // queries, 128 bytes, under the 128-byte swizzle) for dq's product,
      // once both warpgroups' last dq products have read it and this
      // warpgroup's last reductions its staging
      uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          pa[kk][w] = pack_bf16(sacc[8 * kk + 2 * w], sacc[8 * kk + 2 * w + 1]);
          da[kk][w] = pack_bf16(dpa[8 * kk + 2 * w], dpa[8 * kk + 2 * w + 1]);
        }
      if (t == 0) tma_store_wait_read();
      named_sync(1, 256);
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int row = 16 * warp + lane / 4 + 8 * (w & 1);
          const int chunk = 2 * kk + (w >> 1);
          *reinterpret_cast<uint32_t*>(my_ds + row * 128 +
                                       ((chunk ^ (lane / 4)) * 16) +
                                       (lane % 4) * 4) = da[kk][w];
        }
      fence_async_smem();
      named_sync(2, 256);

      // dV += P^T dO, dK += dS^T q (over the kBQ queries)
      fence_regs(dva);
      fence_regs(dka);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        WgmmaRS<DV>::template mma<1>(dva, pa[kk],
                                     desc_mn<T::kVW>(os, kBQ, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        WgmmaRS<DQ>::template mma<1>(dka, da[kk],
                                     desc_mn<T::kQW>(qs, kBQ, kk), 1);
      wgmma_commit();

      // dq (kBQ x D) += dS K: this warpgroup's columns over all 128 keys,
      // staged and added to the accumulator by TMA reductions of 16-column
      // boxes (rows past Sq and columns past D are dropped)
      if (wg == 0)
        dq_cols<T::kCols0, 0, T::kQW>(ds_addr, ks_addr, stg, warp, lane);
      else
        dq_cols<T::kCols1, T::kCols0, T::kQW>(ds_addr, ks_addr, stg, warp,
                                              lane);
      fence_async_smem();
      named_sync(3 + wg, 128);
      if (t == 0) {
        const int b_lo = wg == 0 ? 0 : T::kCols0 / 16;
        const int b_hi = wg == 0 ? T::kCols0 / 16 : DQ / 16;
        for (int blk = b_lo; blk < b_hi; ++blk)
          tma_reduce_add_3d(&dqmap, stg + blk * kBQ * 16, 16 * blk, q0, bh);
        tma_store_commit();
      }
      fence_regs(dva);
      fence_regs(dka);
      keep_regs(pa);
      keep_regs(da);
    }
    mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && it + T::kStages < nsteps) {
      mbar_wait(&empty[s], ph);
      load_stage(it + T::kStages);
    }
  }

  if (t == 0) tma_store_wait_all();   // the reductions are done

  // dK (times the scale: S = scale q K^T) and dV, as bf16 pairs
  const int kr = kw0 + 16 * warp + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kr + 8 * r;
    if (key >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DQ / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < D)
        *reinterpret_cast<uint32_t*>(
            dk + (static_cast<size_t>(kvh) * Sk + key) * D + col) =
            pack_bf16(dka[4 * j + 2 * r] * scale,
                      dka[4 * j + 2 * r + 1] * scale);
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < Dv)
        *reinterpret_cast<uint32_t*>(
            dv + (static_cast<size_t>(kvh) * Sk + key) * Dv + col) =
            pack_bf16(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
  }
}

template <int DQ, int DV = DQ>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const float* lse, const void* dout,
                       void* dq, void* dk, void* dv, float* dq_acc,
                       float* delta, int B, int H, int KH, int Sq, int Sk,
                       int D, int Dv, float scale, int causal, int window,
                       int q_offset, cudaStream_t stream) {
  using T = BwdTile<DQ, DV>;
  if (D > DQ || Dv > DV || D % 8 || Dv % 8 || !aligned(q, 16) ||
      !aligned(k, 16) || !aligned(v, 16) || !aligned(o, 16) ||
      !aligned(dout, 16) || !aligned(lse, 16) || !aligned(delta, 16) ||
      !aligned(dq, 16) || !aligned(dk, 4) || !aligned(dv, 4) ||
      !aligned(dq_acc, 16))
    return cudaErrorInvalidValue;   // what TMA and the bulk copies cannot take
  const uint64_t BH = static_cast<uint64_t>(B) * H;
  const uint64_t BKH = static_cast<uint64_t>(B) * KH;
  const int Sqp = (Sq + kRowPad - 1) / kRowPad * kRowPad;

  // The pre-pass first: a runtime launch also makes the device's context
  // current on this thread (autograd's), which encoding a tensor map needs.
  const int rows = static_cast<int>(BH) * Sqp;
  delta_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), delta, dq_acc, rows, Sq, Sqp,
      D, Dv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr CUtensorMapSwizzle kQMapSw =
      T::kQW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  constexpr CUtensorMapSwizzle kVMapSw =
      T::kVW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap qmap, kmap, vmap, omap, dqmap;
  if (!make_map_3d(&qmap, q, D, Sq, BH, T::kQW, kBQ, kQMapSw) ||
      !make_map_3d(&kmap, k, D, Sk, BKH, T::kQW, kBK, kQMapSw) ||
      !make_map_3d(&vmap, v, Dv, Sk, BKH, T::kVW, kBK, kVMapSw) ||
      !make_map_3d(&omap, dout, Dv, Sq, BH, T::kVW, kBQ, kVMapSw) ||
      !make_map_3d(&dqmap, dq_acc, D, Sq, BH, 16, kBQ,
                   CU_TENSOR_MAP_SWIZZLE_NONE, /*f32=*/true))
    return cudaErrorInvalidValue;

  auto kernel = flash_attention_bwd_kernel<DQ, DV>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(BKH), (Sk + kBK - 1) / kBK);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      qmap, kmap, vmap, omap, dqmap, lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, KH,
      Sq, Sk, D, Dv, scale, causal, window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t n2 = BH * Sq * D / 2;
  const unsigned blocks = static_cast<unsigned>(
      n2 / 256 + 1 < 132 * 16 ? n2 / 256 + 1 : 132 * 16);
  dq_cast_kernel<<<blocks, 256, 0, stream>>>(
      dq_acc, static_cast<__nv_bfloat16*>(dq), n2, scale);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const void*, const void*, const void*,
                                 const void*, const float*, const void*, void*,
                                 void*, void*, float*, float*, int, int, int,
                                 int, int, int, int, float, int, int, int,
                                 cudaStream_t);

// The instances by id (kernels/flash_attention.py::BACKWARD_TILINGS lists
// the same names in the same order): one per (q/k, v) head-dim width pair
// of the forward's bf16 instances.
struct Tiling {
  const char* name;
  Launcher fn;
};
const Tiling kTilings[] = {
    {"wgmma_bk128_bq64_d64", &launch_bwd<64>},
    {"wgmma_bk128_bq64_d80", &launch_bwd<80>},
    {"wgmma_bk128_bq64_d128", &launch_bwd<128>},
    {"wgmma_bk128_bq64_d192_v128", &launch_bwd<192, 128>},
};
constexpr int kNumTilings = sizeof(kTilings) / sizeof(kTilings[0]);

}  // namespace
}  // namespace repro

// The tiling names by id, comma-separated.
extern "C" const char* repro_flash_attention_backward_tilings() {
  static const char* names = [] {
    static char buf[512];
    size_t n = 0;
    for (int i = 0; i < repro::kNumTilings; ++i) {
      for (const char* p = repro::kTilings[i].name; *p && n + 2 < sizeof(buf);)
        buf[n++] = *p++;
      if (i + 1 < repro::kNumTilings) buf[n++] = ',';
    }
    buf[n] = 0;
    return buf;
  }();
  return names;
}

// q: (B, H, Sq, D), k: (B, KH, Sk, D), v: (B, KH, Sk, Dv), o and dout: (B,
// H, Sq, Dv), bf16, contiguous; lse: the forward's (B, H, Sqp) f32, Sqp =
// Sq rounded up to kRowPad; dq, dk, dv: bf16 like q, k, v; scratch dq_acc:
// (B, H, Sq, D) f32 and delta: (B, H, Sqp) f32.  Run by the instance of
// `tiling` (an id of repro_flash_attention_backward_tilings()).  Returns a
// cudaError_t.
extern "C" int repro_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* dq_acc, float* delta, int B, int H, int KH, int Sq, int Sk, int D,
    int Dv, float scale, int causal, int window, int q_offset, int tiling,
    void* stream) {
  if (tiling < 0 || tiling >= repro::kNumTilings) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Sq == 0) return cudaSuccess;
  if (KH <= 0 || H % KH != 0 || Sk <= 0 || D <= 0 || Dv <= 0 || window < 1 ||
      q_offset < 0 || (Sk + 127) / 128 > 65535)
    return cudaErrorInvalidValue;
  return static_cast<int>(repro::kTilings[tiling].fn(
      q, k, v, o, lse, dout, dq, dk, dv, dq_acc, delta, B, H, KH, Sq, Sk, D,
      Dv, scale, causal, window, q_offset, static_cast<cudaStream_t>(stream)));
}
