// Attention with an online softmax: o = softmax(mask(q k^T * scale)) v,
// with the running row max m, row sum l and accumulator in f32, written
// in q's type.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (its pl.pallas_call is in flash_attention() at flash_attention.py:80),
// which folds B*H into one parallel grid axis, walks the KV tiles on a
// sequential grid axis with (m, l, acc) in VMEM scratch, skips causal
// tiles above the diagonal, and needs S % bq == 0 and Sk % bk == 0.  This
// kernel computes what the model calls through it
// (nn/attention.py::chunked_attention): grouped KV heads (query head h
// reads KV head h / (H / KH)), a sliding window and a query offset, each
// one comparison per logit: key j is seen by the query at position
// q_pos = q_offset + i when j > q_pos - window and, if causal, j <= q_pos.
// A masked logit is -1e30 (as the reference's recurrence has it, so a row
// that sees no key gets the mean of v), a key past Sk gets weight 0, l is
// floored at 1e-30.  v's head dim Dv may differ from q's and k's D (MLA:
// D 192 = 128 + 64 rope, Dv 128); o is (B, H, Sq, Dv).  Any Sq and Sk are
// taken, at the (D, Dv) widths of the instances below.  Only the key
// tiles that some row of the block may see are visited: with every row
// seeing at least one key, tiles above the causal diagonal and tiles
// behind the window are skipped (their logits would be masked for every
// row and contribute exactly 0).  Blocks take the query tiles from the
// last to the first, so the longest causal rows start first.
//
// What bounds it on an H100: operations.  At the training path's shape
// (stablelm-3b: B 4, H 32, S 2048, D 80, causal, bf16) a call does 85.9
// GFLOP, 0.087 ms at the bf16 tensor-core peak, against 168 MB of q, k, v
// and o, 0.05 ms at 3.35 TB/s.
//
// Two kernels, chosen per call by the tiling id the wrapper passes
// (kernels/flash_attention.py::select_tiling maps the dtype, the shape and
// the deployed config's bq/bk/d to an id of kTilings below), the SIMT one
// at several tiles:
//
// wgmma_bq*_bk*_d* — bf16 on the tensor cores, one instance per (bq, bk,
// head-dim width) that a deployed config or the training path's default
// names.  One block of three warpgroups per (b*h, bq query rows): a
// producer warpgroup, of which one thread issues TMA, and two consumer
// warpgroups that own bq/2 rows each (one or two slices of 64).  The
// producer loads the q tile once and keeps the K and V tiles of bk keys
// in flight in a ring of 2-4 shared-memory stages, K and V behind
// separate "full" mbarriers (so S = q K^T starts before V lands) and one
// "empty" mbarrier per stage that every consumer thread arrives on when it
// is done.  The tensor maps are 3-D over (B*heads, S, D): a tile past Sq
// or Sk is zero-filled by TMA, never read from the next head.  A consumer
// slice computes S = q K^T with m64 x bk x 16 wgmma from shared memory (q
// and K both K-major), masks only the tiles that straddle the diagonal,
// the window or Sk, and runs the online softmax on the accumulator
// fragments in registers: the row max over the 4 threads of a row quad
// by shuffles, the scale folded into exp2's argument (p = 2^((s - max) *
// scale * log2 e)), the row sum kept
// per thread and reduced once at the end.  P is rounded to bf16 in
// registers, where it already lies as wgmma's register A operand, and O
// += P V runs as m64 x D x 16 wgmma with V (bk x D, row-major) as an
// MN-major B (the transpose bit).  Rounding P to bf16 before P V is
// FlashAttention's own trade; the reference multiplies in f32.  Slices
// whose rows see none of a tile's keys skip it.  The epilogue divides by
// l and writes o as bf16 pairs; under grad (the wrapper passes an lse
// buffer) it also writes each row's base-2 log-sum-exp, m * scale * log2 e
// + log2 l, the input of the backward kernel (flash_attention_bwd.cu).  The producer gives its registers to the
// consumers (setmaxnreg: 24 and 240 of the 168 a thread starts with).
//
// Head dims.  q and K are K-major operands (the reduction runs over D):
// they are kept as 64-wide column blocks under the 128-byte swizzle, a
// head dim of 80 padded to 128 in shared memory by TMA's zero fill, and
// S = q K^T runs ceil(D/16) k-steps, so the padding costs no arithmetic.
// V is an MN-major operand whose N is D, and an MN-major swizzled tile
// must be a whole number of swizzle widths along N.  So V takes the
// widest swizzle whose width divides D: 128 bytes (64 elements) for D 64
// and 128, and for stablelm-3b's D = 80 the 32-byte swizzle, as five
// 16-wide column blocks (80 = 5 x 16), with N = 80 in one wgmma — no
// padding and no wasted products in P V.  The paper's D = 32 runs on the
// D-64 instance (zero-filled columns, not stored).  TMA needs 16-byte rows,
// so this route takes D a multiple of 8 and 16-byte-aligned tensors.
//
// MLA's head dims (deepseek-v2-lite: D 192, Dv 128) run
// wgmma_bq128_bk128_d192_v128, the kernel templated on the q/K width (192:
// three 64-wide column blocks, S = q K^T in 12 k-steps of 16) apart from
// the V/o width (128).  P V keeps N = 128, so the registers a consumer
// needs are those of the d128 instance; only shared memory grows.  At bk
// 128 q takes 48 KB and a K/V stage 48 + 32 KB, so two stages fit (208 KB
// of the 227 KB a block may have); bk 64 would fit four stages of 40 KB
// but would halve the keys between two barrier waits and add an
// instance that no deployed config names: the default 128 x 128 tile is
// kept, as every model call takes it.
//
// simt_* — the SIMT kernel, a template on its tile (BQ query rows, BK
// keys, head dims padded to DP): simt_64x64 for f32 calls that name no
// config (the model's) and bf16 shapes TMA cannot take (D not a multiple
// of 8), at the narrowest DP that holds D; simt_bq*_bk*_d* for f32 calls
// with a deployed config, one instance per config's tile;
// simt_bq64_bk64_d192_v128 for f32 calls at MLA's head dims (the model's
// and the host comparison's; its tiles take 150 KB).  A config whose
// f32 q, K^T, V and P tiles exceed 227 KB of shared memory runs the tile
// the wrapper's f32_block fits to it, named after it: bk halved, then bq
// ((128, 256, 64) runs bq128_bk128_d64, (256, 128, 64) bq256_bk64_d64,
// (128, 128, 128) bq128_bk64_d128).  One block of 256 threads per (b*h,
// tile of BQ query rows).  The q tile is staged once in shared memory as
// f32 (already scaled); each BK-key tile of K (transposed) and V is
// staged as f32 in turn.  Thread (ty, tx) of a 16 x 16 grid owns a (BQ /
// 16) x (BK / 16) patch of the logits (rows (BQ / 16) ty + i, keys tx +
// 16j), reading q as float4 and K^T along consecutive keys, so neither
// read conflicts on a bank.  The row max and row sum are reduced over the
// 16 lanes that share a row with warp shuffles; the probabilities go
// through shared memory to the P V product, where the same thread owns
// its rows and head dims tx + 16c, with (m, l, acc) in registers.  IEEE
// f32 FMAs, never TF32, and the sums run in a fixed order, so a result is
// deterministic.  ptxas (sm_90a): 122-128 registers at 64 x 64, 249-255
// at the deployed tiles, no spills.  Its ceiling is the f32 FMA rate, 67
// TFLOP/s.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {
namespace simt {

constexpr int kThreads = 256;    // a 16 x 16 grid of threads
constexpr float kNeg = -1e30f;   // the logit of a masked key

// floats of shared memory for a BQ x BK tile at q/K head dims padded to
// DP and V head dims padded to DV
constexpr int smem_floats(int BQ, int BK, int DP, int DV) {
  return BQ * (DP + 4) + DP * (BK + 1) + BK * DV + BQ * (BK + 4);
}

template <typename T, int BQ, int BK, int DP, int DV>
__global__ void __launch_bounds__(kThreads, BQ * BK <= 64 * 64 ? 2 : 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int H,
                           int KH, int Sq, int Sk, int D, int Dv,
                           float scale, int causal, int window,
                           int q_offset) {
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && DP % 16 == 0 && DV % 16 == 0,
                "");
  constexpr int QP = DP + 4;     // pitch of q rows: 16-byte aligned, and
                                 // rows 4 apart fall in other banks
  constexpr int KP = BK + 1;     // pitch of K^T rows (conflict-free stores)
  constexpr int PP = BK + 4;     // pitch of the probability rows
  constexpr int RQ = BQ / 16;    // query rows per thread
  constexpr int RK = BK / 16;    // keys per thread
  constexpr int NC = DV / 16;    // V head dims per thread in P V
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BQ][QP]
  float* kt = qs + BQ * QP;                      // [DP][KP]
  float* vs = kt + DP * KP;                      // [BK][DV]
  float* ps = vs + BK * DV;                      // [BQ][PP]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = b * KH + h / (H / KH);
  const int rows = min(BQ, Sq - q0);
  const T* qp = q + (static_cast<size_t>(bh) * Sq + q0) * D;
  const T* kp = k + static_cast<size_t>(kvh) * Sk * D;
  const T* vp = v + static_cast<size_t>(kvh) * Sk * Dv;
  T* op = o + (static_cast<size_t>(bh) * Sq + q0) * Dv;

  for (int i = tid; i < BQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    qs[r * QP + d] =
        (r < rows && d < D) ? to_f32(qp[static_cast<size_t>(r) * D + d]) * scale
                            : 0.f;
  }

  // The keys some row of this block may see.  If every row sees at least
  // one key (the last row does, window >= 1), tiles outside that range are
  // masked for every row and skipped; otherwise every tile is visited so
  // that a row that sees nothing gets the reference's mean of v.
  const int qlo = q_offset + q0, qhi = q_offset + q0 + rows - 1;
  int k_begin = 0, k_end = Sk;
  if (qhi - window + 1 <= Sk - 1) {
    k_begin = max(0, qlo - window + 1) / BK * BK;
    if (causal) k_end = min(Sk, qhi + 1);
  }

  float m[RQ], l[RQ], acc[RQ][NC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's K, V and P are read
    for (int i = tid; i < BK * DP; i += kThreads) {
      const int c = i / DP, d = i % DP;
      kt[d * KP + c] = k0 + c < Sk && d < D
                           ? to_f32(kp[static_cast<size_t>(k0 + c) * D + d])
                           : 0.f;
    }
    for (int i = tid; i < BK * DV; i += kThreads) {
      const int c = i / DV, d = i % DV;
      vs[c * DV + d] = k0 + c < Sk && d < Dv
                           ? to_f32(vp[static_cast<size_t>(k0 + c) * Dv + d])
                           : 0.f;
    }
    __syncthreads();

    // logits of rows RQ ty + i and keys tx + 16 j, 4 head dims at a time
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float kv[4][RK];
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
#pragma unroll
        for (int j = 0; j < RK; ++j) kv[dd][j] = kt[(d + dd) * KP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&qs[(RQ * ty + i) * QP + d]);
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          float x = s[i][j];
          x = fmaf(qv.x, kv[0][j], x);
          x = fmaf(qv.y, kv[1][j], x);
          x = fmaf(qv.z, kv[2][j], x);
          s[i][j] = fmaf(qv.w, kv[3][j], x);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int q_pos = q_offset + q0 + RQ * ty + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        float x = s[i][j];
        if (k_pos >= Sk)
          x = -INFINITY;   // not a key at all: weight exactly 0
        else if ((causal && k_pos > q_pos) || k_pos <= q_pos - window)
          x = kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = expf(s[i][j] - mx);
        ps[(RQ * ty + i) * PP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      float pv[RQ], vv[NC];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = ps[(RQ * ty + i) * PP + key];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[key * DV + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = RQ * ty + i;
    if (r >= rows) continue;
    const float ell = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < Dv) op[static_cast<size_t>(r) * Dv + d] = from_f32<T>(acc[i][c] / ell);
    }
  }
}

// The SIMT kernel writes no log-sum-exp: the gradient of its calls is the
// plain version's.
template <typename T, int BQ, int BK, int DP, int DV = DP>
cudaError_t launch_dp(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int H, int KH, int Sq, int Sk, int D,
                      int Dv, float scale, int causal, int window,
                      int q_offset, cudaStream_t stream) {
  constexpr int smem =
      smem_floats(BQ, BK, DP, DV) * static_cast<int>(sizeof(float));
  static_assert(smem <= 227 * 1024, "the f32 tile must fit a block");
  if (D > DP || Dv > DV || lse != nullptr) return cudaErrorInvalidValue;
  auto kernel = flash_attention_kernel<T, BQ, BK, DP, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, Sq, Sk, D, Dv,
      scale, causal, window, q_offset);
  return cudaGetLastError();
}

// simt_64x64: 64 x 64 tiles at the narrowest head-dim width that holds D
// and Dv
template <typename T>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int H, int KH, int Sq, int Sk,
                        int D, int Dv, float scale, int causal, int window,
                        int q_offset, cudaStream_t stream) {
  const int w = D > Dv ? D : Dv;
  if (w <= 32)
    return launch_dp<T, 64, 64, 32>(q, k, v, o, lse, B, H, KH, Sq, Sk, D, Dv,
                                    scale, causal, window, q_offset, stream);
  if (w <= 64)
    return launch_dp<T, 64, 64, 64>(q, k, v, o, lse, B, H, KH, Sq, Sk, D, Dv,
                                    scale, causal, window, q_offset, stream);
  if (w <= 80)
    return launch_dp<T, 64, 64, 80>(q, k, v, o, lse, B, H, KH, Sq, Sk, D, Dv,
                                    scale, causal, window, q_offset, stream);
  if (w <= 128)
    return launch_dp<T, 64, 64, 128>(q, k, v, o, lse, B, H, KH, Sq, Sk, D,
                                     Dv, scale, causal, window, q_offset,
                                     stream);
  return cudaErrorInvalidValue;
}

}  // namespace simt

// ---------------------------------------------------------------------------
// wgmma: bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr float kMasked = -1e30f;   // the logit of a masked key
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemBudget = 227 * 1024 - 2048;

template <int BQ, int BK, int DQ, int DV>
struct FaTile {
  static_assert(BQ == 128 || BQ == 256, "two consumers of 1 or 2 slices");
  static_assert(BK % 64 == 0 && BK <= 256 && DQ % 16 == 0 && DQ <= 256 &&
                    DV % 16 == 0 && DV <= 128,
                "");
  static constexpr int kMI = BQ / 128;            // m64 slices a consumer
  static constexpr int kThreads = 3 * 128;        // 2 consumers + producer
  static constexpr int kDCB = (DQ + 63) / 64;     // q/K column blocks
  static constexpr int kQBytes = kDCB * BQ * 128;
  static constexpr int kKBytes = kDCB * BK * 128;
  // V: column blocks of the 128-byte swizzle's 64 elements where they
  // divide DV, else of the 32-byte swizzle's 16
  static constexpr int kVW = DV % 64 == 0 ? 64 : 16;
  static constexpr sm90::Swizzle kVSw = kVW == 64 ? sm90::kSw128 : sm90::kSw32;
  static constexpr int kVBytes = BK * DV * 2;     // DV / kVW column blocks
  static_assert(kVBytes % 1024 == 0, "stages stay 1024-byte aligned");
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kFit = (kSmemBudget - kQBytes) / kStageBytes;
  static constexpr int kStages = kFit > 4 ? 4 : kFit;
  static_assert(kStages >= 2, "two stages must fit");
  static constexpr int kSmem =
      kQBytes + kStages * kStageBytes + 1024 + 8 * (1 + 3 * kStages);
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

template <int BQ, int BK, int DQ, int DV>
__global__ void __launch_bounds__(FaTile<BQ, BK, DQ, DV>::kThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 __nv_bfloat16* __restrict__ o,
                                 float* __restrict__ lse, int H, int KH,
                                 int Sq, int Sk, int Dv, float scale,
                                 int causal, int window, int q_offset) {
  using T = FaTile<BQ, BK, DQ, DV>;
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* qs = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* ring = qs + T::kQBytes;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + T::kStages * T::kStageBytes);
  uint64_t* full_k = qbar + 1;
  uint64_t* full_v = full_k + T::kStages;
  uint64_t* empty = full_v + T::kStages;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = b * KH + h / (H / KH);

  // The keys some row of this block may see (see the SIMT kernel).
  const int rows = min(BQ, Sq - q0);
  const int qlo = q_offset + q0, qhi = q_offset + q0 + rows - 1;
  const bool all_see = qhi - window + 1 <= Sk - 1;
  int k_begin = 0, k_end = Sk;
  if (all_see) {
    k_begin = max(0, qlo - window + 1) / BK * BK;
    if (causal) k_end = min(Sk, qhi + 1);
  }
  const int ntiles = (k_end - k_begin + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    regs_dec<24>();
    if (t == 0) {
      mbar_expect_tx(qbar, T::kQBytes);
#pragma unroll
      for (int cb = 0; cb < T::kDCB; ++cb)
        tma_load_3d(qs + cb * BQ * 128, &qmap, qbar, 64 * cb, q0, bh);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % T::kStages;
        const int k0 = k_begin + it * BK;
        mbar_wait(&empty[s], ((it / T::kStages) & 1) ^ 1);
        uint8_t* ks = ring + s * T::kStageBytes;
        uint8_t* vs = ks + T::kKBytes;
        mbar_expect_tx(&full_k[s], T::kKBytes);
#pragma unroll
        for (int cb = 0; cb < T::kDCB; ++cb)
          tma_load_3d(ks + cb * BK * 128, &kmap, &full_k[s], 64 * cb, k0, kvh);
        mbar_expect_tx(&full_v[s], T::kVBytes);
#pragma unroll
        for (int cb = 0; cb < DV / T::kVW; ++cb)
          tma_load_3d(vs + cb * BK * T::kVW * 2, &vmap, &full_v[s],
                      T::kVW * cb, k0, kvh);
      }
    }
    return;
  }

  regs_inc<240>();
  const int warp = t / 32, lane = t % 32;
  const float sl2 = scale * kLog2e;
  float acc[T::kMI][DV / 2], m[T::kMI][2], l[T::kMI][2];
#pragma unroll
  for (int i = 0; i < T::kMI; ++i) {
#pragma unroll
    for (int j = 0; j < DV / 2; ++j) acc[i][j] = 0.f;
    m[i][0] = m[i][1] = kMasked;
    l[i][0] = l[i][1] = 0.f;
  }
  const uint32_t qs_addr = smem_u32(qs);
  mbar_wait(qbar, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % T::kStages;
    const uint32_t ph = (it / T::kStages) & 1;
    const int k0 = k_begin + it * BK;
    const uint32_t ks = smem_u32(ring + s * T::kStageBytes);
    const uint32_t vs = ks + T::kKBytes;
    mbar_wait(&full_k[s], ph);
    bool v_ready = false;
#pragma unroll
    for (int i = 0; i < T::kMI; ++i) {
      const int r_lo = q0 + (wg * T::kMI + i) * 64;   // the slice's first row
      if (r_lo >= Sq) continue;
      const int slo = q_offset + r_lo;
      const int shi = q_offset + min(r_lo + 63, Sq - 1);
      if (all_see &&
          ((causal && k0 > shi) || k0 + BK - 1 <= slo - window))
        continue;   // no row of the slice sees a key of this tile

      // S = q K^T (64 x BK, f32)
      float sacc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ / 16; ++kk) {
        const uint64_t dq = make_desc(
            qs_addr + (kk / 4) * BQ * 128 + (wg * T::kMI + i) * 64 * 128 +
                (kk % 4) * 32, 16, 1024, kSw128);
        const uint64_t dk = make_desc(
            ks + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024, kSw128);
        WgmmaSS<BK>::template mma<0>(sacc, dq, dk, kk > 0 ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);

      // mask the tiles that straddle the diagonal, the window or Sk
      const int qp0 = slo + warp * 16 + lane / 4;
      if (k0 + BK > Sk || (causal && k0 + BK - 1 > slo) ||
          k0 <= shi - window) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
            const int qp = qp0 + 8 * (e >> 1);
            float x = sacc[4 * j + e];
            if (kp >= Sk)
              x = -INFINITY;   // not a key at all: weight exactly 0
            else if ((causal && kp > qp) || kp <= qp - window)
              x = kMasked;
            sacc[4 * j + e] = x;
          }
      }

      // online softmax on the fragments: rows r (e < 2) and r + 8 (e >= 2)
      float mx[2] = {m[i][0], m[i][1]};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], sacc[4 * j + e]);
      // (s - max) is formed before the scale: a row whose logits so far are
      // all masked (-1e30) must get exactly e^0 = 1 for each, as the
      // reference's -1e30 - (-1e30) does (an fma of s by the scale minus
      // the rounded max * scale would leave the rounding error, ~1e22).
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2((m[i][r] - mx[r]) * sl2);
        m[i][r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2((sacc[4 * j + e] - mx[e >> 1]) * sl2);
          sacc[4 * j + e] = p;
          rs[e >> 1] += p;
        }
      l[i][0] = l[i][0] * alpha[0] + rs[0];
      l[i][1] = l[i][1] * alpha[1] + rs[1];
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int w = 0; w < 4; ++w)
          pa[kk][w] = pack_bf16(sacc[8 * kk + 2 * w], sacc[8 * kk + 2 * w + 1]);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][4 * j + e] *= alpha[e >> 1];

      // O += P V (64 x DV)
      if (!v_ready) {
        mbar_wait(&full_v[s], ph);
        v_ready = true;
      }
      fence_regs(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = make_desc(vs + kk * 16 * T::kVW * 2,
                                      BK * T::kVW * 2, 8 * T::kVW * 2,
                                      T::kVSw);
        WgmmaRS<DV>::template mma<1>(acc[i], pa[kk], dv, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[i]);
      keep_regs(pa);
    }
    // every consumer waits for V before releasing the stage, so that the
    // producer never re-arms a barrier whose bytes are still in flight
    if (!v_ready) mbar_wait(&full_v[s], ph);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < T::kMI; ++i) {
    const int r0 = q0 + (wg * T::kMI + i) * 64 + warp * 16 + lane / 4;
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float ell = l[i][r];
      ell += __shfl_xor_sync(0xffffffffu, ell, 1);
      ell += __shfl_xor_sync(0xffffffffu, ell, 2);
      inv[r] = 1.f / fmaxf(ell, 1e-30f);
      // the row's log-sum-exp in the base-2 units of exp2's argument:
      // p = 2^(s * scale * log2 e - lse)
      const int row = r0 + 8 * r;
      if (lse != nullptr && lane % 4 == 0 && row < Sq)
        lse[static_cast<size_t>(bh) * ((Sq + kRowPad - 1) / kRowPad * kRowPad) +
            row] = m[i][r] * sl2 + log2f(ell);
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r, col = 8 * j + 2 * (lane % 4);
        if (row < Sq && col < Dv)
          *reinterpret_cast<uint32_t*>(
              o + (static_cast<size_t>(bh) * Sq + row) * Dv + col) =
              pack_bf16(acc[i][4 * j + 2 * r] * inv[r],
                        acc[i][4 * j + 2 * r + 1] * inv[r]);
      }
  }
}

template <int BQ, int BK, int DQ, int DV = DQ>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int H, int KH, int Sq, int Sk,
                         int D, int Dv, float scale, int causal, int window,
                         int q_offset, cudaStream_t stream) {
  using T = FaTile<BQ, BK, DQ, DV>;
  if (D > DQ || Dv > DV || D % 8 || Dv % 8 || !aligned(q, 16) ||
      !aligned(k, 16) || !aligned(v, 16) || !aligned(o, 4))
    return cudaErrorInvalidValue;   // what TMA cannot take
  constexpr CUtensorMapSwizzle kVMapSw =
      T::kVW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map_3d(&qmap, q, D, Sq, static_cast<uint64_t>(B) * H, 64, BQ,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&kmap, k, D, Sk, static_cast<uint64_t>(B) * KH, 64, BK,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&vmap, v, Dv, Sk, static_cast<uint64_t>(B) * KH, T::kVW,
                   BK, kVMapSw))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_wgmma_kernel<BQ, BK, DQ, DV>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), lse, H, KH, Sq, Sk,
      Dv, scale, causal, window, q_offset);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const void*, const void*, const void*, void*,
                                 float*, int, int, int, int, int, int, int,
                                 float, int, int, int, cudaStream_t);

// The tilings a call may name, by id (kernels/flash_attention.py::TILINGS
// lists the same names in the same order), with the launcher of each type
// that has one: id 0 the SIMT kernel at 64 x 64, in f32 and bf16; the
// bf16 wgmma instances; the f32 SIMT instances of the deployed configs;
// then MLA's (D 192, Dv 128) in bf16 (wgmma) and f32 (SIMT).
struct Tiling {
  const char* name;
  Launcher f32;
  Launcher bf16;
};
const Tiling kTilings[] = {
    {"simt_64x64", &simt::launch_simt<float>,
     &simt::launch_simt<__nv_bfloat16>},
    {"wgmma_bq128_bk128_d64", nullptr, &launch_wgmma<128, 128, 64>},
    {"wgmma_bq128_bk256_d64", nullptr, &launch_wgmma<128, 256, 64>},
    {"wgmma_bq256_bk128_d64", nullptr, &launch_wgmma<256, 128, 64>},
    {"wgmma_bq128_bk128_d80", nullptr, &launch_wgmma<128, 128, 80>},
    {"wgmma_bq128_bk128_d128", nullptr, &launch_wgmma<128, 128, 128>},
    {"simt_bq128_bk128_d64", &simt::launch_dp<float, 128, 128, 64>, nullptr},
    {"simt_bq256_bk64_d64", &simt::launch_dp<float, 256, 64, 64>, nullptr},
    {"simt_bq128_bk64_d128", &simt::launch_dp<float, 128, 64, 128>, nullptr},
    {"wgmma_bq128_bk128_d192_v128", nullptr,
     &launch_wgmma<128, 128, 192, 128>},
    {"simt_bq64_bk64_d192_v128", &simt::launch_dp<float, 64, 64, 192, 128>,
     nullptr},
};
constexpr int kNumTilings = sizeof(kTilings) / sizeof(kTilings[0]);

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int H, int KH, int Sq, int Sk, int D,
                     int Dv, float scale, int causal, int window, int q_offset,
                     int tiling, int dtype, cudaStream_t stream) {
  if (tiling < 0 || tiling >= kNumTilings) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Sq == 0) return cudaSuccess;
  if (KH <= 0 || H % KH != 0 || Sk <= 0 || D <= 0 || Dv <= 0 || window < 1 ||
      q_offset < 0 || B * H > 65535)
    return cudaErrorInvalidValue;
  const Launcher fn = dtype == kF32 ? kTilings[tiling].f32
                    : dtype == kBF16 ? kTilings[tiling].bf16 : nullptr;
  if (fn == nullptr) return cudaErrorInvalidValue;   // no such instance
  return fn(q, k, v, o, lse, B, H, KH, Sq, Sk, D, Dv, scale, causal, window,
            q_offset, stream);
}

}  // namespace
}  // namespace repro

// The tiling names by id, comma-separated.
extern "C" const char* repro_flash_attention_tilings() {
  static const char* names = [] {
    static char buf[1024];
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

// q: (B, H, Sq, D); k: (B, KH, Sk, D); v: (B, KH, Sk, Dv); o: (B, H, Sq,
// Dv); all contiguous, one dtype; run by the kernel of `tiling` (an id of
// repro_flash_attention_tilings()).  lse, where not null, receives each
// row's log-sum-exp (f32, (B, H, Sq rounded up to kRowPad)): wgmma
// instances only.  Returns a cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     int B, int H, int KH, int Sq, int Sk,
                                     int D, int Dv, float scale, int causal,
                                     int window, int q_offset, int tiling,
                                     int dtype, void* stream) {
  return static_cast<int>(repro::dispatch(
      q, k, v, o, lse, B, H, KH, Sq, Sk, D, Dv, scale, causal, window,
      q_offset, tiling, dtype, static_cast<cudaStream_t>(stream)));
}
