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
// that sees no key gets the mean of v), l is floored at 1e-30, and q is
// scaled before the product.  Any Sq, Sk and D <= 128 are taken: rows past
// Sq, keys past Sk and head dims past D are masked.
//
// What bounds it on an H100: operations.  At the training path's shape
// (stablelm-3b: B 4, H 32, S 2048, D 80, causal, bf16) a call does 85.9
// GFLOP, 0.087 ms at the bf16 tensor-core peak, against 168 MB of q, k, v
// and o, 0.05 ms at 3.35 TB/s.  This first version does its arithmetic on
// the f32 FMA units (67 TFLOP/s peak), so it cannot come within 15x of
// that bound; moving the two products onto wgmma is later work.
//
// Design: one block of 256 threads per (b*h, tile of 64 query rows);
// blocks take the query tiles from the last to the first, so the longest
// causal rows start first.  The q tile is staged once in shared memory as
// f32 (already scaled); each 64-key tile of K (transposed) and V is staged
// as f32 in turn.  Thread (ty, tx) of a 16 x 16 grid owns a 4 x 4 patch of
// the 64 x 64 logits (rows 4ty..4ty+3, keys tx + 16j), reading q as
// float4 and K^T along consecutive keys, so neither read conflicts on a
// bank.  The row max and row sum are reduced over the 16 lanes that share
// a row with warp shuffles; the probabilities go through shared memory to
// the P V product, where the same thread owns rows 4ty..4ty+3 and head
// dims tx + 16c, with (m, l, acc) in registers.  Only the key tiles that
// some row of the block may see are visited: with every row seeing at
// least one key, tiles above the causal diagonal and tiles behind the
// window are skipped (their logits would be masked for every row and
// contribute exactly 0).  f32 inputs use IEEE f32 FMAs, never TF32, and
// the sums run in a fixed order, so a result is deterministic.

#include <math.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // a 16 x 16 grid of threads
constexpr int kKP = kBK + 1;     // pitch of K^T rows (conflict-free stores)
constexpr int kPP = kBK + 4;     // pitch of the probability rows
constexpr float kNeg = -1e30f;   // the logit of a masked key

// floats of shared memory for head dims padded to DP
constexpr int smem_floats(int DP) {
  return kBQ * (DP + 4) + DP * kKP + kBK * DP + kBQ * kPP;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int H,
                           int KH, int Sq, int Sk, int D, float scale,
                           int causal, int window, int q_offset) {
  constexpr int QP = DP + 4;     // pitch of q rows: 16-byte aligned, and
                                 // rows 4 apart fall in other banks
  constexpr int NC = DP / 16;    // head dims per thread in P V
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kBQ][QP]
  float* kt = qs + kBQ * QP;                     // [DP][kKP]
  float* vs = kt + DP * kKP;                     // [kBK][DP]
  float* ps = vs + kBK * DP;                     // [kBQ][kPP]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = b * KH + h / (H / KH);
  const int rows = min(kBQ, Sq - q0);
  const T* qp = q + (static_cast<size_t>(bh) * Sq + q0) * D;
  const T* kp = k + static_cast<size_t>(kvh) * Sk * D;
  const T* vp = v + static_cast<size_t>(kvh) * Sk * D;
  T* op = o + (static_cast<size_t>(bh) * Sq + q0) * D;

  for (int i = tid; i < kBQ * DP; i += kThreads) {
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
    k_begin = max(0, qlo - window + 1) / kBK * kBK;
    if (causal) k_end = min(Sk, qhi + 1);
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile's K, V and P are read
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int c = i / DP, d = i % DP;
      const bool in = k0 + c < Sk && d < D;
      const size_t g = static_cast<size_t>(k0 + c) * D + d;
      kt[d * kKP + c] = in ? to_f32(kp[g]) : 0.f;
      vs[c * DP + d] = in ? to_f32(vp[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(4 * ty + i) * QP + d]);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        float kv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = kt[(d + dd) * kKP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float qd = dd == 0 ? qv[i].x : dd == 1 ? qv[i].y
                         : dd == 2 ? qv[i].z : qv[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qd, kv[j], s[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_offset + q0 + 4 * ty + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mx);
        ps[(4 * ty + i) * kPP + tx + 16 * j] = p;
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
    for (int key = 0; key < kBK; ++key) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * kPP + key];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[key * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
    const float ell = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) op[static_cast<size_t>(r) * D + d] = from_f32<T>(acc[i][c] / ell);
    }
  }
}

template <typename T, int DP>
cudaError_t launch_dp(const void* q, const void* k, const void* v, void* o,
                      int B, int H, int KH, int Sq, int Sk, int D,
                      float scale, int causal, int window, int q_offset,
                      cudaStream_t stream) {
  const size_t smem = smem_floats(DP) * sizeof(float);
  auto kernel = flash_attention_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, Sq, Sk, D, scale,
      causal, window, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KH, int Sq, int Sk, int D, float scale,
                   int causal, int window, int q_offset, cudaStream_t stream) {
  if (B == 0 || H == 0 || Sq == 0) return cudaSuccess;
  if (KH <= 0 || H % KH != 0 || Sk <= 0 || D <= 0 || window < 1 ||
      q_offset < 0 || B * H > 65535)
    return cudaErrorInvalidValue;
  if (D <= 32)
    return launch_dp<T, 32>(q, k, v, o, B, H, KH, Sq, Sk, D, scale, causal,
                            window, q_offset, stream);
  if (D <= 64)
    return launch_dp<T, 64>(q, k, v, o, B, H, KH, Sq, Sk, D, scale, causal,
                            window, q_offset, stream);
  if (D <= 80)
    return launch_dp<T, 80>(q, k, v, o, B, H, KH, Sq, Sk, D, scale, causal,
                            window, q_offset, stream);
  if (D <= 128)
    return launch_dp<T, 128>(q, k, v, o, B, H, KH, Sq, Sk, D, scale, causal,
                             window, q_offset, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// q, o: (B, H, Sq, D); k, v: (B, KH, Sk, D); all contiguous, one dtype.
// Returns a cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int KH, int Sq, int Sk, int D,
                                     float scale, int causal, int window,
                                     int q_offset, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return repro::launch<float>(q, k, v, o, B, H, KH, Sq, Sk, D, scale,
                                  causal, window, q_offset, s);
    case repro::kBF16:
      return repro::launch<__nv_bfloat16>(q, k, v, o, B, H, KH, Sq, Sk, D,
                                          scale, causal, window, q_offset, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
