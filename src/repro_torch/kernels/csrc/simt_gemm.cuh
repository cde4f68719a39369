// The register-blocked SIMT product on the CUDA cores, shared by K3/K4
// (gemm.cu: act(A @ B)) and K2 (fused_ff.cu: silu(A @ Bg) * (A @ Bu)):
// IEEE f32 FMAs, never TF32, with f32 accumulators and one rounding to
// the inputs' type on the store.
//
// A block of 256 threads owns a BM x BN tile of C and walks K in slabs of
// 8, staged in shared memory as f32, A transposed (k-major), so that both
// are read along the tile's M or N edge as 16-byte words.  Thread (tx, ty)
// of the 16 x 16 grid keeps a (BM / 16) x (BN / 16) sub-tile of C in
// registers (twice that for the dual product): rows g * 64 + ty * 4 +
// {0..3} for each 64-row group g of the tile, columns likewise, so
// neighbouring threads read neighbouring 16-byte words and every value read
// from shared memory feeds BN / 16 (or BM / 16) FMAs.  Slabs are
// double-buffered through registers, with one barrier per slab.  Any M, K
// and N are taken: loads past an edge read 0 and stores past it are
// skipped.  kVec reads and writes 4 elements at a time (K and N multiples
// of 4, 4-element-aligned pointers).  Its ceiling is the f32 FMA rate,
// 67 TFLOP/s.
#pragma once

#include "common.cuh"

namespace repro {
namespace simt_gemm {

constexpr int kBK = 8;          // depth of one K slab
constexpr int kThreads = 256;   // 16 x 16, a (BM/16) x (BN/16) sub-tile each
constexpr int kPadA = 4;        // As row padding: stores hit distinct banks

// Four consecutive elements p[i .. i + 3] of a row of length n, as f32
// (0 past the end of the row, or for a row that does not exist).
template <typename T, bool kVec>
__device__ __forceinline__ void load4(const T* __restrict__ p, int i, int n,
                                      bool row_ok, float v[4]) {
  if constexpr (kVec) {  // n % 4 == 0 and p 4-element aligned
    if (row_ok && i < n) {
      if constexpr (sizeof(T) == 4) {
        const float4 w = *reinterpret_cast<const float4*>(p + i);
        v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
      } else {
        const uint2 w = *reinterpret_cast<const uint2*>(p + i);
        const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
        const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
        v[0] = __low2float(lo); v[1] = __high2float(lo);
        v[2] = __low2float(hi); v[3] = __high2float(hi);
      }
      return;
    }
    v[0] = v[1] = v[2] = v[3] = 0.f;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (row_ok && i + j < n) ? to_f32(p[i + j]) : 0.f;
  }
}

// Four consecutive outputs q[i .. i + 3] of a row of length n.
template <typename T, bool kVec>
__device__ __forceinline__ void store4(T* __restrict__ q, int i, int n,
                                       const float v[4]) {
  if constexpr (kVec) {
    if (i >= n) return;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(q + i) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      __nv_bfloat162 lo, hi;
      lo.x = from_f32<T>(v[0]); lo.y = from_f32<T>(v[1]);
      hi.x = from_f32<T>(v[2]); hi.y = from_f32<T>(v[3]);
      uint2 w;
      w.x = *reinterpret_cast<const unsigned*>(&lo);
      w.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(q + i) = w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i + j < n) q[i + j] = from_f32<T>(v[j]);
  }
}

// C[z] = epilogue(A[z] @ B[z]) for the batch index z = blockIdx.z.
// kDual: C = silu(A @ B) * (A @ B2) (B2 shares B's shape; no batch);
// else C = leaky ? LeakyReLU(A @ B) : A @ B.
template <typename T, bool kVec, int BM, int BN, bool kDual>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                const T* __restrict__ b2, T* __restrict__ c, int M, int K,
                int N, bool leaky, float slope) {
  static_assert(BM % 64 == 0 && BN % 64 == 0 && BM <= 256 && BN <= 256, "");
  constexpr int TM = BM / 16, TN = BN / 16;   // this thread's sub-tile
  constexpr int kAV = (2 * BM + kThreads - 1) / kThreads;   // A vectors
  constexpr int kBV = (2 * BN + kThreads - 1) / kThreads;   // B vectors
  constexpr int kNB = kDual ? 2 : 1;
  __shared__ __align__(16) float As[2][kBK][BM + kPadA];
  __shared__ __align__(16) float Bs[kNB][2][kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const size_t batch = blockIdx.z;
  a += batch * M * static_cast<size_t>(K);
  b += batch * K * static_cast<size_t>(N);
  c += batch * M * static_cast<size_t>(N);

  // This thread's share of a slab: vector v of A is row m0 + v / 2, k =
  // (v % 2) * 4 .. + 3; vector v of B is row k = v / (BN / 4), columns
  // n0 + (v % (BN / 4)) * 4 .. + 3; v = tid + 256 i, while v < 2 BM (2 BN).
  float va[kAV][4], vb[kNB][kBV][4];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAV; ++i) {
      const int v = tid + kThreads * i;
      if (v < 2 * BM) {
        const int r = v / 2, kk = (v % 2) * 4;
        load4<T, kVec>(a + static_cast<size_t>(m0 + r) * K, k0 + kk, K,
                       m0 + r < M, va[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kBV; ++i) {
      const int v = tid + kThreads * i;
      if (v < 2 * BN) {
        const int kr = v / (BN / 4), col = (v % (BN / 4)) * 4;
        const size_t off = static_cast<size_t>(k0 + kr) * N;
        load4<T, kVec>(b + off, n0 + col, N, k0 + kr < K, vb[0][i]);
        if constexpr (kDual)
          load4<T, kVec>(b2 + off, n0 + col, N, k0 + kr < K, vb[kNB - 1][i]);
      }
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAV; ++i) {
      const int v = tid + kThreads * i;
      if (v < 2 * BM) {
        const int r = v / 2, kk = (v % 2) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) As[buf][kk + j][r] = va[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < kBV; ++i) {
      const int v = tid + kThreads * i;
      if (v < 2 * BN) {
        const int kr = v / (BN / 4), col = (v % (BN / 4)) * 4;
#pragma unroll
        for (int h = 0; h < kNB; ++h)
          *reinterpret_cast<float4*>(&Bs[h][buf][kr][col]) =
              make_float4(vb[h][i][0], vb[h][i][1], vb[h][i][2], vb[h][i][3]);
      }
    }
  };

  float acc[kNB][TM][TN];
#pragma unroll
  for (int h = 0; h < kNB; ++h)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[h][i][j] = 0.f;

  const int slabs = (K + kBK - 1) / kBK;
  if (slabs > 0) {
    fetch(0);
    stage(0);
  }
  __syncthreads();
  for (int s = 0; s < slabs; ++s) {
    const int cur = s % 2;
    if (s + 1 < slabs) fetch((s + 1) * kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float ra[TM], rb[kNB][TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(&As[cur][k][g * 64 + ty * 4]);
        ra[4 * g] = v.x; ra[4 * g + 1] = v.y;
        ra[4 * g + 2] = v.z; ra[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < kNB; ++h)
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(
              &Bs[h][cur][k][g * 64 + tx * 4]);
          rb[h][4 * g] = v.x; rb[h][4 * g + 1] = v.y;
          rb[h][4 * g + 2] = v.z; rb[h][4 * g + 3] = v.w;
        }
#pragma unroll
      for (int h = 0; h < kNB; ++h)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[h][i][j] = fmaf(ra[i], rb[h][j], acc[h][i][j]);
    }
    if (s + 1 < slabs) stage(1 - cur);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (row >= M) continue;
    T* c_row = c + static_cast<size_t>(row) * N;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float y = acc[0][i][4 * g + j];
        if constexpr (kDual)
          v[j] = y / (1.f + expf(-y)) * acc[kNB - 1][i][4 * g + j];
        else
          v[j] = (leaky && !(y >= 0.f)) ? slope * y : y;
      }
      store4<T, kVec>(c_row, n0 + g * 64 + tx * 4, N, v);
    }
  }
}

// Whether the 4-element route takes these operands.
template <typename T>
inline bool vec_ok(int K, int N, const void* a, const void* b, const void* b2,
                   const void* c) {
  constexpr size_t kBytes = 4 * sizeof(T);
  return K % 4 == 0 && N % 4 == 0 && aligned(a, kBytes) &&
         aligned(b, kBytes) && (b2 == nullptr || aligned(b2, kBytes)) &&
         aligned(c, kBytes);
}

// One launch of the BM x BN kernel over `batch` products (1 for kDual);
// the 4-element route where vec_ok allows it, else the scalar one.
template <typename T, int BM, int BN, bool kDual>
cudaError_t launch(const void* a, const void* b, const void* b2, void* c,
                   int batch, int M, int K, int N, bool leaky, float slope,
                   cudaStream_t stream) {
  if (batch == 0 || M == 0 || N == 0) return cudaSuccess;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  const T* b2p = static_cast<const T*>(b2);
  T* cp = static_cast<T*>(c);
  if (vec_ok<T>(K, N, a, b, b2, c))
    gemm_kernel<T, true, BM, BN, kDual><<<grid, kThreads, 0, stream>>>(
        ap, bp, b2p, cp, M, K, N, leaky, slope);
  else
    gemm_kernel<T, false, BM, BN, kDual><<<grid, kThreads, 0, stream>>>(
        ap, bp, b2p, cp, M, K, N, leaky, slope);
  return cudaGetLastError();
}

}  // namespace simt_gemm
}  // namespace repro
