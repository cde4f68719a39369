// Batched, strided matrix product with f32 accumulation and an optional
// LeakyReLU epilogue: C[b] = act(A[b] @ B[b]), written in the inputs' type.
//
// Replaces two TPU kernels:
//   src/repro/kernels/matmul_leakyrelu.py::_kernel (its pl.pallas_call is
//     in matmul_leakyrelu() at matmul_leakyrelu.py:52): LeakyReLU(A @ B);
//   src/repro/kernels/bmm.py::_kernel (pl.pallas_call in bmm() at bmm.py:41):
//     a batch of A @ B.
// Both walk a sequential K grid axis with an f32 (bm, bn) accumulator in
// VMEM, apply their epilogue on the last K step and need M, N, K to be
// multiples of their tiles.  Here the K loop runs inside a block, the
// accumulator lives in registers, and any M, N, K is taken: loads past an
// edge read 0 and stores past it are skipped.  The wrappers keep the
// reference's divisibility contract.
//
// What bounds it on an H100.  At the paths' shapes, bf16:
//   K3 8192x2560 . 2560x6912: 290 GFLOP, 0.293 ms at the 989 TFLOP/s
//      tensor-core peak, against 190 MB, 0.057 ms at 3.35 TB/s: operations;
//   K4 (20, 2048, 128) . (20, 128, 2048): 21.5 GFLOP, 0.022 ms, against
//      189 MB, 0.056 ms: bytes (the 168 MB output dominates; K = 128 gives
//      a tile only one or two K stages, so its time rides on the stores).
//
// Two kernels, chosen per call by the tiling id the wrapper passes (the
// wrapper's select_tiling maps the dtype, the shape and the deployed
// config's bm/bn/bk to an id of kTilings below):
//
// wgmma_bm*_bn*_bk* — bf16 on the tensor cores, one instance per block
// shape a deployed config names: the persistent TMA / wgmma GEMM of
// wgmma_gemm.cuh (its note says how it works), with the plain epilogue and
// its tiles walked columns fastest, then rows, then the batch (group 1).
// The epilogue applies LeakyReLU to the f32 sum (y >= 0 ? y : slope * y,
// the reference's where) and rounds once to bf16.  K4 is bound by its
// stores, which the persistent grid overlaps with the next tile's loads
// and products (PERF.md holds the times of both grids).  With two
// consumer warpgroups the producer gives its registers to them
// (setmaxnreg: 40 and 232 of the 168 a thread starts with).  TMA needs
// 16-byte-aligned rows, so this route takes K and N multiples of 8 and
// 16-byte-aligned pointers.
//
// simt_128x128x8 — f32 (IEEE FMAs, never TF32: the reference's test holds
// f32 results to 2e-5 at K = 256, which TF32's 10-bit mantissa cannot
// meet), and bf16 shapes TMA cannot take (K or N not a multiple of 8).
// The register-blocked SIMT product: a block of 256 threads owns a 128 x
// 128 tile of C and walks K in slabs of 8, staged in shared memory as f32,
// A transposed (k-major), so that both are read along the tile's M or N
// edge as 16-byte words.  Thread (tx, ty) of the 16 x 16 grid keeps an 8 x
// 8 sub-tile of C in registers: rows ty*4 + {0..3} and 64 + ty*4 +
// {0..3}, columns likewise, so neighbouring threads read neighbouring
// 16-byte words and every value read from shared memory feeds 8 FMAs.
// Slabs are double-buffered through registers, with one barrier per slab.
// Its ceiling is the f32 FMA rate, 67 TFLOP/s.

#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace repro {
namespace {


constexpr int kBM = 128;       // rows of C per block
constexpr int kBN = 128;       // columns of C per block
constexpr int kBK = 8;         // depth of one K slab
constexpr int kThreads = 256;  // 16 x 16, an 8 x 8 sub-tile each
constexpr int kPadA = 4;       // As row padding: stores hit distinct banks

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

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ c, int M, int K, int N, bool leaky,
                float slope) {
  __shared__ __align__(16) float As[2][kBK][kBM + kPadA];
  __shared__ __align__(16) float Bs[2][kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const size_t batch = blockIdx.z;
  a += batch * M * static_cast<size_t>(K);
  b += batch * K * static_cast<size_t>(N);
  c += batch * M * static_cast<size_t>(N);

  // This thread's share of a slab: A row m0 + ar, k = ak .. ak + 3;
  // B row k = bk_, columns n0 + bn .. bn + 3.
  const int ar = tid / 2, ak = (tid % 2) * 4;
  const int bk_ = tid / 32, bn = (tid % 32) * 4;
  const bool a_row_ok = m0 + ar < M;
  const T* a_row = a + static_cast<size_t>(m0 + ar) * K;
  float va[4], vb[4];

  auto fetch = [&](int k0) {
    load4<T, kVec>(a_row, k0 + ak, K, a_row_ok, va);
    load4<T, kVec>(b + static_cast<size_t>(k0 + bk_) * N, n0 + bn, N,
                   k0 + bk_ < K, vb);
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) As[buf][ak + j][ar] = va[j];
    *reinterpret_cast<float4*>(&Bs[buf][bk_][bn]) =
        make_float4(vb[0], vb[1], vb[2], vb[3]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

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
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
      const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    if (s + 1 < slabs) stage(1 - cur);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
    T* c_row = c + static_cast<size_t>(row) * N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float y = acc[i][half * 4 + j];
        v[j] = (leaky && !(y >= 0.f)) ? slope * y : y;
      }
      store4<T, kVec>(c_row, n0 + half * 64 + tx * 4, N, v);
    }
  }
}

template <typename T>
cudaError_t launch_simt(const void* a, const void* b, void* c, int batch,
                        int M, int K, int N, bool leaky, float slope,
                        cudaStream_t stream) {
  if (batch == 0 || M == 0 || N == 0) return cudaSuccess;
  constexpr size_t kVecBytes = 4 * sizeof(T);
  const bool vec = K % 4 == 0 && N % 4 == 0 && aligned(a, kVecBytes) &&
                   aligned(b, kVecBytes) && aligned(c, kVecBytes);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* cp = static_cast<T*>(c);
  if (vec)
    gemm_kernel<T, true><<<grid, kThreads, 0, stream>>>(ap, bp, cp, M, K, N,
                                                        leaky, slope);
  else
    gemm_kernel<T, false><<<grid, kThreads, 0, stream>>>(ap, bp, cp, M, K, N,
                                                         leaky, slope);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// wgmma: bf16 on the tensor cores (the persistent GEMM of wgmma_gemm.cuh)
// ---------------------------------------------------------------------------

template <int BM, int BN, int BK>
cudaError_t launch_wgmma(const void* a, const void* b, void* c, int batch,
                         int M, int K, int N, bool leaky, float slope,
                         cudaStream_t stream) {
  return launch_wgmma_gemm<BM, BN, BK, false>(a, b, nullptr, c, batch, M, K,
                                              N, leaky, slope, 1, stream);
}

using Launcher = cudaError_t (*)(const void*, const void*, void*, int, int,
                                 int, int, bool, float, cudaStream_t);

// The tilings a call may name, by id (kernels/matmul_leakyrelu.py::TILINGS
// lists the same names in the same order).  Id 0 is the SIMT kernel, in
// f32 or bf16; every other id a bf16 wgmma instance.
struct Tiling {
  const char* name;
  Launcher bf16;
};
const Tiling kTilings[] = {
    {"simt_128x128x8", &launch_simt<__nv_bfloat16>},
    {"wgmma_bm128_bn128_bk128", &launch_wgmma<128, 128, 128>},
    {"wgmma_bm128_bn128_bk64", &launch_wgmma<128, 128, 64>},
    {"wgmma_bm64_bn128_bk128", &launch_wgmma<64, 128, 128>},
    {"wgmma_bm128_bn256_bk64", &launch_wgmma<128, 256, 64>},
    {"wgmma_bm256_bn128_bk64", &launch_wgmma<256, 128, 64>},
    {"wgmma_bm64_bn64_bk128", &launch_wgmma<64, 64, 128>},
    {"wgmma_bm256_bn64_bk64", &launch_wgmma<256, 64, 64>},
    {"wgmma_bm64_bn128_bk64", &launch_wgmma<64, 128, 64>},
    {"wgmma_bm64_bn64_bk64", &launch_wgmma<64, 64, 64>},
};
constexpr int kNumTilings = sizeof(kTilings) / sizeof(kTilings[0]);

cudaError_t dispatch(const void* a, const void* b, void* c, int batch, int M,
                     int K, int N, bool leaky, float slope, int tiling,
                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiling < 0 || tiling >= kNumTilings) return cudaErrorInvalidValue;
  if (batch == 0 || M == 0 || N == 0) return cudaSuccess;
  if (dtype == kF32) {
    if (tiling != 0) return cudaErrorInvalidValue;   // f32 is SIMT only
    return launch_simt<float>(a, b, c, batch, M, K, N, leaky, slope, s);
  }
  if (dtype != kBF16) return cudaErrorInvalidValue;
  if (tiling != 0 && (K == 0 || K % 8 || N % 8 || !aligned(a, 16) ||
                      !aligned(b, 16) || !aligned(c, 16)))
    return cudaErrorInvalidValue;   // what TMA cannot take
  return kTilings[tiling].bf16(a, b, c, batch, M, K, N, leaky, slope, s);
}

}  // namespace
}  // namespace repro

// The tiling names by id, comma-separated.
extern "C" const char* repro_gemm_tilings() {
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

// a: (M, K); b: (K, N); out: (M, N); contiguous, one dtype.
// out = where(y >= 0, y, negative_slope * y) for y = a @ b in f32, by the
// kernel of `tiling` (an id of repro_gemm_tilings()).
// Returns a cudaError_t.
extern "C" int repro_matmul_leakyrelu(const void* a, const void* b, void* out,
                                      int M, int K, int N,
                                      float negative_slope, int tiling,
                                      int dtype, void* stream) {
  return static_cast<int>(repro::dispatch(a, b, out, 1, M, K, N, true,
                                          negative_slope, tiling, dtype,
                                          stream));
}

// a: (B, M, K); b: (B, K, N); out: (B, M, N); contiguous, one dtype.
// Returns a cudaError_t.
extern "C" int repro_bmm(const void* a, const void* b, void* out, int B, int M,
                         int K, int N, int tiling, int dtype, void* stream) {
  return static_cast<int>(repro::dispatch(a, b, out, B, M, K, N, false, 1.f,
                                          tiling, dtype, stream));
}
