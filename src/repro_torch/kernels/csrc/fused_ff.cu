// Fused SwiGLU front half: out = silu(X @ Wg) * (X @ Wu), with f32
// accumulation and an f32 epilogue, written in X's type.
//
// Replaces the TPU kernel src/repro/kernels/fused_ff.py::_kernel (its
// pl.pallas_call is in fused_ff() at fused_ff.py:48), which walks a
// sequential K grid axis with two f32 accumulators in VMEM and needs
// M, N, K to be multiples of its tiles.  This kernel takes any M, K, N:
// rows past M, columns past N and the K tail are masked.
//
// What bounds it on an H100: bytes, at decode.  X is (M, K), Wg and Wu
// are (K, N) row-major.  At the serving path's shape (M = 8 lanes,
// K = 2560, N = 6912, bf16) the two weight matrices are 70.8 MB, 21 us at
// 3.35 TB/s, while the 0.57 GFLOP take 0.6 us at the bf16 tensor-core
// peak.  So the kernel must read every weight byte exactly once, with
// coalesced loads, and can do its arithmetic on the ordinary FMA units.
//
// Design: block (bx, by) owns kBN = 64 output columns for kBM = 8 rows of
// X.  Each of a warp's 32 lanes owns two adjacent columns, so one load
// instruction of a warp reads 128 contiguous bytes of a bf16 weight row
// (256 of an f32 one); the block's 8 warps split K (warp w takes the rows
// k = w, w + 8, ...), and each thread keeps both accumulators for its
// 2 columns x 8 rows (32 floats) in registers.  X is staged in shared
// memory as f32, a tile of kBK rows of K at a time, and read as a
// broadcast.  At the end the 8 warps' partial sums are added in shared
// memory in a fixed order (so the result is deterministic) and the
// epilogue g * sigmoid(g) * u runs in f32 and casts once.  f32 inputs use
// IEEE f32 FMAs, never TF32.
//
// The X tile is as large as static shared memory allows (512 rows of K,
// so 5 barriers at K = 2560) and the K loop is unrolled 8 deep.
//
// Known limits, for later work.  Measured on an H100 (700 W) at the path's
// shape, bf16 runs at about a tenth of the memory rate while f32, with the
// same structure and 8-byte loads, moves three times the bytes per second:
// 4-byte loads per lane keep too few bytes in flight.  16-byte loads (8
// columns a lane) with K split across blocks, and more than 108 blocks for
// the 132 SMs, are the next step; for M > 8 every chunk of 8 rows re-reads
// the weights (prefill would want wgmma tiles fed by TMA instead).

#include "common.cuh"

namespace repro {
namespace {

constexpr int kBN = 64;                  // output columns per block
constexpr int kBM = 8;                   // rows of X per block
constexpr int kWarps = 8;                // warps splitting K
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 512;                 // K rows of X staged per tile

// Weight elements n and n + 1 of one row, as f32 (0 past N).
template <typename T, bool kVec>
__device__ __forceinline__ void load_pair(const T* __restrict__ row, int n,
                                          int N, float& a, float& b) {
  if constexpr (kVec) {  // N even and row 2-element aligned: n < N => n + 1 < N
    if (n < N) {
      if constexpr (sizeof(T) == 4) {
        const float2 v = *reinterpret_cast<const float2*>(row + n);
        a = v.x;
        b = v.y;
      } else {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(row + n);
        a = __low2float(v);
        b = __high2float(v);
      }
    } else {
      a = b = 0.f;
    }
  } else {
    a = n < N ? to_f32(row[n]) : 0.f;
    b = n + 1 < N ? to_f32(row[n + 1]) : 0.f;
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    fused_ff_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                    const T* __restrict__ wu, T* __restrict__ out, int M,
                    int K, int N) {
  __shared__ float xs[kBM][kBK];                  // 16 KB
  __shared__ float red[2][kWarps][kBM][kBN];      // 32 KB: 48 KB in all
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * kBM;
  const int n = blockIdx.x * kBN + 2 * lane;      // this lane's first column

  float ag[kBM][2], au[kBM][2];
#pragma unroll
  for (int m = 0; m < kBM; ++m) ag[m][0] = ag[m][1] = au[m][0] = au[m][1] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int m = i / kBK, k = i % kBK;
      xs[m][k] = (m0 + m < M && k0 + k < K)
                     ? to_f32(x[static_cast<size_t>(m0 + m) * K + k0 + k])
                     : 0.f;
    }
    __syncthreads();
    const int kend = min(kBK, K - k0);
#pragma unroll 8
    for (int k = warp; k < kend; k += kWarps) {
      const size_t off = static_cast<size_t>(k0 + k) * N;
      float g0, g1, u0, u1;
      load_pair<T, kVec>(wg + off, n, N, g0, g1);
      load_pair<T, kVec>(wu + off, n, N, u0, u1);
#pragma unroll
      for (int m = 0; m < kBM; ++m) {
        const float xv = xs[m][k];
        ag[m][0] = fmaf(xv, g0, ag[m][0]);
        ag[m][1] = fmaf(xv, g1, ag[m][1]);
        au[m][0] = fmaf(xv, u0, au[m][0]);
        au[m][1] = fmaf(xv, u1, au[m][1]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kBM; ++m) {
    red[0][warp][m][2 * lane] = ag[m][0];
    red[0][warp][m][2 * lane + 1] = ag[m][1];
    red[1][warp][m][2 * lane] = au[m][0];
    red[1][warp][m][2 * lane + 1] = au[m][1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int m = i / kBN, c = i % kBN;
    const int row = m0 + m, col = blockIdx.x * kBN + c;
    if (row >= M || col >= N) continue;
    float g = 0.f, u = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      g += red[0][w][m][c];
      u += red[1][w][m][c];
    }
    out[static_cast<size_t>(row) * N + col] = from_f32<T>(g / (1.f + expf(-g)) * u);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wg, const void* wu, void* out,
                   int M, int K, int N, cudaStream_t stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  const bool vec = N % 2 == 0 && aligned(wg, 2 * sizeof(T)) &&
                   aligned(wu, 2 * sizeof(T));
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(wg);
  const T* up = static_cast<const T*>(wu);
  T* op = static_cast<T*>(out);
  if (vec)
    fused_ff_kernel<T, true><<<grid, kThreads, 0, stream>>>(xp, gp, up, op, M, K, N);
  else
    fused_ff_kernel<T, false><<<grid, kThreads, 0, stream>>>(xp, gp, up, op, M, K, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x: (M, K); wg, wu: (K, N); out: (M, N); all contiguous, one dtype.
// Returns a cudaError_t.
extern "C" int repro_fused_ff(const void* x, const void* wg, const void* wu,
                              void* out, int M, int K, int N, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return repro::launch<float>(x, wg, wu, out, M, K, N, s);
    case repro::kBF16:
      return repro::launch<__nv_bfloat16>(x, wg, wu, out, M, K, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
