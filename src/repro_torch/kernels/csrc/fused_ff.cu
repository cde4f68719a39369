// Fused SwiGLU front half: out = silu(X @ Wg) * (X @ Wu), with two f32
// accumulators and an f32 epilogue (g / (1 + expf(-g)) * u), written in
// X's type with one rounding.
//
// Replaces the TPU kernel src/repro/kernels/fused_ff.py::_kernel (its
// pl.pallas_call is in fused_ff() at fused_ff.py:48), which walks a
// sequential K grid axis with two f32 (bm, bn) accumulators in VMEM and
// needs M, N, K to be multiples of its tiles.  This file takes any M, K,
// N; the wrapper keeps the reference's divisibility contract.
//
// What bounds it on an H100.  X is (M, K), Wg and Wu are (K, N)
// row-major; at the model paths' K = 2560, N = 6912 in bf16 the two
// weights are 70.8 MB:
//   decode (M = 8 lanes): 70.9 MB, 21.2 us at 3.35 TB/s, against 0.57
//     GFLOP, 0.6 us at the tensor-core peak: bytes.  Every weight byte
//     must be read once, from enough SMs to draw the memory rate.
//   training (M = 8192): 580 GFLOP, 0.586 ms at 989 TFLOP/s, against
//     184 MB, 0.055 ms: operations.  The tensor cores, fed without
//     re-reading the weights for every few rows.
//
// Four routes, chosen per call by the tiling id the wrapper passes (its
// select_tiling maps the dtype, the shape and the deployed bm/bn/bk to a
// name of kTilings below):
//
// wgmma_bm*_bn*_bk* — bf16 with M above the decode threshold (8): the
// persistent TMA / wgmma GEMM of wgmma_gemm.cuh with its dual epilogue
// (its note says how it works).  Each stage holds the A tile and both
// weights' tiles (A + 2B: 96 KB at bk = 128, so 2 stages beside the C
// tile; 48 KB at bk = 64, 4 stages); each consumer warpgroup owns 64 rows
// by 128 columns of the output and runs one m64 x 256 chain over the
// gate's and the up weight's 128 columns, 128 f32 accumulators a thread;
// silu(g) * u runs on them in registers and one TMA store writes the bf16
// tile.  Tiles are walked in bands of 8 row tiles (rows fastest), so
// that the 132 tiles in flight read about 8 row tiles of X and 17 column
// tiles of the weights: the weights (70.8 MB, more than the 50 MB L2)
// come from memory once a band, not once every two row tiles.  One
// instance per block shape a deployed config names: (128, 128, 128),
// (128, 128, 64) (two warpgroups along M) and (64, 256, 64) (two along
// N).  The config (256, 128, 64) would hold 2 x 256 x 128 f32
// accumulators, the whole register file: it runs the (128, 128, 64)
// instance, its 256-row block as two 128-row tiles one after another in
// the walk.  ptxas (sm_90a, `python -m repro_torch.kernels._build
// --ptxas`) gives each of the three 168 registers a thread (the 384-thread
// kernel's allocation; setmaxnreg moves none of it) and no spills.  On the
// H100 (700 W) bk 64 ran fastest at 8192 x 2560 . 2560 x 6912, below the
// cuBLAS composite (PERF.md): 4 stages of 48 KB keep more loads in flight
// than 2 of 96 KB, so it is the default for calls that name no config.
//
// gemv_m1, _m2, _m4, _m8 — M <= 8 rows, f32 or bf16 (the serving path's
// decode): a split-K product on the CUDA cores, then a reduction pass.
// A block of 4 warps owns 16 vectors of 16 bytes (8 bf16 or 4 f32
// columns) of each weight: lanes 0-15 of a warp read Wg's, lanes 16-31
// Wu's, so one load instruction reads 256 contiguous bytes of each; its
// 4 warps split the block's slice of K by rows, each thread keeping the
// f32 sums of its vector's columns for every row of X (held in shared
// memory as f32, transposed, and read as a broadcast 16 bytes at a time),
// with 8 rows' loads in flight.  K is split into slices across
// blockIdx.y.  The wrapper's gemv_splits gives the most slices the
// workspace holds (10 at the decode shape, about four blocks an SM); the
// launcher takes the smaller of that and one wave of the card, from the
// occupancy API: on 132 SMs holding 4 blocks each, 9 slices of 285 rows,
// 486 blocks, at the decode shape.  Each block adds its 4 warps' sums in
// warp order and writes its slice's partial g and u to a workspace; the
// reduction pass adds the slices in order for every output, then applies
// silu(g) * u in f32 and rounds once.  No float atomics: the result is
// deterministic.  The instance is the smallest of 1, 2, 4, 8 rows that
// holds M (rows past M are zero and not stored).  Weights must be 16-byte
// aligned with N a multiple of the vector.  ptxas: 128, 78, 50 and 56
// registers (m8, m4, m2, m1) in bf16, 78, 55, 43 and 48 in f32, no spills.
// At M = 8 in bf16 the 64 FMAs each 16-byte load feeds keep it below the
// memory rate (PERF.md); tensor-core fragments fed through shared memory
// are the next step.
//
// simt_bm*_bn*_bk8 — f32 with M above the threshold (IEEE FMAs, never
// TF32), one instance per block shape (bm, bn) a deployed config names:
// the register-blocked SIMT product of simt_gemm.cuh in its dual form
// (the gate's and the up weight's sums side by side, silu(g) * u on them
// in registers), with the config's bm x bn tile of the output.  The K
// slab stays 8 deep whatever bk names (as K3's, gemm.cu), and (256, 128,
// 64) runs the (128, 128) instance: a 256 x 128 dual tile would hold 256
// f32 accumulators a thread, past the register file.  This route takes K
// and N multiples of 4 and 16-byte-aligned tensors.  ptxas (sm_90a): 220
// and 224 registers, no spills.
//
// simt_8x64 — what the others cannot take (bf16 with K or N not a
// multiple of 8 above the threshold, f32 with K or N not a multiple of 4
// or unaligned tensors above it, a ragged or unaligned weight row at
// decode).  Block (bx, by) owns 64 output columns for 8 rows of X: each
// lane owns two adjacent columns, the 8 warps split K, X is staged in
// shared memory as f32, and the warps' partial sums are added in a fixed
// order.  Every 8-row block re-reads both weights, so it is slow at large
// M (33.5 ms at the training shape in bf16, PERF.md).

#include "common.cuh"
#include "simt_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace repro {
namespace {

// ---------------------------------------------------------------------------
// simt_8x64
// ---------------------------------------------------------------------------

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
cudaError_t launch_simt_t(const void* x, const void* wg, const void* wu,
                          void* out, int M, int K, int N,
                          cudaStream_t stream) {
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

// ---------------------------------------------------------------------------
// gemv_m*: split-K at decode
// ---------------------------------------------------------------------------

constexpr int kGvWarps = 4;                   // warps splitting a K slice
constexpr int kGvThreads = kGvWarps * 32;
constexpr int kGvChunk = 256;                 // K rows of X staged at a time
constexpr int kRdThreads = 256;               // the reduction pass's blocks

template <typename T, int R>
__global__ void __launch_bounds__(kGvThreads)
    gemv_split_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                      const T* __restrict__ wu, float* __restrict__ part,
                      int M, int K, int N, int kslice) {
  constexpr int V = 16 / sizeof(T);           // columns a 16-byte vector
  constexpr int kBC = 16 * V;                 // columns of each weight a block
  __shared__ __align__(16) float xs[kGvChunk][R];   // X^T: a row k's R values
  __shared__ float red[kGvWarps][R][2 * kBC];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * kBC + (lane % 16) * V;   // this lane's columns
  const T* w = lane < 16 ? wg : wu;
  const int k0 = blockIdx.y * kslice, k1 = min(K, k0 + kslice);

  float acc[R][V];
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[m][v] = 0.f;

  for (int kc = k0; kc < k1; kc += kGvChunk) {
    const int kn = min(kGvChunk, k1 - kc);
    for (int i = threadIdx.x; i < R * kGvChunk; i += kGvThreads) {
      const int m = i / kGvChunk, k = i % kGvChunk;
      xs[k][m] = (m < M && k < kn)
                     ? to_f32(x[static_cast<size_t>(m) * K + kc + k])
                     : 0.f;
    }
    __syncthreads();
    if (n < N) {   // N is a multiple of V: the whole vector is in the row
      const uint4* wp = reinterpret_cast<const uint4*>(
          w + static_cast<size_t>(kc + warp) * N + n);
      const size_t step = static_cast<size_t>(kGvWarps) * N / V;
      // 8 rows deep: 8 loads of 16 bytes in flight a thread
#pragma unroll 8
      for (int k = warp; k < kn; k += kGvWarps, wp += step) {
        const uint4 raw = __ldg(wp);
        const T* e = reinterpret_cast<const T*>(&raw);
        float xv[R];
        if constexpr (R % 4 == 0) {
#pragma unroll
          for (int q = 0; q < R / 4; ++q) {
            const float4 t = reinterpret_cast<const float4*>(xs[k])[q];
            xv[4 * q] = t.x; xv[4 * q + 1] = t.y;
            xv[4 * q + 2] = t.z; xv[4 * q + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int m = 0; m < R; ++m) xv[m] = xs[k][m];
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float wf = to_f32(e[v]);
#pragma unroll
          for (int m = 0; m < R; ++m) acc[m][v] = fmaf(xv[m], wf, acc[m][v]);
        }
      }
    }
    __syncthreads();
  }

  // the slice's sums: the 4 warps' added in warp order
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v) red[warp][m][lane * V + v] = acc[m][v];
  __syncthreads();
  const size_t mn = static_cast<size_t>(M) * N;
  for (int i = threadIdx.x; i < R * 2 * kBC; i += kGvThreads) {
    const int m = i / (2 * kBC), c = i % (2 * kBC);
    const int h = c / kBC, col = blockIdx.x * kBC + c % kBC;   // h 1: Wu
    if (m >= M || col >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kGvWarps; ++wi) s += red[wi][m][c];
    part[(2 * static_cast<size_t>(blockIdx.y) + h) * mn +
         static_cast<size_t>(m) * N + col] = s;
  }
}

// out = silu(g) * u of the slices' partial sums, added in slice order.
template <typename T>
__global__ void __launch_bounds__(kRdThreads)
    gemv_reduce_kernel(const float* __restrict__ part, T* __restrict__ out,
                       int M, int N, int splits) {
  const size_t mn = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * kRdThreads + threadIdx.x;
  if (i >= mn) return;
  float g = 0.f, u = 0.f;
  for (int s = 0; s < splits; ++s) {
    g += part[2 * s * mn + i];
    u += part[(2 * s + 1) * mn + i];
  }
  out[i] = from_f32<T>(g / (1.f + expf(-g)) * u);
}

// K is cut into as many slices as one wave of the card holds beside the
// column blocks (at most `max_splits`, what the workspace holds): a second
// wave for a few blocks would double the time.
template <typename T, int R>
cudaError_t launch_gemv_t(const void* x, const void* wg, const void* wu,
                          void* out, float* work, int M, int K, int N,
                          int max_splits, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (M > R || max_splits < 1 || N % V || !aligned(wg, 16) ||
      !aligned(wu, 16) || work == nullptr)
    return cudaErrorInvalidValue;
  auto kernel = gemv_split_kernel<T, R>;
  static int per_sm = 0, sms = 0;   // blocks an SM holds, SMs: per instance
  if (per_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kGvThreads, 0);
    if (err != cudaSuccess) return err;
  }
  const int cols = (N + 16 * V - 1) / (16 * V);
  const int wave = per_sm * sms / cols;
  const int splits = wave < 1 ? 1 : wave < max_splits ? wave : max_splits;
  const int kslice = (K + splits - 1) / splits;
  kernel<<<dim3(cols, splits), kGvThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), work, M, K, N, kslice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long mn = static_cast<long long>(M) * N;
  gemv_reduce_kernel<T><<<static_cast<int>((mn + kRdThreads - 1) / kRdThreads),
                          kRdThreads, 0, stream>>>(work, static_cast<T*>(out),
                                                   M, N, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the instances
// ---------------------------------------------------------------------------

// Bands of row tiles in the wgmma walk (wgmma_gemm.cuh: tile_coords).
constexpr int kGroupM = 8;

using Launcher = cudaError_t (*)(const void*, const void*, const void*, void*,
                                 float*, int, int, int, int, int,
                                 cudaStream_t);

cudaError_t launch_simt(const void* x, const void* wg, const void* wu,
                        void* out, float*, int M, int K, int N, int,
                        int dtype, cudaStream_t stream) {
  if (dtype == kF32)
    return launch_simt_t<float>(x, wg, wu, out, M, K, N, stream);
  return launch_simt_t<__nv_bfloat16>(x, wg, wu, out, M, K, N, stream);
}

template <int BM, int BN>
cudaError_t launch_simt_block(const void* x, const void* wg, const void* wu,
                              void* out, float*, int M, int K, int N, int,
                              int dtype, cudaStream_t stream) {
  if (dtype != kF32 || !simt_gemm::vec_ok<float>(K, N, x, wg, wu, out))
    return cudaErrorInvalidValue;   // f32 on 4-element loads only
  return simt_gemm::launch<float, BM, BN, true>(x, wg, wu, out, 1, M, K, N,
                                                false, 1.f, stream);
}

template <int R>
cudaError_t launch_gemv(const void* x, const void* wg, const void* wu,
                        void* out, float* work, int M, int K, int N,
                        int splits, int dtype, cudaStream_t stream) {
  if (dtype == kF32)
    return launch_gemv_t<float, R>(x, wg, wu, out, work, M, K, N, splits,
                                   stream);
  return launch_gemv_t<__nv_bfloat16, R>(x, wg, wu, out, work, M, K, N,
                                         splits, stream);
}

template <int BM, int BN, int BK>
cudaError_t launch_wgmma(const void* x, const void* wg, const void* wu,
                         void* out, float*, int M, int K, int N, int,
                         int dtype, cudaStream_t stream) {
  if (dtype != kBF16 || K == 0 || K % 8 || N % 8 || !aligned(x, 16) ||
      !aligned(wg, 16) || !aligned(wu, 16) || !aligned(out, 16))
    return cudaErrorInvalidValue;   // what TMA cannot take
  return launch_wgmma_gemm<BM, BN, BK, true>(x, wg, wu, out, 1, M, K, N,
                                             false, 1.f, kGroupM, stream);
}

// The tilings a call may name, by id (kernels/fused_ff.py::TILINGS lists
// the same names in the same order).
struct Tiling {
  const char* name;
  Launcher launch;
};
const Tiling kTilings[] = {
    {"simt_8x64", &launch_simt},
    {"gemv_m1", &launch_gemv<1>},
    {"gemv_m2", &launch_gemv<2>},
    {"gemv_m4", &launch_gemv<4>},
    {"gemv_m8", &launch_gemv<8>},
    {"wgmma_bm128_bn128_bk128", &launch_wgmma<128, 128, 128>},
    {"wgmma_bm128_bn128_bk64", &launch_wgmma<128, 128, 64>},
    {"wgmma_bm64_bn256_bk64", &launch_wgmma<64, 256, 64>},
    {"simt_bm128_bn128_bk8", &launch_simt_block<128, 128>},
    {"simt_bm64_bn256_bk8", &launch_simt_block<64, 256>},
};
constexpr int kNumTilings = sizeof(kTilings) / sizeof(kTilings[0]);

}  // namespace
}  // namespace repro

// The tiling names by id, comma-separated.
extern "C" const char* repro_fused_ff_tilings() {
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

// x: (M, K); wg, wu: (K, N); out: (M, N); all contiguous, one dtype.
// work: the gemv instances' f32 partial sums, 2 * splits * M * N floats
// (unused by the others).  Returns a cudaError_t.
extern "C" int repro_fused_ff(const void* x, const void* wg, const void* wu,
                              void* out, void* work, int M, int K, int N,
                              int splits, int tiling, int dtype,
                              void* stream) {
  if (tiling < 0 || tiling >= repro::kNumTilings ||
      (dtype != repro::kF32 && dtype != repro::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(repro::kTilings[tiling].launch(
      x, wg, wu, out, static_cast<float*>(work), M, K, N, splits, dtype,
      static_cast<cudaStream_t>(stream)));
}
