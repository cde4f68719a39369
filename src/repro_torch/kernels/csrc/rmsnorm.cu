// Root-mean-square normalisation: y = x * rsqrt(mean(x^2) + eps) * gamma,
// computed in f32 and written in x's type with one rounding.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_kernel (its
// pl.pallas_call is in rmsnorm() at rmsnorm.py:31), which tiles `br` rows
// per grid step and needs rows % br == 0.  This file takes any rows and
// cols; the wrapper keeps the reference's assertion on br.
//
// What bounds it on an H100: bytes.  A call reads x and gamma once and
// writes y once, at about 4 f32 operations an element.  At the training
// path's 8192 x 2560 bf16 that is 84 MB, 25.0 us at 3.35 TB/s; at the
// serving path's 8 x 2560 it is 87 KB, 0.03 us, so that call is bound by
// its launch and the latency of one trip to memory, and the model makes
// 81 of them a decode pass.  Fusing the norm into its neighbours would
// remove that cost; the reference has no such kernel, so none is here.
//
// Design: one block of 256 threads owns br consecutive rows and
// normalises them one after another.  Sweep 1 loads a row with 16-byte
// vector loads (8 bf16 or 4 f32 a thread and load, neighbouring threads on
// neighbouring addresses) and accumulates the f32 sum of squares; a
// warp-shuffle tree and shared memory reduce it across the block in a
// fixed order, so the result is deterministic.  Sweep 2 reads the row
// again (from L1 / L2) with gamma and writes x * r * gamma with vector
// stores.  The reduction's shared slots alternate between two sets from
// row to row: a row's barrier orders every read of the slots two rows
// back before the writes that reuse them.
//
// The instances, chosen per call by the tiling id the wrapper passes (its
// select_tiling maps the dtype, the shape and the deployed br to a name of
// kTilings below): block_row (a block a row) for calls that name no br
// (the model's), block_br8, _br16, _br32 for the br values of CONFIGS,
// and scalar (a block a row, element loads) for rows whose width is not a
// multiple of the 16-byte vector or whose pointers are not 16-byte
// aligned.  On the H100 (700 W) a design of one warp a row, the row held
// in registers and read once, measured slower than block_row at every
// model shape (8 x 2560, 8192 x 2560, 8192 x 4096 bf16; PERF.md): with 64
// warps an SM, many small blocks keep as many bytes in flight as warps
// holding whole rows, and at 8 rows eight SMs share the work that one
// block of 8 warps does alone.  The br instances trail block_row as br
// grows (device time in bf16 at 8192 x 2560: br 8 1.02x, br 16 1.29x,
// br 32 1.98x; PERF.md): 512 or 256 blocks leave half or more of the
// SMs' thread slots empty, and a block's rows run one after another, so
// few loads are in flight.  Loading the next row before the current
// row's barrier is what is left.  ptxas (`python -m
// repro_torch.kernels._build --ptxas`): 32 registers for every 16-byte
// instance in either type, 39 (bf16) and 32 (f32) for scalar, no spills.

#include "common.cuh"

namespace repro {
namespace {

// ---------------------------------------------------------------------------
// block_row, block_br*, scalar
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

// Sum over the block; every thread returns the total.
__device__ __forceinline__ float block_sum(float v, float* partial) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  v = lane < kThreads / 32 ? partial[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, bool kVec, int BR>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                   T* __restrict__ y, int rows, int cols, float eps) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  __shared__ float partial[2][kThreads / 32];
  const int nvec = kVec ? cols / V : 0;
  const uint4* gv = reinterpret_cast<const uint4*>(gamma);

  for (int j = 0; j < BR; ++j) {
    const int row = blockIdx.x * BR + j;
    if (row >= rows) return;
    const T* xr = x + static_cast<size_t>(row) * cols;
    T* yr = y + static_cast<size_t>(row) * cols;

    float ss = 0.f;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = to_f32(e[k]);
        ss = fmaf(f, f, ss);
      }
    }
    for (int c = nvec * V + threadIdx.x; c < cols; c += kThreads) {
      const float f = to_f32(xr[c]);
      ss = fmaf(f, f, ss);
    }
    const float r = rsqrtf(block_sum(ss, partial[j % 2]) /
                               static_cast<float>(cols) + eps);

    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const uint4 rx = xv[i], rg = gv[i];
      uint4 ro;
      const T* ex = reinterpret_cast<const T*>(&rx);
      const T* eg = reinterpret_cast<const T*>(&rg);
      T* eo = reinterpret_cast<T*>(&ro);
#pragma unroll
      for (int k = 0; k < V; ++k)
        eo[k] = from_f32<T>(to_f32(ex[k]) * r * to_f32(eg[k]));
      yv[i] = ro;
    }
    for (int c = nvec * V + threadIdx.x; c < cols; c += kThreads)
      yr[c] = from_f32<T>(to_f32(xr[c]) * r * to_f32(gamma[c]));
  }
}

// ---------------------------------------------------------------------------
// the instances
// ---------------------------------------------------------------------------

using Launcher = cudaError_t (*)(const void*, const void*, void*, int, int,
                                 float, int, cudaStream_t);

template <typename T, bool kVec, int BR>
cudaError_t launch_t(const void* x, const void* gamma, void* y, int rows,
                     int cols, float eps, cudaStream_t stream) {
  if (kVec && !(cols % (16 / sizeof(T)) == 0 && aligned(x, 16) &&
                aligned(gamma, 16) && aligned(y, 16)))
    return cudaErrorInvalidValue;
  rmsnorm_kernel<T, kVec, BR><<<(rows + BR - 1) / BR, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<T*>(y), rows, cols, eps);
  return cudaGetLastError();
}

template <bool kVec, int BR>
cudaError_t launch(const void* x, const void* gamma, void* y, int rows,
                   int cols, float eps, int dtype, cudaStream_t stream) {
  if (dtype == kF32)
    return launch_t<float, kVec, BR>(x, gamma, y, rows, cols, eps, stream);
  return launch_t<__nv_bfloat16, kVec, BR>(x, gamma, y, rows, cols, eps,
                                           stream);
}

// The tilings a call may name, by id (kernels/rmsnorm.py::TILINGS lists the
// same names in the same order).
struct Tiling {
  const char* name;
  Launcher launch;
};
const Tiling kTilings[] = {
    {"scalar", &launch<false, 1>},
    {"block_row", &launch<true, 1>},
    {"block_br8", &launch<true, 8>},
    {"block_br16", &launch<true, 16>},
    {"block_br32", &launch<true, 32>},
};
constexpr int kNumTilings = sizeof(kTilings) / sizeof(kTilings[0]);

}  // namespace
}  // namespace repro

// The tiling names by id, comma-separated.
extern "C" const char* repro_rmsnorm_tilings() {
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

// x, y: (rows, cols) contiguous; gamma: (cols,); by the kernel of `tiling`
// (an id of repro_rmsnorm_tilings()).  Returns a cudaError_t.
extern "C" int repro_rmsnorm(const void* x, const void* gamma, void* y,
                             int rows, int cols, float eps, int tiling,
                             int dtype, void* stream) {
  if (tiling < 0 || tiling >= repro::kNumTilings ||
      (dtype != repro::kF32 && dtype != repro::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || cols == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(repro::kTilings[tiling].launch(
      x, gamma, y, rows, cols, eps, dtype,
      static_cast<cudaStream_t>(stream)));
}
