// Row softmax: y = exp(x - max(x)) / sum(exp(x - max(x))) over each row,
// computed in f32 and written in x's type (one rounding on the store).
//
// Replaces the TPU kernel src/repro/kernels/softmax.py::_kernel (its
// pl.pallas_call is in softmax() at softmax.py:27), which holds `br` full
// rows a grid step in VMEM and needs rows % br == 0.  The grid steps run
// one after another on the TPU core; here every row is a block of its own
// and the blocks run in parallel, so `br` has no counterpart (the wrapper
// keeps the reference's assertion on it).  This kernel takes any rows and
// any cols up to kMaxCols (the largest CONFIGS entry, 8192).
//
// What bounds it on an H100: bytes.  A call reads x once and writes y
// once, and does about 5 f32 operations an element (max, subtract, exp,
// add, divide).  At the optimizer path's shape, 40960 rows of 4096 (20
// heads x 2048 query positions of qwen1.5-4b), that is 671 MB in bf16,
// 0.200 ms at 3.35 TB/s, against 0.84 GFLOP, 0.013 ms at the FMA units'
// 67 TFLOP/s.  So the design reads each element from device memory once:
//
// one block of 256 threads a row; the row is held in registers (at most
// 32 values a thread) between the three sweeps, so the max, the sum and
// the normalisation cost no second read.  Loads and stores are 16 bytes
// a thread (8 bf16 or 4 f32), neighbouring threads on neighbouring
// addresses; a row whose width is not a multiple of the vector, or whose
// pointers are not 16-byte aligned, takes the scalar path.  The max and
// the sum reduce by warp shuffles, then across the 8 warps through shared
// memory, in a fixed order, so the result is deterministic.  exp is the
// accurate expf and the division IEEE, as the plain version's.

#include <math.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 8192;
constexpr int kPer = kMaxCols / kThreads;  // values a thread holds, at most

// Reduce over the block with `op`; every thread returns the result.
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, float* partial, Op op) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  v = partial[lane % kWarps];
#pragma unroll
  for (int o = kWarps / 2; o > 0; o >>= 1)
    v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Sum {
  __device__ float operator()(float a, float b) const { return a + b; }
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    softmax_kernel(const T* __restrict__ x, T* __restrict__ y, int cols) {
  constexpr int V = kVec ? 16 / sizeof(T) : 1;  // elements a load
  constexpr int kLoads = kPer / V;              // loads a thread, at most
  __shared__ float partial_max[kWarps], partial_sum[kWarps];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * cols;
  T* yr = y + static_cast<size_t>(blockIdx.x) * cols;
  const int nload = cols / V;

  float v[kPer];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < nload) {
      if constexpr (kVec) {
        const uint4 raw = reinterpret_cast<const uint4*>(xr)[idx];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) v[i * V + j] = to_f32(e[j]);
      } else {
        v[i] = to_f32(xr[idx]);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) m = fmaxf(m, v[i * V + j]);
    }
  }
  m = block_reduce(m, partial_max, Max());

  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    if (threadIdx.x + i * kThreads < nload) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[i * V + j] = expf(v[i * V + j] - m);
        s += v[i * V + j];
      }
    }
  }
  s = block_reduce(s, partial_sum, Sum());

#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < nload) {
      if constexpr (kVec) {
        uint4 raw;
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) e[j] = from_f32<T>(v[i * V + j] / s);
        reinterpret_cast<uint4*>(yr)[idx] = raw;
      } else {
        yr[idx] = from_f32<T>(v[i] / s);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int rows, int cols,
                   cudaStream_t stream) {
  if (cols > kMaxCols || rows < 0 || cols < 0) return cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return cudaSuccess;
  const bool vec = cols % (16 / sizeof(T)) == 0 && aligned(x, 16) &&
                   aligned(y, 16);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (vec)
    softmax_kernel<T, true><<<rows, kThreads, 0, stream>>>(xp, yp, cols);
  else
    softmax_kernel<T, false><<<rows, kThreads, 0, stream>>>(xp, yp, cols);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x, y: (rows, cols) contiguous, cols <= 8192.  Returns a cudaError_t.
extern "C" int repro_softmax(const void* x, void* y, int rows, int cols,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return repro::launch<float>(x, y, rows, cols, s);
    case repro::kBF16:
      return repro::launch<__nv_bfloat16>(x, y, rows, cols, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
