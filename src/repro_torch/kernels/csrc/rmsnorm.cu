// Root-mean-square normalisation: y = x * rsqrt(mean(x^2) + eps) * gamma,
// computed in f32 and written in x's type.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_kernel (its
// pl.pallas_call is in rmsnorm() at rmsnorm.py:31), which tiles `br` rows
// per grid step and needs rows % br == 0.  This kernel takes any rows and
// any cols: the column tail is masked.
//
// What bounds it on an H100: bytes, and at the serving path's shape not
// even those.  A call reads x and gamma once and writes y once; at the
// decode shape of qwen1.5-4b (8 x 2560 bf16) that is about 87 KB, 0.03 us
// at 3.35 TB/s, against about 4 flops per element.  So the call is bound
// by its launch (microseconds), and the model calls it 81 times a pass.
// Fusing it into its neighbours (the residual add before it, the
// projection after it) is what would remove that cost; this kernel is
// the simple, right first version.
//
// Design: one block of 256 threads per row.  Sweep 1 loads the row with
// 16-byte vector loads (8 bf16 or 4 f32 per thread and load, neighbouring
// threads on neighbouring addresses) and accumulates the f32 sum of
// squares; a warp-shuffle tree and shared memory reduce it across the
// block in a fixed order, so the result is deterministic.  Sweep 2 reads
// the row again (now from L1/L2) with gamma and writes x * r * gamma with
// vector stores.  Rows whose width is not a multiple of the vector, or
// whose pointers are not 16-byte aligned, take the scalar path.

#include "common.cuh"

namespace repro {
namespace {

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

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                   T* __restrict__ y, int cols, float eps) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  __shared__ float partial[kThreads / 32];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * cols;
  T* yr = y + static_cast<size_t>(blockIdx.x) * cols;
  const int nvec = kVec ? cols / V : 0;

  float ss = 0.f;
  const uint4* xv = reinterpret_cast<const uint4*>(xr);
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 raw = xv[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f32(e[j]);
      ss = fmaf(f, f, ss);
    }
  }
  for (int c = nvec * V + threadIdx.x; c < cols; c += kThreads) {
    const float f = to_f32(xr[c]);
    ss = fmaf(f, f, ss);
  }
  const float r = rsqrtf(block_sum(ss, partial) / static_cast<float>(cols) + eps);

  const uint4* gv = reinterpret_cast<const uint4*>(gamma);
  uint4* yv = reinterpret_cast<uint4*>(yr);
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 rx = xv[i], rg = gv[i];
    uint4 ro;
    const T* ex = reinterpret_cast<const T*>(&rx);
    const T* eg = reinterpret_cast<const T*>(&rg);
    T* eo = reinterpret_cast<T*>(&ro);
#pragma unroll
    for (int j = 0; j < V; ++j) eo[j] = from_f32<T>(to_f32(ex[j]) * r * to_f32(eg[j]));
    yv[i] = ro;
  }
  for (int c = nvec * V + threadIdx.x; c < cols; c += kThreads)
    yr[c] = from_f32<T>(to_f32(xr[c]) * r * to_f32(gamma[c]));
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, void* y, int rows,
                   int cols, float eps, cudaStream_t stream) {
  if (rows == 0 || cols == 0) return cudaSuccess;
  const bool vec = cols % (16 / sizeof(T)) == 0 && aligned(x, 16) &&
                   aligned(gamma, 16) && aligned(y, 16);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  T* yp = static_cast<T*>(y);
  if (vec)
    rmsnorm_kernel<T, true><<<rows, kThreads, 0, stream>>>(xp, gp, yp, cols, eps);
  else
    rmsnorm_kernel<T, false><<<rows, kThreads, 0, stream>>>(xp, gp, yp, cols, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x, y: (rows, cols) contiguous; gamma: (cols,).  Returns a cudaError_t.
extern "C" int repro_rmsnorm(const void* x, const void* gamma, void* y,
                             int rows, int cols, float eps, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return repro::launch<float>(x, gamma, y, rows, cols, eps, s);
    case repro::kBF16:
      return repro::launch<__nv_bfloat16>(x, gamma, y, rows, cols, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
