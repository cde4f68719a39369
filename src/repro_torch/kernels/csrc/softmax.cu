// Row softmax: y = exp(x - max(x)) / sum(exp(x - max(x))) over each row,
// computed in f32 and written in x's type (one rounding on the store).
//
// Replaces the TPU kernel src/repro/kernels/softmax.py::_kernel (its
// pl.pallas_call is in softmax() at softmax.py:27), which holds `br` full
// rows a grid step in VMEM and needs rows % br == 0.  The grid steps run
// one after another on the TPU core; here a block of 256 threads owns `br`
// consecutive rows and normalises them one after another, and the blocks
// run in parallel.  The deployed br picks the instance (block_br4, _br8,
// _br16, _br32: the br values of CONFIGS), block_br1 (a block a row) serves
// calls that name no br, and scalar (a block a row, element loads) rows
// whose width is not a multiple of the 16-byte vector or whose pointers
// are not 16-byte aligned; the wrapper's select_tiling names the instance
// and keeps the reference's assertion on br.  This file takes any rows and
// any cols up to kMaxCols (the largest CONFIGS entry, 8192).
//
// What bounds it on an H100: bytes.  A call reads x once and writes y
// once, and does about 5 f32 operations an element (max, subtract, exp,
// add, divide).  At the optimizer path's shape, 40960 rows of 4096 (20
// heads x 2048 query positions of qwen1.5-4b), that is 671 MB in bf16,
// 0.200 ms at 3.35 TB/s, against 0.84 GFLOP, 0.013 ms at the FMA units'
// 67 TFLOP/s.  So the design reads each element from device memory once:
//
// a row is held in registers (at most 32 values a thread) between the
// three sweeps, so the max, the sum and the normalisation cost no second
// read.  Loads and stores are 16 bytes a thread (8 bf16 or 4 f32),
// neighbouring threads on neighbouring addresses.  The max and the sum
// reduce by warp shuffles, then across the 8 warps through shared memory,
// in a fixed order, so the result is deterministic (a row's reads of the
// max's slots come before the sum's barrier, and of the sum's before the
// next row's max barrier, so the next row may write them).  exp is the
// accurate expf and the division IEEE, as the plain version's.  ptxas:
// 58 registers (bf16) and 53 (f32) for every br, 60 / 58 at br 1, 78 for
// scalar, no spills.  At 40960 x 4096 br 1 to 16 measure within 6% of
// each other and br 32 slower: 1280 blocks of 32 rows fill 1056 slots
// (8 an SM) and leave a long tail (PERF.md).

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

template <typename T, bool kVec, int BR>
__global__ void __launch_bounds__(kThreads)
    softmax_kernel(const T* __restrict__ x, T* __restrict__ y, int rows,
                   int cols) {
  constexpr int V = kVec ? 16 / sizeof(T) : 1;  // elements a load
  constexpr int kLoads = kPer / V;              // loads a thread, at most
  __shared__ float partial_max[kWarps], partial_sum[kWarps];
  const int nload = cols / V;

  for (int j = 0; j < BR; ++j) {
    const int row = blockIdx.x * BR + j;
    if (row >= rows) return;
    const T* xr = x + static_cast<size_t>(row) * cols;
    T* yr = y + static_cast<size_t>(row) * cols;

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
          for (int k = 0; k < V; ++k) v[i * V + k] = to_f32(e[k]);
        } else {
          v[i] = to_f32(xr[idx]);
        }
#pragma unroll
        for (int k = 0; k < V; ++k) m = fmaxf(m, v[i * V + k]);
      }
    }
    m = block_reduce(m, partial_max, Max());

    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      if (threadIdx.x + i * kThreads < nload) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          v[i * V + k] = expf(v[i * V + k] - m);
          s += v[i * V + k];
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
          for (int k = 0; k < V; ++k) e[k] = from_f32<T>(v[i * V + k] / s);
          reinterpret_cast<uint4*>(yr)[idx] = raw;
        } else {
          yr[idx] = from_f32<T>(v[i] / s);
        }
      }
    }
  }
}

template <typename T, bool kVec, int BR>
cudaError_t launch_t(const void* x, void* y, int rows, int cols,
                     cudaStream_t stream) {
  if (kVec && !(cols % (16 / sizeof(T)) == 0 && aligned(x, 16) &&
                aligned(y, 16)))
    return cudaErrorInvalidValue;
  softmax_kernel<T, kVec, BR><<<(rows + BR - 1) / BR, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), rows, cols);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const void*, void*, int, int, int,
                                 cudaStream_t);

template <bool kVec, int BR>
cudaError_t launch(const void* x, void* y, int rows, int cols, int dtype,
                   cudaStream_t stream) {
  if (dtype == kF32) return launch_t<float, kVec, BR>(x, y, rows, cols, stream);
  return launch_t<__nv_bfloat16, kVec, BR>(x, y, rows, cols, stream);
}

// The tilings a call may name, by id (kernels/softmax.py::TILINGS lists the
// same names in the same order).
struct Tiling {
  const char* name;
  Launcher launch;
};
const Tiling kTilings[] = {
    {"scalar", &launch<false, 1>},
    {"block_br1", &launch<true, 1>},
    {"block_br4", &launch<true, 4>},
    {"block_br8", &launch<true, 8>},
    {"block_br16", &launch<true, 16>},
    {"block_br32", &launch<true, 32>},
};
constexpr int kNumTilings = sizeof(kTilings) / sizeof(kTilings[0]);

}  // namespace
}  // namespace repro

// The tiling names by id, comma-separated.
extern "C" const char* repro_softmax_tilings() {
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

// x, y: (rows, cols) contiguous, cols <= 8192; by the kernel of `tiling`
// (an id of repro_softmax_tilings()).  Returns a cudaError_t.
extern "C" int repro_softmax(const void* x, void* y, int rows, int cols,
                             int tiling, int dtype, void* stream) {
  if (tiling < 0 || tiling >= repro::kNumTilings || cols > repro::kMaxCols ||
      rows < 0 || cols < 0 || (dtype != repro::kF32 && dtype != repro::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || cols == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(repro::kTilings[tiling].launch(
      x, y, rows, cols, dtype, static_cast<cudaStream_t>(stream)));
}
