// Shared helpers of the hand-written Hopper kernels: f32 conversion of
// the two element types the wrappers accept, and the dtype codes of the
// plain C interface (kept in step with kernels/_build.py::DTYPE_CODES).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Rows of attention's per-row f32 buffers (the forward's log-sum-exp, the
// backward's delta) a head holds: Sq rounded up to a multiple of this, so
// that the backward copies whole tiles of them with 16-byte aligned bulk
// copies (kernels/flash_attention.py::ROW_PAD).
constexpr int kRowPad = 64;

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace repro
