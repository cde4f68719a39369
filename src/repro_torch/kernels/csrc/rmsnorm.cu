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
// Two designs, chosen per call by the tiling id the wrapper passes (its
// select_tiling maps the dtype, the shape and the deployed br to a name
// of kTilings below).
//
// Narrow rows, lanesL_vecR (calls that name no br, rows of at most
// NARROW_ROW_BYTES = 2048 bytes: olmoe-1b-7b's 128-wide q/k norms,
// deepseek-v2-lite-16b's 512-wide MLA latent norm).  A group of L lanes
// of a warp owns a row, each lane R of its 16-byte vectors in registers,
// so the row is read from memory once; the sum of squares is reduced by
// shuffles among those L lanes, with no shared memory and no barrier;
// gamma, the reference's loop-invariant tile, is loaded once into the
// same lanes' registers.  The grid is one wave of the card (the occupancy
// API's blocks an SM times the SMs) walking the rows a warp at a time,
// and the next row's loads are issued before the current row is reduced,
// so a lane keeps two rows' vectors in flight.  Vectors past the row's
// end are predicated off.  The instances are the smallest L x R that
// holds a row: lanes8_vec1, lanes16_vec1 (bf16 128), lanes32_vec1 (f32
// 128, bf16 256), lanes32_vec2 (bf16 512), lanes32_vec4 (f32 512, bf16
// 1024).  Measured on the H100 (700 W; device time, bf16, PERF.md): at
// 131072 x 128 0.0247 ms against block_row's 0.1525 and F.rms_norm's
// 0.0878 (bound 0.0200); across 8192 rows of 128 to 1024 columns 1.9-4.8x
// faster than block_row.  At 2048 columns 32 lanes of 8 vectors (188
// registers, one block an SM) only tied block_row (0.0249 and 0.0250 ms),
// so that width and wider keep block_row, and no R = 8 instance is built.
//
// Wide rows, block_row (the model's other calls) and block_br8, _br16,
// _br32 (the br values of CONFIGS, at any width): one block of 256
// threads owns br consecutive rows and normalises them one after another.
// Sweep 1 loads a row with 16-byte vector loads (8 bf16 or 4 f32 a
// thread and load, neighbouring threads on neighbouring addresses) and
// accumulates the f32 sum of squares; a warp-shuffle tree and shared
// memory reduce it across the block in a fixed order, so the result is
// deterministic.  Sweep 2 reads the row again (from L1 / L2) with gamma
// and writes x * r * gamma with vector stores.  The reduction's shared
// slots alternate between two sets from row to row: a row's barrier
// orders every read of the slots two rows back before the writes that
// reuse them.  At the wide model shapes (8 x 2560, 8192 x 2560, 8192 x
// 4096 bf16; PERF.md) a design of one warp a row, the row held in
// registers and read once, measured slower than block_row: with 64
// warps an SM, many small blocks keep as many bytes in flight as warps
// holding whole rows, and at 8 rows eight SMs share the work that one
// block of 8 warps does alone.  The br instances trail block_row as br
// grows (device time in bf16 at 8192 x 2560: br 8 1.02x, br 16 1.29x,
// br 32 1.98x; PERF.md): 512 or 256 blocks leave half or more of the
// SMs' thread slots empty, and a block's rows run one after another, so
// few loads are in flight.
//
// scalar (a block a row, element loads) takes rows whose width is not a
// multiple of the 16-byte vector or whose pointers are not 16-byte
// aligned.  ptxas (`python -m repro_torch.kernels._build --ptxas`): 32
// registers for every block instance in either type, 39 (bf16) and 32
// (f32) for scalar; the narrow instances 40 (bf16) and 30-32 (f32) at
// R = 1, 60 and 46 at R = 2, 98 and 64 at R = 4; no spills.

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
// lanes{L}_vec{R}: narrow rows, a group of L lanes a row
// ---------------------------------------------------------------------------

// The R vectors a lane holds of row `row` (its part `part` of the L
// lanes): vectors part, part + L, ..., part + (R - 1) L, zeros past the
// row's end or past the last row.
template <int L, int R>
__device__ __forceinline__ void load_row(uint4 (&v)[R],
                                         const uint4* __restrict__ x,
                                         int row, int rows, int nvec,
                                         int part) {
  const uint4* xr = x + static_cast<size_t>(row) * nvec;
#pragma unroll
  for (int k = 0; k < R; ++k)
    v[k] = row < rows && part + k * L < nvec ? xr[part + k * L]
                                             : make_uint4(0, 0, 0, 0);
}

// A warp holds 32 / L rows at once, each in registers: the row is read
// once, the sum of squares is reduced by shuffles among the row's L lanes
// only (no shared memory, no barrier), and gamma, loaded once into the
// same lanes' registers, serves every row the warp walks.  The grid is
// one wave of the card and walks the rows a warp at a time, so every lane
// of a warp takes the same trips and each shuffle has all 32; the next
// row's loads are issued before the current row is reduced.
template <typename T, int L, int R>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_narrow_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                          T* __restrict__ y, int rows, int cols, float eps) {
  static_assert(L == 8 || L == 16 || L == 32, "L lanes of one warp");
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int kRowsPerWarp = 32 / L;
  const int nvec = cols / V;
  const int lane = threadIdx.x % 32, sub = lane / L, part = lane % L;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);

  uint4 g[R];
  load_row<L, R>(g, reinterpret_cast<const uint4*>(gamma), 0, 1, nvec, part);

  const int stride = gridDim.x * (kThreads / 32) * kRowsPerWarp;
  int base = (blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * kRowsPerWarp;
  uint4 cur[R];
  load_row<L, R>(cur, xv, base + sub, rows, nvec, part);
  for (; base < rows; base += stride) {
    const int row = base + sub;
    uint4 next[R];
    load_row<L, R>(next, xv, row + stride, rows, nvec, part);

    float ss = 0.f;  // zeros past the row's end add nothing
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const T* e = reinterpret_cast<const T*>(&cur[k]);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float f = to_f32(e[i]);
        ss = fmaf(f, f, ss);
      }
    }
    // a butterfly over the row's lanes: every lane adds the same pairs in
    // the same order, so all hold the same, deterministic total
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float r = rsqrtf(ss / static_cast<float>(cols) + eps);

    if (row < rows) {
      uint4* yr = yv + static_cast<size_t>(row) * nvec;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (part + k * L >= nvec) continue;
        uint4 ro;
        const T* ex = reinterpret_cast<const T*>(&cur[k]);
        const T* eg = reinterpret_cast<const T*>(&g[k]);
        T* eo = reinterpret_cast<T*>(&ro);
#pragma unroll
        for (int i = 0; i < V; ++i)
          eo[i] = from_f32<T>(to_f32(ex[i]) * r * to_f32(eg[i]));
        yr[part + k * L] = ro;
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) cur[k] = next[k];
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

// A row of at most L x R whole vectors; as many blocks as the card holds
// at once (from the occupancy API, once per instance), fewer if the rows
// need fewer.
template <typename T, int L, int R>
cudaError_t launch_narrow_t(const void* x, const void* gamma, void* y,
                            int rows, int cols, float eps,
                            cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (!(cols % V == 0 && cols / V <= L * R && aligned(x, 16) &&
        aligned(gamma, 16) && aligned(y, 16)))
    return cudaErrorInvalidValue;
  auto kernel = rmsnorm_narrow_kernel<T, L, R>;
  static int per_sm = 0, sms = 0;   // blocks an SM holds, SMs: per instance
  if (per_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
  }
  constexpr int kRowsPerBlock = kThreads / L;
  const int need = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const int wave = per_sm * sms;
  kernel<<<need < wave ? need : wave, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<T*>(y), rows, cols, eps);
  return cudaGetLastError();
}

template <int L, int R>
cudaError_t launch_narrow(const void* x, const void* gamma, void* y, int rows,
                          int cols, float eps, int dtype,
                          cudaStream_t stream) {
  if (dtype == kF32)
    return launch_narrow_t<float, L, R>(x, gamma, y, rows, cols, eps, stream);
  return launch_narrow_t<__nv_bfloat16, L, R>(x, gamma, y, rows, cols, eps,
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
    {"lanes8_vec1", &launch_narrow<8, 1>},
    {"lanes16_vec1", &launch_narrow<16, 1>},
    {"lanes32_vec1", &launch_narrow<32, 1>},
    {"lanes32_vec2", &launch_narrow<32, 2>},
    {"lanes32_vec4", &launch_narrow<32, 4>},
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
