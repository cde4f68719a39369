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
// Two kernels in three routes, chosen per call by the tiling id the
// wrapper passes (the wrapper's select_tiling maps the dtype, the shape
// and the deployed config's bm/bn/bk to an id of kTilings below):
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
// simt_bm*_bn*_bk8 — f32 (IEEE FMAs, never TF32: the reference's test
// holds f32 results to 2e-5 at K = 256, which TF32's 10-bit mantissa
// cannot meet), one instance per block shape (bm, bn) a deployed config
// names: the register-blocked SIMT product of simt_gemm.cuh (its note
// says how it works) with the config's bm x bn tile of C.  The K slab
// stays 8 deep whatever bk the config names: a slab is double-buffered
// through registers, so a bk-deep f32 slab would hold bk (bm + bn) / 256
// staged values a thread beside the (bm / 16) (bn / 16) accumulators
// (256 at bk 128 and 128 x 128, past the register file), and the name
// says 8.  This route takes K and N multiples of 4 and 16-byte-aligned
// pointers.  ptxas (sm_90a): 53 (64 x 64) to 255 (128 x 256) registers,
// no spills.
//
// simt_128x128x8 — what the other routes cannot take: bf16 with K or N
// not a multiple of 8 or unaligned tensors, and f32 with K or N not a
// multiple of 4 or unaligned tensors; the same SIMT product at 128 x 128,
// with 4-element or scalar loads as the operands allow.

#include "common.cuh"
#include "simt_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace repro {
namespace {

// The SIMT product at block shape BM x BN (any operands: 4-element loads
// where they allow it, else scalar ones).
template <typename T, int BM, int BN>
cudaError_t launch_simt(const void* a, const void* b, void* c, int batch,
                        int M, int K, int N, bool leaky, float slope,
                        cudaStream_t stream) {
  return simt_gemm::launch<T, BM, BN, false>(a, b, nullptr, c, batch, M, K,
                                             N, leaky, slope, stream);
}

// The f32 instance of a deployed block shape: the 4-element route only.
template <int BM, int BN>
cudaError_t launch_simt_f32(const void* a, const void* b, void* c, int batch,
                            int M, int K, int N, bool leaky, float slope,
                            cudaStream_t stream) {
  if (!simt_gemm::vec_ok<float>(K, N, a, b, nullptr, c))
    return cudaErrorInvalidValue;
  return launch_simt<float, BM, BN>(a, b, c, batch, M, K, N, leaky, slope,
                                    stream);
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
// lists the same names in the same order), with the launcher of each type
// that has one: id 0, the SIMT kernel for what the other routes cannot
// take, in f32 and bf16; the wgmma instances in bf16; the per-config SIMT
// instances in f32.
struct Tiling {
  const char* name;
  Launcher f32;
  Launcher bf16;
};
const Tiling kTilings[] = {
    {"simt_128x128x8", &launch_simt<float, 128, 128>,
     &launch_simt<__nv_bfloat16, 128, 128>},
    {"wgmma_bm128_bn128_bk128", nullptr, &launch_wgmma<128, 128, 128>},
    {"wgmma_bm128_bn128_bk64", nullptr, &launch_wgmma<128, 128, 64>},
    {"wgmma_bm64_bn128_bk128", nullptr, &launch_wgmma<64, 128, 128>},
    {"wgmma_bm128_bn256_bk64", nullptr, &launch_wgmma<128, 256, 64>},
    {"wgmma_bm256_bn128_bk64", nullptr, &launch_wgmma<256, 128, 64>},
    {"wgmma_bm64_bn64_bk128", nullptr, &launch_wgmma<64, 64, 128>},
    {"wgmma_bm256_bn64_bk64", nullptr, &launch_wgmma<256, 64, 64>},
    {"wgmma_bm64_bn128_bk64", nullptr, &launch_wgmma<64, 128, 64>},
    {"wgmma_bm64_bn64_bk64", nullptr, &launch_wgmma<64, 64, 64>},
    {"simt_bm128_bn128_bk8", &launch_simt_f32<128, 128>, nullptr},
    {"simt_bm64_bn128_bk8", &launch_simt_f32<64, 128>, nullptr},
    {"simt_bm128_bn256_bk8", &launch_simt_f32<128, 256>, nullptr},
    {"simt_bm256_bn128_bk8", &launch_simt_f32<256, 128>, nullptr},
    {"simt_bm64_bn64_bk8", &launch_simt_f32<64, 64>, nullptr},
    {"simt_bm256_bn64_bk8", &launch_simt_f32<256, 64>, nullptr},
};
constexpr int kNumTilings = sizeof(kTilings) / sizeof(kTilings[0]);

cudaError_t dispatch(const void* a, const void* b, void* c, int batch, int M,
                     int K, int N, bool leaky, float slope, int tiling,
                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiling < 0 || tiling >= kNumTilings) return cudaErrorInvalidValue;
  if (batch == 0 || M == 0 || N == 0) return cudaSuccess;
  const Launcher fn = dtype == kF32 ? kTilings[tiling].f32
                    : dtype == kBF16 ? kTilings[tiling].bf16 : nullptr;
  if (fn == nullptr) return cudaErrorInvalidValue;   // no such instance
  if (dtype == kBF16 && tiling != 0 &&
      (K == 0 || K % 8 || N % 8 || !aligned(a, 16) || !aligned(b, 16) ||
       !aligned(c, 16)))
    return cudaErrorInvalidValue;   // what TMA cannot take
  return fn(a, b, c, batch, M, K, N, leaky, slope, s);
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
