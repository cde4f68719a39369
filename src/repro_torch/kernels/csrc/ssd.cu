// Mamba-2 SSD (state-space duality) scan in its chunked dual form:
//   y[t] = sum_{s<=t} e^{A_t - A_s} (c_t . b_s) x_s,  A the running sum of a,
// with f32 math and one rounding to x's type on the store.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py::_kernel (its
// pl.pallas_call is in ssd() at ssd.py:71), which folds heads into a
// parallel grid axis, walks the chunks on a sequential grid axis with the
// (P, N) f32 state in VMEM scratch, and needs S % chunk == 0.  This kernel
// takes the model layout: x (B, S, H, P), a (B, S, H) in f32, b and c
// (B, S, G, N), each read through its strides (only the last axis must be
// contiguous), with head h reading group h / (H / G), so b and c are never
// repeated over heads; the flat (BH, S, P) layout of the registry is the
// B = BH, H = G = 1 case.  Any S is taken (the tail of the last chunk is
// masked: a = 0, x = b = c = 0, rows past S not stored), P <= 128 and
// N <= 128.
//
// Chunk length.  The chunked form is exact for any chunk length (only the
// f32 rounding moves), so the kernel stages its own chunk of kLC = 64
// positions whatever chunk the call names (64 or 128 in the optimizer's
// CONFIGS): a 128-position chunk staged as below needs about 260 KB of
// shared memory, above the 227 KB a block may have.
//
// What bounds it on an H100: operations, on the units this version uses.
// At the training path's shape (mamba2-1.3b: B 4, S 2048, H 64, P 64, G 1,
// N 128, bf16 x/b/c, f32 a) the function needs at least 17.2 GFLOP (the
// recurrence: 4 N P a position) against 138 MB of operands: 0.017 ms at
// the bf16 tensor-core peak, 0.041 ms at 3.35 TB/s, so bytes set the
// bound.  The chunked form below does 23.7 GFLOP (L(L+1)(N+P) + 4 L N P a
// chunk of L = 64, products stopped at the diagonal), and this first
// version does it on the f32 FMA units (67 TFLOP/s peak, 0.35 ms), so it
// cannot come near that bound; moving the three products onto wgmma is
// later work.
//
// Design: one block of 256 threads per (batch, head), a sequential loop
// over chunks, the (P, N) state in shared memory (transposed, [n][p]) for
// the whole sequence.  Per chunk: x, b (transposed), c and a are staged as
// f32; warp 0 takes the running sum seg of a with warp shuffles, while 64
// threads each walk one column s of the decay L[t,s] = e^{seg_t - seg_s}
// (t >= s), summing a_{s+1} + ... + a_t as it stands: the difference of
// two running sums would lose their low bits, about 1e-5 relative at
// mamba2's decay (the plain version sums the same way).  The column's
// last sum gives the weight e^{seg_end - seg_s}.  Above the diagonal no
// exponential is taken: its argument would be positive and overflow once
// a chunk's decay passes about 88.  Then three products, each thread
// owning a register tile:
//   1. M = (C B^T) * L, 64 x 64, 0 above the diagonal; thread (ty, tx) of
//      a 16 x 16 grid owns rows 4ty..4ty+3 and columns tx + 16j, reading
//      C as float4 and B^T along columns, so neither read conflicts on a
//      bank;
//   2. y = M X + e^{seg} C state^T, rows 4ty..4ty+3 and channels tx + 16k;
//      the M X loop stops at the thread's last row (M is 0 beyond it);
//   3. state = e^{seg_end} state + (X e^{seg_end - seg})^T B, state rows
//      n = ty + 16i and channels p = tx + 16k, each entry owned by one
//      thread, after every read of the old state.
// f32 inputs use IEEE f32 FMAs, never TF32, and every sum runs in a fixed
// order, so a result is deterministic.

#include <math.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kLC = 64;         // positions per staged chunk
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kBP = kLC + 1;    // pitch of B^T rows (conflict-free stores)
constexpr int kMP = kLC + 4;    // pitch of the rows of M

// floats of shared memory for P padded to PT and N to NT
constexpr int smem_floats(int PT, int NT) {
  return kLC * (NT + 4) + kLC * PT + NT * kBP + kLC * kMP + NT * PT + 3 * kLC;
}

template <typename T, int PT, int NT>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ a,
               const T* __restrict__ b, const T* __restrict__ c,
               T* __restrict__ y, int S, int H, int G, int P, int N,
               long long sxb, long long sxs, long long sxh, long long sab,
               long long sas, long long sah, long long sbb, long long sbs,
               long long sbg, long long scb, long long scs, long long scg) {
  constexpr int CP = NT + 4;    // pitch of C rows: 16-byte aligned
  constexpr int NK = PT / 16;   // channels p per thread
  constexpr int NI = NT / 16;   // state rows n per thread
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);   // [kLC][CP]
  float* xs = cs + kLC * CP;                     // [kLC][PT]
  float* bt = xs + kLC * PT;                     // [NT][kBP]
  float* ms = bt + NT * kBP;                     // [kLC][kMP]
  float* st = ms + kLC * kMP;                    // [NT][PT]: the state^T
  float* seg = st + NT * PT;                     // [kLC]
  float* wdec = seg + kLC;                       // [kLC]: e^{seg_end - seg}
  float* av = wdec + kLC;                        // [kLC]: a

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bi = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const T* xp = x + bi * sxb + h * sxh;
  const float* ap = a + bi * sab + h * sah;
  const T* bp = b + bi * sbb + g * sbg;
  const T* cp = c + bi * scb + g * scg;
  const size_t ys = static_cast<size_t>(H) * P;  // y's row stride
  T* yp = y + (static_cast<size_t>(bi) * S * H + h) * P;

  for (int i = tid; i < NT * PT; i += kThreads) st[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kLC) {
    const int rows = min(kLC, S - s0);
    __syncthreads();   // the previous chunk's tiles and state are written
    for (int i = tid; i < kLC * PT; i += kThreads) {
      const int s = i / PT, p = i % PT;
      xs[i] = (s < rows && p < P) ? to_f32(xp[(s0 + s) * sxs + p]) : 0.f;
    }
    for (int i = tid; i < kLC * NT; i += kThreads) {
      const int s = i / NT, n = i % NT;
      const bool in = s < rows && n < N;
      bt[n * kBP + s] = in ? to_f32(bp[(s0 + s) * sbs + n]) : 0.f;
      cs[s * CP + n] = in ? to_f32(cp[(s0 + s) * scs + n]) : 0.f;
    }
    for (int s = tid; s < kLC; s += kThreads)
      av[s] = s < rows ? ap[(s0 + s) * sas] : 0.f;
    __syncthreads();
    if (tid < 32) {   // warp 0: seg = running sum of a over the chunk
      float carry = 0.f;
      for (int base = 0; base < kLC; base += 32) {
        float v = av[base + tid];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (tid >= o) v += u;
        }
        v += carry;
        seg[base + tid] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    } else if (tid < 32 + kLC) {
      // threads 32..95: column s of L (on and below the diagonal) and
      // e^{seg_end - seg_s}, from sums of a taken as they stand
      const int s = tid - 32;
      float r = 0.f;
      ms[s * kMP + s] = 1.f;
      for (int t = s + 1; t < kLC; ++t) {
        r += av[t];
        ms[t * kMP + s] = expf(r);
      }
      wdec[s] = expf(r);
    }
    __syncthreads();

    // 1. M = (C B^T) * L
    {
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < NT; n += 4) {
        float4 cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(&cs[(4 * ty + i) * CP + n]);
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          float bv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bt[(n + dd) * kBP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float cd = dd == 0 ? cv[i].x : dd == 1 ? cv[i].y
                           : dd == 2 ? cv[i].z : cv[i].w;
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cd, bv[j], sc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          ms[t * kMP + s] = s <= t ? ms[t * kMP + s] * sc[i][j] : 0.f;
        }
      }
    }
    __syncthreads();

    // 2. y = M X + e^{seg} C state^T
    {
      float acc[4][NK];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < NK; ++k) acc[i][k] = 0.f;
      const int s_end = 4 * ty + 4;   // M[t, s] = 0 for s > t
      for (int s = 0; s < s_end; ++s) {
        float mv[4], xv[NK];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = ms[(4 * ty + i) * kMP + s];
#pragma unroll
        for (int k = 0; k < NK; ++k) xv[k] = xs[s * PT + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < NK; ++k) acc[i][k] = fmaf(mv[i], xv[k], acc[i][k]);
      }
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = expf(seg[4 * ty + i]);
#pragma unroll 4
      for (int n = 0; n < NT; ++n) {
        float cv[4], sv[NK];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(4 * ty + i) * CP + n] * e[i];
#pragma unroll
        for (int k = 0; k < NK; ++k) sv[k] = st[n * PT + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < NK; ++k) acc[i][k] = fmaf(cv[i], sv[k], acc[i][k]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ty + i;
        if (t >= rows) continue;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int p = tx + 16 * k;
          if (p < P) yp[(s0 + t) * ys + p] = from_f32<T>(acc[i][k]);
        }
      }
    }
    __syncthreads();   // every read of the old state is done

    // 3. state = e^{seg_end} state + (X e^{seg_end - seg})^T B
    {
      const float dtot = expf(seg[kLC - 1]);
      float acc[NI][NK];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int k = 0; k < NK; ++k)
          acc[i][k] = dtot * st[(ty + 16 * i) * PT + tx + 16 * k];
#pragma unroll 2
      for (int s = 0; s < kLC; ++s) {
        const float w = wdec[s];
        float xv[NK], bv[NI];
#pragma unroll
        for (int k = 0; k < NK; ++k) xv[k] = xs[s * PT + tx + 16 * k] * w;
#pragma unroll
        for (int i = 0; i < NI; ++i) bv[i] = bt[(ty + 16 * i) * kBP + s];
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int k = 0; k < NK; ++k) acc[i][k] = fmaf(bv[i], xv[k], acc[i][k]);
      }
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int k = 0; k < NK; ++k)
          st[(ty + 16 * i) * PT + tx + 16 * k] = acc[i][k];
    }
  }
}

struct Strides {
  long long xb, xs, xh, ab, as, ah, bb, bs, bg, cb, cs, cg;
};

template <typename T, int PT, int NT>
cudaError_t launch_tile(const void* x, const float* a, const void* b,
                        const void* c, void* y, int B, int S, int H, int G,
                        int P, int N, const Strides& d, cudaStream_t stream) {
  const size_t smem = smem_floats(PT, NT) * sizeof(float);
  auto kernel = ssd_kernel<T, PT, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), S, H, G, P, N, d.xb, d.xs,
      d.xh, d.ab, d.as, d.ah, d.bb, d.bs, d.bg, d.cb, d.cs, d.cg);
  return cudaGetLastError();
}

template <typename T, int PT>
cudaError_t launch_p(const void* x, const float* a, const void* b,
                     const void* c, void* y, int B, int S, int H, int G, int P,
                     int N, const Strides& d, cudaStream_t stream) {
  if (N <= 64)
    return launch_tile<T, PT, 64>(x, a, b, c, y, B, S, H, G, P, N, d, stream);
  return launch_tile<T, PT, 128>(x, a, b, c, y, B, S, H, G, P, N, d, stream);
}

template <typename T>
cudaError_t launch(const void* x, const float* a, const void* b, const void* c,
                   void* y, int B, int S, int H, int G, int P, int N,
                   const Strides& d, cudaStream_t stream) {
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (G <= 0 || H % G != 0 || P <= 0 || P > 128 || N <= 0 || N > 128 ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // two tile widths each (the kernel masks P < PT and N < NT with zeros):
  // the paths run (P 64, N 128) and (P 128, N 64)
  if (P <= 64) return launch_p<T, 64>(x, a, b, c, y, B, S, H, G, P, N, d, stream);
  return launch_p<T, 128>(x, a, b, c, y, B, S, H, G, P, N, d, stream);
}

}  // namespace
}  // namespace repro

// x: (B, S, H, P), a: (B, S, H) f32, b, c: (B, S, G, N), each with the
// element strides given (batch, sequence, head or group; the last axis
// contiguous); y: (B, S, H, P) contiguous.  x, b, c and y share `dtype`.
// Returns a cudaError_t.
extern "C" int repro_ssd(const void* x, const void* a, const void* b,
                         const void* c, void* y, int B, int S, int H, int G,
                         int P, int N, long long sxb, long long sxs,
                         long long sxh, long long sab, long long sas,
                         long long sah, long long sbb, long long sbs,
                         long long sbg, long long scb, long long scs,
                         long long scg, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const repro::Strides d{sxb, sxs, sxh, sab, sas, sah,
                         sbb, sbs, sbg, scb, scs, scg};
  const float* af = static_cast<const float*>(a);
  switch (dtype) {
    case repro::kF32:
      return repro::launch<float>(x, af, b, c, y, B, S, H, G, P, N, d, s);
    case repro::kBF16:
      return repro::launch<__nv_bfloat16>(x, af, b, c, y, B, S, H, G, P, N, d,
                                          s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
