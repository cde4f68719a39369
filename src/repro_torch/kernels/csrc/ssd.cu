// Mamba-2 SSD (state-space duality) scan in its chunked dual form:
//   y[t] = sum_{s<=t} e^{A_t - A_s} (c_t . b_s) x_s,  A the running sum of a,
// with f32 math and one rounding to x's type on the store.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py::_kernel (its
// pl.pallas_call is in ssd() at ssd.py:71), which folds heads into a
// parallel grid axis, walks the chunks on a sequential grid axis with the
// (P, N) f32 state in VMEM scratch, and needs S % chunk == 0.  This file
// takes the model layout: x (B, S, H, P), a (B, S, H) in f32, b and c
// (B, S, G, N), each read through its strides (only the last axis must be
// contiguous), with head h reading group h / (H / G), so b and c are never
// repeated over heads; the flat (BH, S, P) layout of the registry is the
// B = BH, H = G = 1 case.  Any S is taken (the tail of the last chunk is
// masked: a = 0, x = b = c = 0, rows past S not stored), P <= 128 and
// N <= 128.
//
// What bounds it on an H100: bytes.  At the training path's shape
// (mamba2-1.3b: B 4, S 2048, H 64, P 64, G 1, N 128, bf16 x/b/c, f32 a)
// the function needs 17.2 GFLOP (the recurrence: 4 N P a position),
// 0.017 ms at the bf16 tensor-core peak, against 140 MB of operands (x
// and y 67 MB each, a 2 MB, b and c 4 MB): 0.042 ms at 3.35 TB/s.
//
// The chunk-parallel scan.  Cut each head's sequence into chunks of L
// positions and the chunks into nseg segments.  The (P, N) state is the
// only thing that crosses a chunk boundary, so three launches replace the
// sequential walk:
//   (A) states: a block per (head, segment) but the last walks its chunks
//       carrying S = e^{seg_end} S + (X e^{seg_end - seg})^T B from 0 and
//       writes the segment's end state and total decay D (f32) to a
//       workspace;
//   (B) combine: state_in(k+1) = D_k state_in(k) + S_k, a short f32
//       recurrence over the segments, in place in the workspace;
//   (C) outputs: a block per (head, segment) starts from its segment's
//       state_in and walks its chunks: y = (C B^T * L) X + e^{seg} C
//       state^T, then the state update as in (A).
// A block's walk is a chain of dependent steps, so the time of a launch is
// about one block's chain: repro_ssd_segments takes as many segments as
// fill one wave of the outputs kernel's resident blocks (its occupancy
// times the SMs), none empty, and with nseg 1 only (C) runs.  At the
// training shape the 256 heads already fill the 264 slots of (64, 64,
// 128) (two blocks an SM), so nseg is 1; at a batch of one (64 heads) it
// is 4, which halves the call on the H100 (PERF.md).  Workspace bytes: (nseg - 1) f32 states of P N a head,
// written by (A), read and written by (B), read by (C); (A) reads x, a and
// b again.  At nseg 1 the launch moves the operands once: 140 MB at the
// training shape, 0.042 ms at 3.35 TB/s.
//
// The decay exponents.  Every exponent is a sum a_lo + ... + a_hi taken
// as it stands, never seg_t - seg_s (the difference of two running sums
// loses their low bits: about 1e-5 relative at mamba2's decay), and no
// exponential is taken above the diagonal (its argument would be positive
// and overflow once a chunk's decay passes about 88).  Per chunk the
// block tabulates, in blocks of 8 positions, the sums of a inside a block
// (each from k to every later position of k's block), each block's prefix
// and suffix sums, the sums of the whole blocks between two blocks, and
// the exponentials of all of them.  Then L[t, s] = e^{a_{s+1} + ... + a_t}
// is one table entry inside a block, else the product of three (suffix,
// whole blocks, prefix), each a sum taken as it stands; e^{seg_t} and the
// weights e^{seg_end - seg_s} are sums of at most three table entries.  No
// thread walks a column.
//
// Two kernels for (A) and (C), chosen per call by the tiling id the
// wrapper passes (kernels/ssd.py::select_tiling maps the dtype, the shape
// and the deployed chunk to an id of kTilings below):
//
// wgmma_l*_p*_n* — bf16, one instance per (chunk L, P width, N width): L
// 64 at (P 64, N 128) and (P 128, N 64), L 128 at (P 64, N 128).  A block
// of L / 64 warpgroups; warpgroup w owns rows 64w .. 64w + 63 of the
// chunk's outputs and the columns w NT / W .. of the state.  C, B and X
// are copied in 16-byte pieces (cp.async, zero past S, P and N) into
// shared memory under the 128-byte swizzle, which the wgmma descriptors
// read; chunk j + 1's copies are issued as soon as chunk j is done with
// each buffer, and its a is read into a register.  The four products run
// on wgmma m64nNk16 with f32 accumulators:
//   S = C B^T: C and B K-major (over N), as they lie;
//   y = C state^T: B is the state, K-major, kept in shared memory as a
//     bf16 pair (below); the rows are scaled by e^{seg_t} afterwards, so
//     C stays exact.  Both are issued before the decay tables are built
//     and waited for after;
//   y += M X with M = S * L from registers (as K6's P V), X read N-major
//     through the transpose bit;
//   state = e^{seg_end} state + (W X)^T B: A is W X (MN-major, the
//     transpose bit on A) and B is B (MN-major); the state's f32
//     accumulator stays in registers across the chunks.
// Every wgmma is issued on a path the whole block takes (a branch on the
// warpgroup or the chunk made ptxas serialise them), so a warpgroup also
// runs the k-steps of M X above its rows and the state update after a
// segment's last chunk.  y is staged in shared memory and written as
// 16-byte rows.  M, the state and W X are f32 values, and a bf16 rounding
// of them (about 2^-9 of a term) would not hold the bf16 bound near
// outputs that cancel (tests/test_torch_ssm.py shows it on the CPU).  So
// each is split into a bf16 pair, hi = bf16(v) and lo = bf16(v - hi), and
// both go into the same accumulator: the error falls to about 2^-17 of a
// term, at twice the tensor work of those three products (about 43 GFLOP
// in all at the training shape, 0.044 ms at the bf16 peak).  This route
// takes P and N multiples of 8 (zero-padded to the instance's widths),
// the strides of x, b and c but the last multiples of 8, and
// 16-byte-aligned x, b and c.  Shared memory: C and B L NT 2 bytes each,
// X, the W X pair and y L PT 2 bytes each, the state pair PT NT 2 bytes
// each, and the decay tables: 103 KB at (64, 64, 128), two blocks an SM;
// 119 KB at (64, 128, 64) and 175 KB at (128, 64, 128) (256 threads), one.
// ptxas (sm_90a): the (C) instances 255 registers, with a 32-byte
// (64, 64, 128), 104-byte (128, 64, 128) and 232-byte (64, 128, 64)
// stack of spills; the (A) instances 177, 168 and 177, no spills.
//
// simt_l64 — f32 (IEEE FMAs, never TF32: the f32 bound is 1e-5 of the
// largest output), and bf16 rows the wgmma route cannot take, in chunks
// of 64 whatever chunk the call names (a 128-position f32 chunk staged as
// below needs about 270 KB of shared memory, above the 227 KB a block may
// have).  The same (A), (B), (C) launches, with 256 threads a block:
// per chunk x, b (transposed), c and a are staged as f32, and each
// thread owns a register tile of the three products:
//   1. M = (C B^T) * L, 64 x 64, 0 above the diagonal; thread (ty, tx) of
//      a 16 x 16 grid owns rows 4ty..4ty+3 and columns tx + 16j, reading
//      C as float4 and B^T along columns, so neither read conflicts on a
//      bank;
//   2. y = M X + e^{seg} C state^T, rows 4ty..4ty+3 and channels tx + 16k;
//      the M X loop stops at the thread's last row (M is 0 beyond it);
//   3. state = e^{seg_end} state + (X e^{seg_end - seg})^T B, state rows
//      n = ty + 16i and channels p = tx + 16k, each entry owned by one
//      thread, after every read of the old state.
// ptxas: 80-168 registers, no spills.  Every sum runs in a fixed order,
// so a result is deterministic.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

// ---------------------------------------------------------------------------
// the decay tables of a chunk
// ---------------------------------------------------------------------------

template <int L>
struct Decay {
  static constexpr int kNB = L / 8;   // blocks of 8 positions
  float av[L];                        // a
  float sin[L * 8];                   // [k][m]: a_k + ... + a_{8(k/8)+m}
  float ein[L * 8];                   // e^{sin}
  float pre[L], epre[L];              // a of k's block up to k, e^{pre}
  float suf[L], esuf[L];              // a of k's block from k, e^{suf}
  float mid[kNB * kNB];               // [i][j]: whole blocks i+1 .. j-1
  float emid[kNB * kNB];              // e^{mid}
  float eseg[L];                      // e^{a_0 + ... + a_t}
  float w[L];                         // e^{a_{s+1} + ... + a_{L-1}}
  float dtot;                         // e^{a_0 + ... + a_{L-1}}
};

// a_lo + ... + a_hi (lo <= hi), as at most three partial sums of a.
template <int L>
__device__ __forceinline__ float seg_sum(const Decay<L>& d, int lo, int hi) {
  const int bl = lo >> 3, bh = hi >> 3;
  return bl == bh ? d.sin[lo * 8 + (hi & 7)]
                  : (d.suf[lo] + d.mid[bl * Decay<L>::kNB + bh]) + d.pre[hi];
}

// e^{a_lo + ... + a_hi} (lo <= hi): one table entry inside a block of 8,
// else the product of the three partial sums' exponentials.  Both are read
// and one is selected, with no branch.
template <int L>
__device__ __forceinline__ float decay(const Decay<L>& d, int lo, int hi) {
  const int bl = lo >> 3, bh = hi >> 3;
  const float inside = d.ein[lo * 8 + (hi & 7)];
  const float across =
      d.esuf[lo] * d.emid[bl * Decay<L>::kNB + bh] * d.epre[hi];
  return bl == bh ? inside : across;
}

// Fills the tables from d.av (written and synchronised by the caller);
// every thread of the block calls it.  Thread k < L sums its block's a
// from k onward (and up to k) in registers.
template <int L>
__device__ void decay_tables(Decay<L>& d, int tid, int nthreads) {
  constexpr int kNB = Decay<L>::kNB;
  if (tid < L) {
    const int k = tid, b0 = k & ~7;
    float v[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) v[m] = d.av[b0 + m];
    float r = 0.f, p = 0.f;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      if (b0 + m >= k) {
        r = b0 + m == k ? v[m] : r + v[m];
        d.sin[k * 8 + m] = r;
        d.ein[k * 8 + m] = expf(r);
      }
      if (b0 + m <= k) p = m == 0 ? v[0] : p + v[m];
    }
    d.suf[k] = r;
    d.esuf[k] = expf(r);
    d.pre[k] = p;
    d.epre[k] = expf(p);
  }
  __syncthreads();
  for (int i = tid; i < kNB * kNB; i += nthreads) {
    const int bl = i / kNB, bh = i % kNB;
    float m = 0.f;
    for (int b = bl + 1; b < bh; ++b) m += d.suf[8 * b];
    d.mid[i] = m;
    d.emid[i] = expf(m);
  }
  __syncthreads();
  for (int k = tid; k < L; k += nthreads) {
    d.eseg[k] = expf(seg_sum(d, 0, k));
    d.w[k] = k + 1 < L ? expf(seg_sum(d, k + 1, L - 1)) : 1.f;
  }
  if (tid == 0) d.dtot = expf(seg_sum(d, 0, L - 1));
  __syncthreads();
}

// The chunk's a at position s (0 past S).
__device__ __forceinline__ float load_a(const float* ap, long long sas,
                                        int s0, int s, int S) {
  return s0 + s < S ? ap[(s0 + s) * sas] : 0.f;
}

// Segment k of a head covers chunks [k Q, min(nc, (k + 1) Q)).
struct Segments {
  int nc, nseg, q;
};

// The workspace of a launch: (nseg - 1) f32 states of P x N a head, then
// the (nseg - 1) segment decays a head.
__device__ __forceinline__ float* state_slot(float* work, int bh, int nseg,
                                             int k, int PN) {
  return work + (static_cast<size_t>(bh) * (nseg - 1) + k) * PN;
}
__device__ __forceinline__ float* decay_slot(float* work, int BH, int bh,
                                             int nseg, int k, int PN) {
  return work + static_cast<size_t>(BH) * (nseg - 1) * PN +
         static_cast<size_t>(bh) * (nseg - 1) + k;
}

// (B): state_in(k + 1) = D_k state_in(k) + S_k, in place, one thread an
// entry of a head's state.
constexpr int kCombineThreads = 256;

__global__ void __launch_bounds__(kCombineThreads)
    ssd_combine_kernel(float* __restrict__ work, int BH, int nseg, int PN) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kCombineThreads + threadIdx.x;
  if (i >= static_cast<long long>(BH) * PN) return;
  const int bh = static_cast<int>(i / PN), e = static_cast<int>(i % PN);
  float run = 0.f;
  for (int k = 0; k + 1 < nseg; ++k) {
    float* st = state_slot(work, bh, nseg, k, PN) + e;
    run = *decay_slot(work, BH, bh, nseg, k, PN) * run + *st;
    *st = run;
  }
}

struct Strides {
  long long xb, xs, xh, ab, as, ah, bb, bs, bg, cb, cs, cg;
};

// Pointers of one (batch, head) and the head's group.
template <typename T>
struct HeadPtrs {
  const T* x;
  const float* a;
  const T* b;
  const T* c;
  T* y;
  __device__ HeadPtrs(const T* x_, const float* a_, const T* b_, const T* c_,
                      T* y_, int bh, int S, int H, int G, int P,
                      const Strides& d) {
    const int bi = bh / H, h = bh % H, g = h / (H / G);
    x = x_ + bi * d.xb + h * d.xh;
    a = a_ + bi * d.ab + h * d.ah;
    b = b_ + bi * d.bb + g * d.bg;
    c = c_ + bi * d.cb + g * d.cg;
    y = y_ + (static_cast<size_t>(bi) * S * H + h) * P;
  }
};

// ---------------------------------------------------------------------------
// simt_l64: f32 FMAs
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kLC = 64;         // positions per staged chunk
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kBP = kLC + 1;    // pitch of B^T rows (conflict-free stores)
constexpr int kMP = kLC + 4;    // pitch of the rows of M

// bytes of shared memory for P padded to PT and N to NT
constexpr int smem_bytes(int PT, int NT) {
  return (kLC * (NT + 4) + kLC * PT + NT * kBP + kLC * kMP + NT * PT) * 4 +
         static_cast<int>(sizeof(Decay<kLC>));
}

// kOut: the outputs launch (C); else the states launch (A).
template <typename T, int PT, int NT, bool kOut>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ a,
               const T* __restrict__ b, const T* __restrict__ c,
               T* __restrict__ y, float* __restrict__ work, int S, int H,
               int G, int P, int N, Segments sg, Strides d) {
  constexpr int CP = NT + 4;    // pitch of C rows: 16-byte aligned
  constexpr int NK = PT / 16;   // channels p per thread
  constexpr int NI = NT / 16;   // state rows n per thread
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);   // [kLC][CP]
  float* xs = cs + kLC * CP;                     // [kLC][PT]
  float* bt = xs + kLC * PT;                     // [NT][kBP]
  float* ms = bt + NT * kBP;                     // [kLC][kMP]
  float* st = ms + kLC * kMP;                    // [NT][PT]: the state^T
  Decay<kLC>& dec = *reinterpret_cast<Decay<kLC>*>(st + NT * PT);

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x, k = blockIdx.y, BH = gridDim.x;
  const int nseg = sg.nseg, PN = P * N;
  const HeadPtrs<T> hp(x, a, b, c, y, bh, S, H, G, P, d);
  const size_t ys = static_cast<size_t>(H) * P;  // y's row stride
  const int j0 = k * sg.q, j1 = min(sg.nc, j0 + sg.q);

  if (kOut && k > 0) {
    const float* src = state_slot(work, bh, nseg, k - 1, PN);
    for (int i = tid; i < NT * PT; i += kThreads) {
      const int n = i / PT, p = i % PT;
      st[i] = (p < P && n < N) ? src[p * N + n] : 0.f;
    }
  } else {
    for (int i = tid; i < NT * PT; i += kThreads) st[i] = 0.f;
  }
  float dseg = 1.f;

  for (int j = j0; j < j1; ++j) {
    const int s0 = j * kLC, rows = min(kLC, S - s0);
    const bool update = !kOut || j + 1 < j1;
    __syncthreads();   // the previous chunk's tiles and state are written
    for (int i = tid; i < kLC * PT; i += kThreads) {
      const int s = i / PT, p = i % PT;
      xs[i] = (s < rows && p < P) ? to_f32(hp.x[(s0 + s) * d.xs + p]) : 0.f;
    }
    for (int i = tid; i < kLC * NT; i += kThreads) {
      const int s = i / NT, n = i % NT;
      const bool in = s < rows && n < N;
      bt[n * kBP + s] = in ? to_f32(hp.b[(s0 + s) * d.bs + n]) : 0.f;
      if (kOut) cs[s * CP + n] = in ? to_f32(hp.c[(s0 + s) * d.cs + n]) : 0.f;
    }
    if (tid < kLC) dec.av[tid] = load_a(hp.a, d.as, s0, tid, S);
    __syncthreads();
    decay_tables(dec, tid, kThreads);
    dseg *= dec.dtot;

    if (kOut) {
      // 1. M = (C B^T) * L, L on and below the diagonal (no exponential
      //    is taken above it)
      {
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
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
            for (int jj = 0; jj < 4; ++jj)
              bv[jj] = bt[(n + dd) * kBP + tx + 16 * jj];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float cd = dd == 0 ? cv[i].x : dd == 1 ? cv[i].y
                             : dd == 2 ? cv[i].z : cv[i].w;
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                sc[i][jj] = fmaf(cd, bv[jj], sc[i][jj]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 4 * ty + i;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int s = tx + 16 * jj;
            ms[t * kMP + s] = s < t ? sc[i][jj] * decay(dec, s + 1, t)
                            : s == t ? sc[i][jj] : 0.f;
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
          for (int kk = 0; kk < NK; ++kk) acc[i][kk] = 0.f;
        const int s_end = 4 * ty + 4;   // M[t, s] = 0 for s > t
        for (int s = 0; s < s_end; ++s) {
          float mv[4], xv[NK];
#pragma unroll
          for (int i = 0; i < 4; ++i) mv[i] = ms[(4 * ty + i) * kMP + s];
#pragma unroll
          for (int kk = 0; kk < NK; ++kk) xv[kk] = xs[s * PT + tx + 16 * kk];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int kk = 0; kk < NK; ++kk)
              acc[i][kk] = fmaf(mv[i], xv[kk], acc[i][kk]);
        }
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = dec.eseg[4 * ty + i];
#pragma unroll 4
        for (int n = 0; n < NT; ++n) {
          float cv[4], sv[NK];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = cs[(4 * ty + i) * CP + n] * e[i];
#pragma unroll
          for (int kk = 0; kk < NK; ++kk) sv[kk] = st[n * PT + tx + 16 * kk];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int kk = 0; kk < NK; ++kk)
              acc[i][kk] = fmaf(cv[i], sv[kk], acc[i][kk]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 4 * ty + i;
          if (t >= rows) continue;
#pragma unroll
          for (int kk = 0; kk < NK; ++kk) {
            const int p = tx + 16 * kk;
            if (p < P) hp.y[(s0 + t) * ys + p] = from_f32<T>(acc[i][kk]);
          }
        }
      }
      __syncthreads();   // every read of the old state is done
    }

    // 3. state = e^{seg_end} state + (X e^{seg_end - seg})^T B
    if (update) {
      const float dtot = dec.dtot;
      float acc[NI][NK];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
          acc[i][kk] = dtot * st[(ty + 16 * i) * PT + tx + 16 * kk];
#pragma unroll 2
      for (int s = 0; s < kLC; ++s) {
        const float w = dec.w[s];
        float xv[NK], bv[NI];
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) xv[kk] = xs[s * PT + tx + 16 * kk] * w;
#pragma unroll
        for (int i = 0; i < NI; ++i) bv[i] = bt[(ty + 16 * i) * kBP + s];
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int kk = 0; kk < NK; ++kk)
            acc[i][kk] = fmaf(bv[i], xv[kk], acc[i][kk]);
      }
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
          st[(ty + 16 * i) * PT + tx + 16 * kk] = acc[i][kk];
    }
  }

  if (!kOut) {   // the segment's end state and decay
    __syncthreads();
    float* dst = state_slot(work, bh, nseg, k, PN);
    for (int i = tid; i < NT * PT; i += kThreads) {
      const int n = i / PT, p = i % PT;
      if (p < P && n < N) dst[p * N + n] = st[i];
    }
    if (tid == 0) *decay_slot(work, BH, bh, nseg, k, PN) = dseg;
  }
}

template <typename T, int PT, int NT, bool kOut>
cudaError_t launch_pass(const void* x, const float* a, const void* b,
                        const void* c, void* y, float* work, int BH, int S,
                        int H, int G, int P, int N, const Segments& sg,
                        const Strides& d, cudaStream_t stream) {
  constexpr int smem = smem_bytes(PT, NT);
  auto kernel = ssd_kernel<T, PT, NT, kOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, kOut ? sg.nseg : sg.nseg - 1);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), work, S, H, G, P, N, sg,
      d);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// wgmma_l*_p*_n*: bf16 on the tensor cores
// ---------------------------------------------------------------------------

template <int L, int PT, int NT>
struct SsdTile {
  static_assert((L == 64 || L == 128) && (PT == 64 || PT == 128) &&
                    (NT == 64 || NT == 128), "");
  static constexpr int kW = L / 64;              // warpgroups
  static constexpr int kThreads = 128 * kW;
  static constexpr int kNW = NT / kW;            // state columns a warpgroup
  static constexpr int kCBytes = L * NT * 2;     // C, B
  static constexpr int kXBytes = L * PT * 2;     // X, W X hi, W X lo, y
  static constexpr int kSBytes = PT * NT * 2;    // state hi, state lo
  static constexpr int kC = 0;
  static constexpr int kB = kC + kCBytes;
  static constexpr int kX = kB + kCBytes;
  static constexpr int kWh = kX + kXBytes;
  static constexpr int kWl = kWh + kXBytes;
  static constexpr int kY = kWl + kXBytes;
  static constexpr int kSh = kY + kXBytes;
  static constexpr int kSl = kSh + kSBytes;
  static constexpr int kDecay = kSl + kSBytes;
  static constexpr int kSmem = kDecay + static_cast<int>(sizeof(Decay<L>)) + 1024;
  static_assert(kSmem <= 227 * 1024, "the tile must fit a block");
};

// Byte offset of element (r, c) of a bf16 tile kept as 64-column blocks
// of `rows` rows of 128 bytes, under the 128-byte swizzle (what TMA's
// SWIZZLE_128B writes and the wgmma descriptors below read).
__device__ __forceinline__ uint32_t sw_off(int r, int c, int rows) {
  return (c >> 6) * rows * 128 + r * 128 +
         ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// A K-major operand (rows of M or N, K in 64-column blocks), k-step kk of
// 16 columns, from row r0.
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int rows, int r0,
                                           int kk) {
  return sm90::make_desc(base + (kk >> 2) * rows * 128 + r0 * 128 + (kk & 3) * 32,
                         16, 1024, sm90::kSw128);
}

// An MN-major operand (rows of K, M or N in 64-column blocks of `rows`
// rows), k-step kk of 16 rows, from column block cb.
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int rows, int cb,
                                            int kk) {
  return sm90::make_desc(base + cb * rows * 128 + kk * 16 * 128, rows * 128,
                         1024, sm90::kSw128);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// ROWS x COLS of a bf16 matrix (row r at src + r * stride) into a swizzled
// tile: zero past `nrows` rows and `ncols` columns (a multiple of 8).
template <int ROWS, int COLS>
__device__ __forceinline__ void copy_tile(uint8_t* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int nrows,
                                          int ncols, int tid, int nthreads) {
  constexpr int kVecs = COLS / 8;
  for (int i = tid; i < ROWS * kVecs; i += nthreads) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    const bool in = r < nrows && c < ncols;
    cp_async16(dst + sw_off(r, c, ROWS), in ? src + r * stride + c : src, in);
  }
}

// v as a bf16 pair: hi = bf16(v), lo = bf16(v - hi), two values a word.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  const float2 f = __bfloat1622float2(h);
  lo = sm90::pack_bf16(v0 - f.x, v1 - f.y);
}

template <int kN>
__device__ __forceinline__ void keep_regs(const uint32_t (&r)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
    asm volatile("" ::"r"(r[i][0]), "r"(r[i][1]), "r"(r[i][2]), "r"(r[i][3])
                 : "memory");
}

// The state's accumulator (PT rows of p in slices of 64, this warpgroup's
// kNW columns of n) as a bf16 pair in the K-major tiles sh, sl.
template <int L, int PT, int NT>
__device__ __forceinline__ void store_state(
    uint8_t* sh, uint8_t* sl,
    const float (&acc)[PT / 64][SsdTile<L, PT, NT>::kNW / 2], int wg,
    int warp, int lane) {
  constexpr int kNW = SsdTile<L, PT, NT>::kNW;
#pragma unroll
  for (int i = 0; i < PT / 64; ++i)
#pragma unroll
    for (int j = 0; j < kNW / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 64 * i + 16 * warp + lane / 4 + 8 * r;
        const int n = wg * kNW + 8 * j + 2 * (lane % 4);
        uint32_t hi, lo;
        split2(acc[i][4 * j + 2 * r], acc[i][4 * j + 2 * r + 1], hi, lo);
        const uint32_t off = sw_off(p, n, PT);
        *reinterpret_cast<uint32_t*>(sh + off) = hi;
        *reinterpret_cast<uint32_t*>(sl + off) = lo;
      }
}

// Every wgmma below is issued on a path that the whole block takes (no
// branch on the warpgroup, the chunk or whether a state has come in), so
// ptxas keeps them asynchronous.
template <int L, int PT, int NT, bool kOut>
__global__ void __launch_bounds__(SsdTile<L, PT, NT>::kThreads, 1)
    ssd_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ a,
                     const __nv_bfloat16* __restrict__ b,
                     const __nv_bfloat16* __restrict__ c,
                     __nv_bfloat16* __restrict__ y, float* __restrict__ work,
                     int S, int H, int G, int P, int N, Segments sg,
                     Strides d) {
  using T = SsdTile<L, PT, NT>;
  using namespace sm90;
  constexpr int kNW = T::kNW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sm = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* cs = sm + T::kC;
  uint8_t* bs = sm + T::kB;
  uint8_t* xs = sm + T::kX;
  uint8_t* wh = sm + T::kWh;
  uint8_t* wl = sm + T::kWl;
  uint8_t* ys = sm + T::kY;
  uint8_t* sh = sm + T::kSh;
  uint8_t* sl = sm + T::kSl;
  Decay<L>& dec = *reinterpret_cast<Decay<L>*>(sm + T::kDecay);
  const uint32_t cs_a = smem_u32(cs), bs_a = smem_u32(bs),
                 xs_a = smem_u32(xs), wh_a = smem_u32(wh),
                 wl_a = smem_u32(wl), sh_a = smem_u32(sh),
                 sl_a = smem_u32(sl);

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32,
            lane = tid % 32;
  const int bh = blockIdx.x, k = blockIdx.y, BH = gridDim.x;
  const int nseg = sg.nseg, PN = P * N;
  const HeadPtrs<__nv_bfloat16> hp(x, a, b, c, y, bh, S, H, G, P, d);
  const size_t ystride = static_cast<size_t>(H) * P;   // y's row stride
  const int j0 = k * sg.q, j1 = min(sg.nc, j0 + sg.q);
  // this thread's rows of the accumulator fragments: r and r + 8
  const int r_lo = 16 * warp + lane / 4, c_lo = 2 * (lane % 4);

  // the state's f32 accumulator: rows p = 64 i + r, columns wg kNW + n;
  // the outputs pass starts from its segment's incoming state (0 for the
  // first segment), the states pass from 0
  float sacc[PT / 64][kNW / 2];
  const float* src = kOut && k > 0 ? state_slot(work, bh, nseg, k - 1, PN)
                                   : nullptr;
#pragma unroll
  for (int i = 0; i < PT / 64; ++i)
#pragma unroll
    for (int j = 0; j < kNW / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 64 * i + r_lo + 8 * r, n = wg * kNW + 8 * j + c_lo;
        float2 v = make_float2(0.f, 0.f);
        if (src != nullptr && p < P && n < N)
          v = *reinterpret_cast<const float2*>(src + p * N + n);
        sacc[i][4 * j + 2 * r] = v.x;
        sacc[i][4 * j + 2 * r + 1] = v.y;
      }
  if constexpr (kOut) {
    store_state<L, PT, NT>(sh, sl, sacc, wg, warp, lane);
    fence_async_smem();
  }
  float dseg = 1.f;

  // The copies of chunk j + 1's tiles are issued as soon as chunk j is
  // done with each buffer (C after C B^T and C state^T, X after the
  // outputs are written, B after the state update), and its a is read
  // into a register: they land while chunk j computes.
  auto copy_c = [&](int jc) {
    if constexpr (kOut)
      copy_tile<L, NT>(cs, hp.c + jc * L * d.cs, d.cs, min(L, S - jc * L), N,
                       tid, T::kThreads);
  };
  auto copy_b = [&](int jc) {
    copy_tile<L, NT>(bs, hp.b + jc * L * d.bs, d.bs, min(L, S - jc * L), N,
                     tid, T::kThreads);
  };
  auto copy_x = [&](int jc) {
    copy_tile<L, PT>(xs, hp.x + jc * L * d.xs, d.xs, min(L, S - jc * L), P,
                     tid, T::kThreads);
  };
  copy_c(j0);
  copy_b(j0);
  copy_x(j0);
  float a_next = tid < L ? load_a(hp.a, d.as, j0 * L, tid, S) : 0.f;

  for (int j = j0; j < j1; ++j) {
    const int s0 = j * L, rows = min(L, S - s0);
    const bool more = j + 1 < j1;
    __syncthreads();   // the previous chunk is done with the tables
    if (tid < L) {
      dec.av[tid] = a_next;
      if (more) a_next = load_a(hp.a, d.as, s0 + L, tid, S);
    }
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();

    // S = C B^T (rows 64 wg .. of the chunk, all L columns) and y = C
    // state^T, issued now and waited for after the decay tables and W X
    float sacc_s[kOut ? L / 2 : 1], yacc[kOut ? PT / 2 : 1];
    if constexpr (kOut) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NT / 16; ++kk)
        WgmmaSS<L>::template mma<0>(sacc_s, desc_k(cs_a, L, 64 * wg, kk),
                                    desc_k(bs_a, L, 0, kk), kk > 0 ? 1 : 0);
#pragma unroll
      for (int kk = 0; kk < NT / 16; ++kk)
        WgmmaSS<PT>::template mma<0>(yacc, desc_k(cs_a, L, 64 * wg, kk),
                                     desc_k(sh_a, PT, 0, kk), kk > 0 ? 1 : 0);
#pragma unroll
      for (int kk = 0; kk < NT / 16; ++kk)
        WgmmaSS<PT>::template mma<0>(yacc, desc_k(cs_a, L, 64 * wg, kk),
                                     desc_k(sl_a, PT, 0, kk), 1);
      wgmma_commit();
    }

    decay_tables(dec, tid, T::kThreads);
    dseg *= dec.dtot;

    // W X as a bf16 pair, W = e^{seg_end - seg_s} by row
    for (int i = tid; i < L * PT / 8; i += T::kThreads) {
      const int r = i / (PT / 8), cc = (i % (PT / 8)) * 8;
      const uint32_t off = sw_off(r, cc, L);
      const uint4 v = *reinterpret_cast<const uint4*>(xs + off);
      const uint32_t in[4] = {v.x, v.y, v.z, v.w};
      const float w = dec.w[r];
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&in[q]));
        split2(f.x * w, f.y * w, hi[q], lo[q]);
      }
      *reinterpret_cast<uint4*>(wh + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(wl + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    fence_async_smem();

    if constexpr (kOut) {
      wgmma_wait<0>();
      fence_regs(sacc_s);
      fence_regs(yacc);
      __syncthreads();   // W X is written; every warpgroup is done with C
      if (more) copy_c(j + 1);

      // rows t = 64 wg + r_lo (+ 8): y's state part times e^{seg_t}
      const int t0 = 64 * wg + r_lo;
      const float e0 = dec.eseg[t0], e1 = dec.eseg[t0 + 8];
#pragma unroll
      for (int q = 0; q < PT / 2; ++q) yacc[q] *= (q & 2) ? e1 : e0;

      // M = S * L, 0 above the diagonal, as a bf16 pair of A fragments
      uint32_t mh[L / 16][4], ml[L / 16][4];
#pragma unroll
      for (int kk = 0; kk < L / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = t0 + 8 * (q & 1);
          const int jj = 2 * kk + q / 2;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * jj + c_lo + e;
            const float sv = sacc_s[4 * jj + 2 * (q & 1) + e];
            // L[t, col]: 1 on the diagonal, 0 above it (no exponential
            // is taken there: the table is read at a valid (t, t))
            const float dv = decay(dec, min(col + 1, t), t);
            v[e] = col > t ? 0.f : col == t ? sv : sv * dv;
          }
          split2(v[0], v[1], mh[kk][q], ml[kk][q]);
        }

      // y += M X
      fence_regs(yacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L / 16; ++kk) {
        WgmmaRS<PT>::template mma<1>(yacc, mh[kk], desc_mn(xs_a, L, 0, kk), 1);
        WgmmaRS<PT>::template mma<1>(yacc, ml[kk], desc_mn(xs_a, L, 0, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(yacc);
      keep_regs(mh);
      keep_regs(ml);

      // y through shared memory, so that rows go out as 16-byte pieces
#pragma unroll
      for (int jj = 0; jj < PT / 8; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(ys + sw_off(t0 + 8 * r, 8 * jj + c_lo, L)) =
              pack_bf16(yacc[4 * jj + 2 * r], yacc[4 * jj + 2 * r + 1]);
      __syncthreads();   // y is staged; every warpgroup is done with X
      if (more) copy_x(j + 1);
      for (int i = tid; i < L * PT / 8; i += T::kThreads) {
        const int r = i / (PT / 8), cc = (i % (PT / 8)) * 8;
        if (r < rows && cc < P)
          *reinterpret_cast<uint4*>(hp.y + (s0 + r) * ystride + cc) =
              *reinterpret_cast<const uint4*>(ys + sw_off(r, cc, L));
      }
    } else {
      __syncthreads();   // W X is written
      if (more) copy_x(j + 1);
    }

    // state = e^{seg_end} state + (W X)^T B (also after a segment's last
    // chunk, where the outputs pass does not need it: a branch there
    // would serialise the wgmma)
    const float dtot = dec.dtot;
#pragma unroll
    for (int i = 0; i < PT / 64; ++i)
#pragma unroll
      for (int q = 0; q < kNW / 2; ++q) sacc[i][q] *= dtot;
#pragma unroll
    for (int i = 0; i < PT / 64; ++i) fence_regs(sacc[i]);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < PT / 64; ++i)
#pragma unroll
      for (int kk = 0; kk < L / 16; ++kk) {
        const uint64_t db = desc_mn(bs_a, L, wg * kNW / 64, kk);
        WgmmaSS<kNW>::template mma<1, 1>(sacc[i], desc_mn(wh_a, L, i, kk),
                                         db, 1);
        WgmmaSS<kNW>::template mma<1, 1>(sacc[i], desc_mn(wl_a, L, i, kk),
                                         db, 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < PT / 64; ++i) fence_regs(sacc[i]);
    // every warpgroup is done with B, W X and the old state
    __syncthreads();
    if (more) copy_b(j + 1);
    if constexpr (kOut) {
      store_state<L, PT, NT>(sh, sl, sacc, wg, warp, lane);
      fence_async_smem();
    }
  }

  if (!kOut) {   // the segment's end state and decay
    float* dst = state_slot(work, bh, nseg, k, PN);
#pragma unroll
    for (int i = 0; i < PT / 64; ++i)
#pragma unroll
      for (int j = 0; j < kNW / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = 64 * i + r_lo + 8 * r, n = wg * kNW + 8 * j + c_lo;
          if (p < P && n < N)
            *reinterpret_cast<float2*>(dst + p * N + n) =
                make_float2(sacc[i][4 * j + 2 * r], sacc[i][4 * j + 2 * r + 1]);
        }
    if (tid == 0) *decay_slot(work, BH, bh, nseg, k, PN) = dseg;
  }
}

template <int L, int PT, int NT, bool kOut>
cudaError_t launch_wgmma_pass(const void* x, const float* a, const void* b,
                              const void* c, void* y, float* work, int BH,
                              int S, int H, int G, int P, int N,
                              const Segments& sg, const Strides& d,
                              cudaStream_t stream) {
  using T = SsdTile<L, PT, NT>;
  auto kernel = ssd_wgmma_kernel<L, PT, NT, kOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, kOut ? sg.nseg : sg.nseg - 1);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), a,
      static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(c), static_cast<__nv_bfloat16*>(y),
      work, S, H, G, P, N, sg, d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the instances
// ---------------------------------------------------------------------------

// (A), (B) and (C) in turn on the stream.
template <typename States, typename Outputs>
cudaError_t run_passes(States states, Outputs outputs, float* work, int BH,
                       int P, int N, const Segments& sg, cudaStream_t stream) {
  if (sg.nseg > 1) {
    cudaError_t err = states();
    if (err != cudaSuccess) return err;
    const long long n = static_cast<long long>(BH) * P * N;
    ssd_combine_kernel<<<static_cast<unsigned>((n + kCombineThreads - 1) /
                                               kCombineThreads),
                         kCombineThreads, 0, stream>>>(work, BH, sg.nseg,
                                                       P * N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return outputs();
}

struct Call {
  const void *x, *b, *c;
  const float* a;
  void* y;
  float* work;
  int BH, S, H, G, P, N;
  Strides d;
  cudaStream_t stream;
};

using Launcher = cudaError_t (*)(const Call&, int nseg, int dtype);
// Blocks of a tiling's outputs kernel that the card holds at once, for
// P, N and dtype: its occupancy times the SMs.
using Slots = cudaError_t (*)(int P, int N, int dtype, int* slots);

// Each head's nc chunks cut into at most `nseg` segments of q chunks,
// q = ceil(nc / nseg), and so into ceil(nc / q) segments, none empty
// (nc 6 asked for 4 runs 3 of 2).
Segments segments(int S, int L, int nseg) {
  Segments sg;
  sg.nc = (S + L - 1) / L;
  sg.q = (sg.nc + nseg - 1) / nseg;
  sg.nseg = (sg.nc + sg.q - 1) / sg.q;
  return sg;
}

// As many segments as keep one wave of the `slots` resident blocks busy
// (a block's walk is a chain, so the launch takes about one block's
// chain), at least 1, at most `cap` (0: no cap) and at most one a chunk.
// When the heads alone fill the card (mamba2-1.3b's 256 at the training
// shape) this is 1, and the states pass is not run.
int wave_segments(int BH, int S, int L, int slots, int cap) {
  int n = slots / BH;
  if (cap > 0 && n > cap) n = cap;
  return segments(S, L, n < 1 ? 1 : n).nseg;
}

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, int smem,
                            int* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  *slots = per_sm * sms;
  return err;
}

template <typename T, int PT, int NT>
cudaError_t launch_simt_t(const Call& k, const Segments& sg) {
  return run_passes(
      [&] {
        return simt::launch_pass<T, PT, NT, false>(
            k.x, k.a, k.b, k.c, k.y, k.work, k.BH, k.S, k.H, k.G, k.P, k.N,
            sg, k.d, k.stream);
      },
      [&] {
        return simt::launch_pass<T, PT, NT, true>(
            k.x, k.a, k.b, k.c, k.y, k.work, k.BH, k.S, k.H, k.G, k.P, k.N,
            sg, k.d, k.stream);
      },
      k.work, k.BH, k.P, k.N, sg, k.stream);
}

template <typename T, int PT_, int NT_>
struct SimtInstance {
  using Type = T;
  static constexpr int PT = PT_, NT = NT_;
};

// Two tile widths each (the kernel masks P < PT and N < NT with zeros).
template <typename T, typename F>
cudaError_t simt_dispatch(int P, int N, F f) {
  if (P <= 64)
    return N <= 64 ? f(SimtInstance<T, 64, 64>{})
                   : f(SimtInstance<T, 64, 128>{});
  return N <= 64 ? f(SimtInstance<T, 128, 64>{})
                 : f(SimtInstance<T, 128, 128>{});
}

template <typename F>
cudaError_t simt_dispatch(int P, int N, int dtype, F f) {
  return dtype == kF32 ? simt_dispatch<float>(P, N, f)
                       : simt_dispatch<__nv_bfloat16>(P, N, f);
}

cudaError_t launch_simt(const Call& k, int nseg, int dtype) {
  const Segments sg = segments(k.S, simt::kLC, nseg);
  if (sg.nseg > 1 && k.work == nullptr) return cudaErrorInvalidValue;
  return simt_dispatch(k.P, k.N, dtype, [&](auto inst) {
    using I = decltype(inst);
    return launch_simt_t<typename I::Type, I::PT, I::NT>(k, sg);
  });
}

cudaError_t simt_slots(int P, int N, int dtype, int* slots) {
  return simt_dispatch(P, N, dtype, [&](auto inst) {
    using I = decltype(inst);
    static int cached = 0;   // one for each instance
    if (cached == 0) {
      constexpr int PT = I::PT, NT = I::NT;
      const cudaError_t err = resident_blocks(
          simt::ssd_kernel<typename I::Type, PT, NT, true>, simt::kThreads,
          simt::smem_bytes(PT, NT), &cached);
      if (err != cudaSuccess) return err;
    }
    *slots = cached;
    return cudaSuccess;
  });
}

template <int L, int PT, int NT>
cudaError_t launch_wgmma(const Call& k, int nseg, int dtype) {
  const Segments sg = segments(k.S, L, nseg);
  const Strides& d = k.d;
  if (dtype != kBF16 || (sg.nseg > 1 && k.work == nullptr) || k.P > PT ||
      k.N > NT ||
      k.P % 8 || k.N % 8 || !aligned(k.x, 16) || !aligned(k.b, 16) ||
      !aligned(k.c, 16) || !aligned(k.y, 16) ||
      (d.xb | d.xs | d.xh | d.bb | d.bs | d.bg | d.cb | d.cs | d.cg) % 8)
    return cudaErrorInvalidValue;   // what the 16-byte copies cannot take
  return run_passes(
      [&] {
        return launch_wgmma_pass<L, PT, NT, false>(
            k.x, k.a, k.b, k.c, k.y, k.work, k.BH, k.S, k.H, k.G, k.P, k.N,
            sg, d, k.stream);
      },
      [&] {
        return launch_wgmma_pass<L, PT, NT, true>(
            k.x, k.a, k.b, k.c, k.y, k.work, k.BH, k.S, k.H, k.G, k.P, k.N,
            sg, d, k.stream);
      },
      k.work, k.BH, k.P, k.N, sg, k.stream);
}

template <int L, int PT, int NT>
cudaError_t wgmma_slots(int, int, int, int* slots) {
  static int cached = 0;
  if (cached == 0) {
    using T = SsdTile<L, PT, NT>;
    const cudaError_t err = resident_blocks(
        ssd_wgmma_kernel<L, PT, NT, true>, T::kThreads, T::kSmem, &cached);
    if (err != cudaSuccess) return err;
  }
  *slots = cached;
  return cudaSuccess;
}

// The tilings a call may name, by id (kernels/ssd.py::TILINGS lists the
// same names in the same order).  Id 0 is the SIMT kernel, in f32 or
// bf16; every other id a bf16 wgmma instance.
struct Tiling {
  const char* name;
  int chunk;
  Launcher launch;
  Slots slots;
};
const Tiling kTilings[] = {
    {"simt_l64", simt::kLC, &launch_simt, &simt_slots},
    {"wgmma_l64_p64_n128", 64, &launch_wgmma<64, 64, 128>,
     &wgmma_slots<64, 64, 128>},
    {"wgmma_l128_p64_n128", 128, &launch_wgmma<128, 64, 128>,
     &wgmma_slots<128, 64, 128>},
    {"wgmma_l64_p128_n64", 64, &launch_wgmma<64, 128, 64>,
     &wgmma_slots<64, 128, 64>},
};
constexpr int kNumTilings = sizeof(kTilings) / sizeof(kTilings[0]);

}  // namespace
}  // namespace repro

// The tiling names by id, comma-separated.
extern "C" const char* repro_ssd_tilings() {
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

namespace {
bool call_ok(int B, int H, int G, int P, int N, int tiling, int dtype) {
  using namespace repro;
  return tiling >= 0 && tiling < kNumTilings &&
         (dtype == kF32 || dtype == kBF16) &&
         (dtype != kF32 || tiling == 0) &&   // f32 is SIMT only
         G > 0 && H % G == 0 && P > 0 && P <= 128 && N > 0 && N <= 128 &&
         static_cast<long long>(B) * H <= 0x7fffffffLL;
}
}  // namespace

// The segments that a call of `tiling` cuts each head's sequence into
// (at most `max_segments`; 0: as many as fill one wave), for sizing the
// workspace of repro_ssd.  Returns the count (>= 1), or minus a
// cudaError_t.
extern "C" int repro_ssd_segments(int B, int S, int H, int G, int P, int N,
                                  int max_segments, int tiling, int dtype) {
  using namespace repro;
  if (max_segments < 0 || !call_ok(B, H, G, P, N, tiling, dtype))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return 1;
  int slots = 0;
  const cudaError_t err = kTilings[tiling].slots(P, N, dtype, &slots);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return wave_segments(B * H, S, kTilings[tiling].chunk, slots,
                       max_segments);
}

// x: (B, S, H, P), a: (B, S, H) f32, b, c: (B, S, G, N), each with the
// element strides given (batch, sequence, head or group; the last axis
// contiguous); y: (B, S, H, P) contiguous.  x, b, c and y share `dtype`.
// The sequence is cut into at most `nseg` (>= 1) segments of chunks
// (repro_ssd_segments says how many fill the card); `work` holds
// (nseg - 1) * B * H * (P * N + 1) floats (unused, and may be null, when
// nseg is 1).  Run by the kernels of `tiling` (an id of
// repro_ssd_tilings()).  Returns a cudaError_t.
extern "C" int repro_ssd(const void* x, const void* a, const void* b,
                         const void* c, void* y, void* work, int B, int S,
                         int H, int G, int P, int N, long long sxb,
                         long long sxs, long long sxh, long long sab,
                         long long sas, long long sah, long long sbb,
                         long long sbs, long long sbg, long long scb,
                         long long scs, long long scg, int nseg, int tiling,
                         int dtype, void* stream) {
  using namespace repro;
  if (nseg < 1 || !call_ok(B, H, G, P, N, tiling, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return static_cast<int>(cudaSuccess);
  const Call k{x, b, c, static_cast<const float*>(a), y,
               static_cast<float*>(work), B * H, S, H, G, P, N,
               Strides{sxb, sxs, sxh, sab, sas, sah, sbb, sbs, sbg, scb, scs,
                       scg},
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(kTilings[tiling].launch(k, nseg, dtype));
}
