// The persistent bf16 GEMM on the tensor cores that K2, K3 and K4 share
// (gemm.cu holds K3's and K4's notes and instances, fused_ff.cu K2's):
// C[b] = epilogue(A[b] @ B[b]) with f32 accumulation in registers, A
// (M, K) and B (K, N) row-major, fed by TMA into an mbarrier ring and
// multiplied by wgmma.  Two epilogues:
//
//   plain (kDual = false): C = A @ B, or LeakyReLU of it (`leaky`);
//   dual (kDual = true):   C = silu(A @ Bg) * (A @ Bu), the SwiGLU front
//     half, with a second B operand (Bu) of B's shape.
//
// A persistent grid, one block per SM: block i takes the BM x BN output
// tiles i, i + gridDim.x, ... in the order tile_coords() gives.  One
// producer warpgroup (a single thread of it issues) walks each tile's K in
// BK-deep stages, loading the A tile (BM x BK, K-major) and the B tile(s)
// (BK x BN each, N-major) by TMA into a ring of stages (as many as fit
// beside the C tile, at most 4), each guarded by a "full" mbarrier (TMA
// bytes landed) and an "empty" one (every consumer thread is done with
// it).  The ring runs on from tile to tile, so the next tile's loads
// overlap this tile's epilogue.  Tiles are kept as 64-element-wide column
// blocks under the 128-byte swizzle, the layout wgmma reads without bank
// conflicts; the tensor maps are 3-D over (batch, rows, columns), so a
// tile that runs past an edge is zero-filled by TMA and never reads the
// next batch entry.
//
// Consumer warpgroups, plain: one or two, each owning kMI m64 slices of
// the tile's rows by all BN columns, one m64 x BN x 16 wgmma chain a slice.
// Dual: each warpgroup owns 64 rows by 128 columns of C, and the stage
// keeps, for each 128 columns of C, the two 64-column blocks of Bg and
// then the two of Bu side by side: one m64 x 256 x 16 chain over those
// four blocks computes the gate (accumulator registers 0-63) and the up
// product (64-127) of the warpgroup's columns at once, so A is read from
// shared memory once for both.  A (128, 128) tile is two warpgroups along
// M, a (64, 256) tile two along N.  Either way a consumer thread holds 128
// f32 accumulators, as the plain (128, 256) tile does.
//
// Each consumer keeps one wgmma group in flight while the previous stage
// is released.  The epilogue runs on the f32 sums in registers (LeakyReLU:
// y >= 0 ? y : slope * y; dual: g / (1 + expf(-g)) * u, the plain
// version's f32 silu), rounds once to bf16, writes the tile into its own
// shared-memory stage under the same swizzle (conflict-free 4-byte
// stores) and stores it with TMA, which clips the edges; that store
// drains while the next tile is multiplied.  With two consumer warpgroups
// the producer gives its registers to them (setmaxnreg 40 / 232).  TMA
// needs 16-byte-aligned rows: callers send K and N multiples of 8 and
// 16-byte-aligned pointers here, and anything else to a SIMT kernel.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

constexpr int kSmemBudget = 227 * 1024 - 2048;  // ring + alignment + barriers

template <int BM, int BN, int BK, bool kDual = false>
struct WgTile {
  static_assert(BM % 64 == 0 && BN % 64 == 0 && BK % 64 == 0, "64-multiples");
  static_assert(BN <= 256 && BM <= 256, "a TMA box has at most 256 rows");
  static_assert(!kDual || BN % 128 == 0, "dual: 128-column warpgroups");
  static constexpr int kWN = kDual ? 128 : BN;       // C columns a warpgroup
  static constexpr int kWGN = BN / kWN;              // warpgroups along N
  static constexpr int kWG =                         // consumer warpgroups
      kDual ? (BM / 64) * kWGN : (BM >= 128 ? 2 : 1);
  static_assert(kWG <= 2, "at most two consumer warpgroups fit the registers");
  static constexpr int kMI = kDual ? 1 : BM / (64 * kWG);  // m64 slices each
  static constexpr int kAccN = kDual ? 2 * kWN : BN;       // wgmma N
  static constexpr int kThreads = (kWG + 1) * 128;   // + the producer
  static constexpr int kABytes = BM * BK * 2;
  static constexpr int kBBlocks = (kDual ? 2 : 1) * BN / 64;  // 64-col blocks
  static constexpr int kStageBytes = kABytes + kBBlocks * BK * 128;
  static constexpr int kCBytes = BM * BN * 2;        // the C tile's stage
  static constexpr int kFit = (kSmemBudget - kCBytes) / kStageBytes;
  static constexpr int kStages = kFit > 4 ? 4 : kFit;
  static_assert(kStages >= 2, "two stages must fit");
  static constexpr int kSmem =
      kStages * kStageBytes + kCBytes + 1024 + 2 * 8 * kStages;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = sm90::smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// The persistent walk's tile `tile` -> its row tile, column tile and batch
// entry.  The batch entry varies slowest; inside it, bands of `group` row
// tiles are walked rows fastest, then columns, so that the blocks in
// flight share a few A row tiles and a few B column tiles in L2.  Group 1
// is the plain order: columns fastest, then rows.
__device__ __forceinline__ void tile_coords(int tile, int tiles_m,
                                            int tiles_n, int group, int& mt,
                                            int& nt, int& bz) {
  const int per_batch = tiles_m * tiles_n;
  bz = tile / per_batch;
  const int t = tile % per_batch;
  const int band = t / (group * tiles_n);
  const int first = band * group;
  const int rows = min(group, tiles_m - first);
  const int local = t - band * group * tiles_n;
  mt = first + local % rows;
  nt = local / rows;
}

template <int BM, int BN, int BK, bool kDual>
__global__ void __launch_bounds__(WgTile<BM, BN, BK, kDual>::kThreads, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap bmap,
                      const __grid_constant__ CUtensorMap b2map,
                      const __grid_constant__ CUtensorMap cmap, int M, int N,
                      int K, int batch, int leaky, float slope, int group) {
  using T = WgTile<BM, BN, BK, kDual>;
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint8_t* cs = ring + T::kStages * T::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(cs + T::kCBytes);
  uint64_t* empty = full + T::kStages;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int tiles_n = (N + BN - 1) / BN, tiles_m = (M + BM - 1) / BM;
  const int tiles = tiles_n * tiles_m * batch;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::kWG * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == T::kWG) {  // producer
    if constexpr (T::kWG == 2) regs_dec<40>();
    if (t == 0) {
      int g = 0;   // stages filled so far, across tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int mt, nt, bz;
        tile_coords(tile, tiles_m, tiles_n, group, mt, nt, bz);
        const int m0 = mt * BM, n0 = nt * BN;
        for (int kt = 0; kt < nk; ++kt, ++g) {
          const int s = g % T::kStages;
          mbar_wait(&empty[s], ((g / T::kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], T::kStageBytes);
          uint8_t* sa = ring + s * T::kStageBytes;
          uint8_t* sb = sa + T::kABytes;
#pragma unroll
          for (int cb = 0; cb < BK / 64; ++cb)
            tma_load_3d(sa + cb * BM * 128, &amap, &full[s],
                        kt * BK + 64 * cb, m0, bz);
#pragma unroll
          for (int cb = 0; cb < T::kBBlocks; ++cb) {
            // dual: per 128 columns of C, Bg's two blocks then Bu's two
            const bool up = kDual && cb % 4 >= 2;
            const int col = kDual ? n0 + (cb / 4) * 128 + (cb % 2) * 64
                                  : n0 + 64 * cb;
            tma_load_3d(sb + cb * BK * 128, up ? &b2map : &bmap, &full[s],
                        col, kt * BK, bz);
          }
        }
      }
    }
    return;
  }

  if constexpr (T::kWG == 2) regs_inc<232>();
  const int warp = t / 32, lane = t % 32;
  // this warpgroup's first m64 slice of the tile, and its first column
  const int wrow = kDual ? wg / T::kWGN : wg * T::kMI;
  const int wcol = kDual ? (wg % T::kWGN) * T::kWN : 0;
  float acc[T::kMI][T::kAccN / 2];
  int g = 0;   // stages consumed so far, across tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int mt, nt, bz;
    tile_coords(tile, tiles_m, tiles_n, group, mt, nt, bz);
    const int m0 = mt * BM, n0 = nt * BN;
#pragma unroll
    for (int i = 0; i < T::kMI; ++i)
#pragma unroll
      for (int j = 0; j < T::kAccN / 2; ++j) acc[i][j] = 0.f;

    int prev = -1;
    for (int kt = 0; kt < nk; ++kt, ++g) {
      const int s = g % T::kStages;
      mbar_wait(&full[s], (g / T::kStages) & 1);
      const uint32_t sa = smem_u32(ring + s * T::kStageBytes);
      // dual: this warpgroup's four column blocks ([Bg | Bu])
      const uint32_t sb = sa + T::kABytes + (wcol / 128) * 4 * BK * 128;
#pragma unroll
      for (int i = 0; i < T::kMI; ++i) fence_regs(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < T::kMI; ++i) {
        const uint32_t rows = sa + (wrow + i) * 64 * 128;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = make_desc(
              rows + (kk / 4) * BM * 128 + (kk % 4) * 32, 16, 1024, kSw128);
          const uint64_t db = make_desc(sb + kk * 16 * 128, BK * 128, 1024,
                                        kSw128);
          WgmmaSS<T::kAccN>::template mma<1>(acc[i], da, db, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();   // the previous stage's products are done
#pragma unroll
      for (int i = 0; i < T::kMI; ++i) fence_regs(acc[i]);
      if (prev >= 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < T::kMI; ++i) fence_regs(acc[i]);
    if (prev >= 0) mbar_arrive(&empty[prev]);

    // Epilogue: the C tile goes through its own stage, 64-column blocks
    // of BM rows of 128 bytes under the 128-byte swizzle, as the store
    // map reads; the previous tile's store must have read it first.
    if (threadIdx.x == 0) tma_store_wait_read();
    named_sync(1, T::kWG * 128);
#pragma unroll
    for (int i = 0; i < T::kMI; ++i) {
#pragma unroll
      for (int j = 0; j < T::kWN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (wrow + i) * 64 + warp * 16 + lane / 4 + 8 * h;
          const int c = wcol + 8 * j + 2 * (lane % 4);
          float y0 = acc[i][4 * j + 2 * h], y1 = acc[i][4 * j + 2 * h + 1];
          if constexpr (kDual) {
            const float u0 = acc[i][T::kWN / 2 + 4 * j + 2 * h];
            const float u1 = acc[i][T::kWN / 2 + 4 * j + 2 * h + 1];
            y0 = y0 / (1.f + expf(-y0)) * u0;
            y1 = y1 / (1.f + expf(-y1)) * u1;
          } else if (leaky) {
            y0 = y0 >= 0.f ? y0 : slope * y0;
            y1 = y1 >= 0.f ? y1 : slope * y1;
          }
          const int chunk = ((c % 64) / 8) ^ (r % 8);
          *reinterpret_cast<uint32_t*>(cs + (c / 64) * BM * 128 + r * 128 +
                                       chunk * 16 + (c % 8) * 2) =
              pack_bf16(y0, y1);
        }
      }
    }
    fence_async_smem();
    named_sync(1, T::kWG * 128);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int cb = 0; cb < BN / 64; ++cb)
        tma_store_3d(&cmap, cs + cb * BM * 128, n0 + 64 * cb, m0, bz);
      tma_store_commit();
    }
  }
  if (threadIdx.x == 0) tma_store_wait_all();
}

// Launch the persistent GEMM: C (batch, M, N) = epilogue(A (batch, M, K)
// @ B (batch, K, N)), with Bu = b2 of B's shape for the dual epilogue
// (b2 is ignored otherwise), in bands of `group` row tiles (tile_coords).
template <int BM, int BN, int BK, bool kDual>
cudaError_t launch_wgmma_gemm(const void* a, const void* b, const void* b2,
                              void* c, int batch, int M, int K, int N,
                              bool leaky, float slope, int group,
                              cudaStream_t stream) {
  using T = WgTile<BM, BN, BK, kDual>;
  CUtensorMap amap, bmap, b2map, cmap;
  if (!make_map_3d(&amap, a, K, M, batch, 64, BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&bmap, b, N, K, batch, 64, BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      (kDual && !make_map_3d(&b2map, b2, N, K, batch, 64, BK,
                             CU_TENSOR_MAP_SWIZZLE_128B)) ||
      !make_map_3d(&cmap, c, N, M, batch, 64, BM, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if (!kDual) b2map = bmap;   // not read
  auto kernel = gemm_wgmma_kernel<BM, BN, BK, kDual>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // one block per SM (each takes most of an SM's shared memory), at most
  // one per tile
  const long long tiles = static_cast<long long>((N + BN - 1) / BN) *
                          ((M + BM - 1) / BM) * batch;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      amap, bmap, b2map, cmap, M, N, K, batch, leaky ? 1 : 0, slope,
      group < 1 ? 1 : group);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro
