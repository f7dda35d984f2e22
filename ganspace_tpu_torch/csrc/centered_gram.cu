// Centered Gram matrix G = (X - mu)^T (X - mu) for X [N, D] float32.
//
// Replaces ganspace_tpu/ops/pallas/moments.py::centered_gram (the Pallas
// kernel `_kernel` / `_centered_gram_padded`).  On the port's main path it
// is the per-block update of the IPCA exact-moments tier
// (estimators/ipca.py::_moments_update) at N = 4096, D = 512, with mu the
// block mean.
//
// What bounds it: N*D*(D+1) FLOP for the upper triangle over N*D*4 bytes
// read, so it is compute-bound on this card (1.08 GFLOP against 9.4 MB at
// the main path's shape).  The design:
//   * the products run on the tensor cores in 3xTF32 (tf32x3.cuh), which is
//     as accurate as IEEE float32 FFMA; X is centered in float32 on the
//     way from shared memory to the fragment, then split, so no centered
//     copy of X is written and the cancellation is that of the IEEE sum;
//   * one output tile of 64 x 64 per block, 4 warps of 32 x 32; G is
//     symmetric, so only tiles with bi <= bj exist in the grid, and each
//     writes its tile and its mirror image (a diagonal tile its upper half
//     and that half's mirror, so that G comes out exactly symmetric);
//   * sums run in two levels: each stage's products go into a fresh
//     accumulator, which is then added to the total in float32.  The
//     tensor core's own accumulation truncates, and over all of N that
//     bias alone would reach the bar;
//   * the TPU grid's sequential k axis (N) is split across a thread-block
//     cluster, the largest that keeps the grid in one wave on the card:
//     the ks blocks of one output tile each take a
//     share of the rows, staged through a 4-stage cp.async ring in dynamic shared
//     memory.  Their partial tiles are summed through distributed shared
//     memory, each block reducing a slice of the tile over the ranks in
//     the fixed order 0..ks-1: no atomics, so two launches give the same
//     bits;
//   * ragged N and D edges are zero-filled on the copy, masked out of the
//     centering, and masked on the store.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 64;                   // output tile edge
constexpr int kRows = 32;                   // rows of X per stage
constexpr int kStages = 4;                  // depth of the cp.async ring
constexpr int kThreads = 128;               // 4 warps, 2 x 2 over the tile
constexpr int kStride = kTile + 8;          // conflict-free fragment reads
constexpr int kPanel = kRows * kStride;     // floats of one staged panel
constexpr int kStageFloats = 2 * kPanel;    // the i panel and the j panel
constexpr int kPStride = kTile + 4;         // partial tile row stride
constexpr int kSmemBytes = kStages * kStageFloats * 4;
constexpr int kMaxCluster = 8;              // portable cluster size
static_assert(kTile * kPStride <= kStages * kStageFloats, "partial tile fits the ring");

// Stage rows [row0, row0 + kRows) of columns i0.. and j0.. of X; rows at or
// past row_end and columns past d are zeros.
__device__ __forceinline__ void load_stage(float* st, const float* __restrict__ x,
                                           int d, int row0, int row_end, int i0,
                                           int j0, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {  // d % 4 == 0 and x 16-byte aligned: 16-byte copies
    constexpr int kChunks = kTile / 4;
    for (int idx = tid; idx < 2 * kRows * kChunks; idx += kThreads) {
      const int p = idx / (kRows * kChunks);
      const int r = (idx / kChunks) % kRows;
      const int c = (idx % kChunks) * 4;
      const int row = row0 + r;
      const int col = (p ? j0 : i0) + c;
      const bool ok = row < row_end && col < d;
      tf32x3::cp_async16(st + p * kPanel + r * kStride + c,
                         ok ? x + static_cast<long long>(row) * d + col : x, ok);
    }
  } else {
    for (int idx = tid; idx < 2 * kRows * kTile; idx += kThreads) {
      const int p = idx / (kRows * kTile);
      const int r = (idx / kTile) % kRows;
      const int c = idx % kTile;
      const int row = row0 + r;
      const int col = (p ? j0 : i0) + c;
      const bool ok = row < row_end && col < d;
      tf32x3::cp_async4(st + p * kPanel + r * kStride + c,
                        ok ? x + static_cast<long long>(row) * d + col : x, ok);
    }
  }
}

// One stage's products into part: a warp's 32 x 32 of the tile over the
// stage's kRows rows.  sa and sb point at the warp's first columns of the
// i and j panels; with kMasked, rows at or past `valid` count as zeros.
template <bool kMasked>
__device__ __forceinline__ void stage_products(float (&part)[4][2][1][4],
                                               const float* sa, const float* sb,
                                               const float (&mu_a)[2][2],
                                               const float (&mu_b)[4], int tq, int valid) {
#pragma unroll
  for (int k0 = 0; k0 < kRows; k0 += 8) {
    const bool ok0 = !kMasked || k0 + tq < valid;
    const bool ok1 = !kMasked || k0 + tq + 4 < valid;
    const float* ra0 = sa + (k0 + tq) * kStride;
    const float* ra1 = ra0 + 4 * kStride;
    uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      tf32x3::split(ok0 ? ra0[mt * 16] - mu_a[mt][0] : 0.f, a_hi[mt][0], a_lo[mt][0]);
      tf32x3::split(ok0 ? ra0[mt * 16 + 8] - mu_a[mt][1] : 0.f, a_hi[mt][1], a_lo[mt][1]);
      tf32x3::split(ok1 ? ra1[mt * 16] - mu_a[mt][0] : 0.f, a_hi[mt][2], a_lo[mt][2]);
      tf32x3::split(ok1 ? ra1[mt * 16 + 8] - mu_a[mt][1] : 0.f, a_hi[mt][3], a_lo[mt][3]);
    }
    const float* rb0 = sb + (k0 + tq) * kStride;
    const float* rb1 = rb0 + 4 * kStride;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t b_hi[1][2], b_lo[1][2];
      tf32x3::split(ok0 ? rb0[nt * 8] - mu_b[nt] : 0.f, b_hi[0][0], b_lo[0][0]);
      tf32x3::split(ok1 ? rb1[nt * 8] - mu_b[nt] : 0.f, b_hi[0][1], b_lo[0][1]);
      tf32x3::mma_3xtf32(part[nt], a_hi, a_lo, b_hi, b_lo);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
centered_gram_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                     float* __restrict__ g, int n, int d, int ks, int tiles,
                     int vec) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());

  // Upper-triangle tile t -> (bi, bj) with bi <= bj, row by row.
  int t = blockIdx.x / ks;
  int bi = 0;
  while (t >= tiles - bi) {
    t -= tiles - bi;
    ++bi;
  }
  const int bj = bi + t;
  const int i0 = bi * kTile;
  const int j0 = bj * kTile;

  // This rank's rows: [row_beg, row_end), a whole number of stages each.
  const int per_rank = ((n + ks - 1) / ks + kRows - 1) / kRows * kRows;
  const int row_beg = rank * per_rank;
  const int row_end = min(n, row_beg + per_rank);
  const int steps = row_end > row_beg ? (row_end - row_beg + kRows - 1) / kRows : 0;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gq = lane / 4;  // fragment group
  const int tq = lane % 4;  // thread in group
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  float mu_a[2][2], mu_b[4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + wm + mt * 16 + gq + 8 * h;
      mu_a[mt][h] = i < d ? mu[i] : 0.f;
    }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int j = j0 + wn + nt * 8 + gq;
    mu_b[nt] = j < d ? mu[j] : 0.f;
  }

  float acc[4][2][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][mt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      load_stage(smem + s * kStageFloats, x, d, row_beg + s * kRows, row_end, i0, j0, vec);
    tf32x3::cp_async_commit();
  }

  for (int step = 0; step < steps; ++step) {
    tf32x3::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = step + kStages - 1;
    if (next < steps)
      load_stage(smem + (next % kStages) * kStageFloats, x, d, row_beg + next * kRows,
                 row_end, i0, j0, vec);
    tf32x3::cp_async_commit();

    const float* sa = smem + (step % kStages) * kStageFloats + wm + gq;
    const float* sb = sa + kPanel - wm + wn;
    const int row0 = row_beg + step * kRows;
    float part[4][2][1][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nt][mt][0][e] = 0.f;
    // rows past row_end are zeros, not -mu: only a stage that reaches past
    // it pays for the masks
    if (row0 + kRows <= row_end)
      stage_products<false>(part, sa, sb, mu_a, mu_b, tq, 0);
    else
      stage_products<true>(part, sa, sb, mu_a, mu_b, tq, row_end - row0);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][mt][e] += part[nt][mt][0][e];
  }
  tf32x3::cp_async_wait<0>();
  __syncthreads();

  // Partial tile into this block's shared memory, then the cluster sum.
  float* tile = smem;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = wm + mt * 16 + gq + 8 * h;
        const int j = wn + nt * 8 + 2 * tq;
        *reinterpret_cast<float2*>(tile + i * kPStride + j) =
            make_float2(acc[nt][mt][2 * h], acc[nt][mt][2 * h + 1]);
      }
  cluster.sync();

  // this block reduces tile rows [r0, r1)
  const int r0 = rank * kTile / ks, rows = (rank + 1) * kTile / ks - r0;
  const float* parts[kMaxCluster];
  for (int q = 0; q < ks; ++q) parts[q] = cluster.map_shared_rank(tile, q);
  for (int e = threadIdx.x; e < rows * kTile; e += kThreads) {
    const int r = r0 + e / kTile;
    const int c = e % kTile;
    float v = parts[0][r * kPStride + c];
    for (int q = 1; q < ks; ++q) v += parts[q][r * kPStride + c];
    const int i = i0 + r;
    const int j = j0 + c;
    // a diagonal tile keeps its upper half, so that G is exactly symmetric
    if (i < d && j < d && (bi != bj || r <= c)) {
      g[static_cast<long long>(i) * d + j] = v;
      g[static_cast<long long>(j) * d + i] = v;
    }
  }
  cluster.sync();  // keep every block's partial alive until all have read it
}

}  // namespace

// x [n, d], mu [d], g [d, d]: contiguous float32 device buffers.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int ganspace_centered_gram(const float* x, const float* mu, float* g,
                                      int n, int d, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      centered_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles = (d + kTile - 1) / kTile;
  const int upper = tiles * (tiles + 1) / 2;

  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  // Split N over the largest cluster (each rank keeping at least two stages
  // of rows) whose grid the card still holds in one wave.
  int ks = min(kMaxCluster, max(1, n / (2 * kRows)));
  for (; ks > 1; --ks) {
    cfg.gridDim = dim3(upper * ks);
    cluster[0].val.clusterDim.x = ks;
    int resident = 0;
    if (cudaOccupancyMaxActiveClusters(&resident, centered_gram_kernel, &cfg) == cudaSuccess
        && resident >= upper)
      break;
  }
  cudaGetLastError();  // a refused query leaves no error behind
  cfg.gridDim = dim3(upper * ks);
  cluster[0].val.clusterDim.x = ks;
  const int vec = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, centered_gram_kernel, x, mu, g, n, d,
                                             ks, tiles, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
