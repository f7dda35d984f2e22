// Centered Gram matrix G = (X - mu)^T (X - mu) for X [N, D] float32.
//
// Replaces ganspace_tpu/ops/pallas/moments.py::centered_gram (the Pallas
// kernel `_kernel` / `_centered_gram_padded`).  On the port's main path it
// is the per-block update of the IPCA exact-moments tier
// (estimators/ipca.py::_moments_update) at N = 4096, D = 512, with mu the
// block mean.
//
// What bounds it: 2*N*D^2 FLOP over N*D*4 bytes read, i.e. D/2 FLOP per
// byte (256 at D = 512) -- compute-bound in float32 on this card.  The
// design therefore spends its effort on FFMA throughput and keeps every
// byte out of device memory that it can:
//   * the centering happens on the load into shared memory, so no centered
//     copy of X is ever written (as in the Pallas kernel);
//   * each block owns one 64 x 64 output tile and walks the whole N axis in
//     a loop (the TPU grid's sequential k axis becomes that loop); each of
//     its 256 threads keeps a 4 x 4 register tile, fed by float4 reads of
//     the two staged 16-row strips;
//   * G is symmetric, so only tiles with bi <= bj do work; they write their
//     tile and its mirror image;
//   * sums run in two levels (a 16-row partial added into the total), which
//     keeps the float32 rounding error well below a plain running sum;
//   * ragged N and D edges are masked on load (zeros) and on store.
// No tensor cores: the float32 path stays IEEE (no TF32).
//
// Known limit: at D = 512 there are only 36 working blocks for 132 SMs.
// A deterministic split of N over more blocks (partial tiles plus a second
// reduction pass, no atomics) is the next step for speed.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // output tile edge
constexpr int kRows = 16;      // rows of X staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
centered_gram_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                     float* __restrict__ g, int n, int d) {
  const int bi = blockIdx.y;
  const int bj = blockIdx.x;
  if (bi > bj) return;  // lower tiles are written as mirrors
  const int i0 = bi * kTile;
  const int j0 = bj * kTile;

  __shared__ __align__(16) float a_s[kRows][kTile];
  __shared__ __align__(16) float b_s[kRows][kTile];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group of the tile (j)
  const int ty = tid / 16;  // row group of the tile (i)

  // Each thread loads 4 elements of each strip per step; its column is
  // fixed, so its mean values are read once.
  const int load_col = tid % kTile;
  const int load_row = tid / kTile;  // 0..3, plus 4 * l below
  const int gi = i0 + load_col;
  const int gj = j0 + load_col;
  const float mu_i = gi < d ? mu[gi] : 0.f;
  const float mu_j = gj < d ? mu[gj] : 0.f;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int n0 = 0; n0 < n; n0 += kRows) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int r = load_row + 4 * l;
      const int row = n0 + r;
      const bool row_ok = row < n;
      const float* xr = x + static_cast<long long>(row) * d;
      a_s[r][load_col] = (row_ok && gi < d) ? xr[gi] - mu_i : 0.f;
      b_s[r][load_col] = (row_ok && gj < d) ? xr[gj] - mu_j : 0.f;
    }
    __syncthreads();

    float part[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) part[a][b] = 0.f;

#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) part[a][b] = fmaf(ar[a], br[b], part[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] += part[a][b];
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
    if (i >= d) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx * 4 + b;
      if (j >= d) continue;
      g[static_cast<long long>(i) * d + j] = acc[a][b];
      if (bi != bj) g[static_cast<long long>(j) * d + i] = acc[a][b];
    }
  }
}

}  // namespace

// x [n, d], mu [d], g [d, d]: contiguous float32 device buffers.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int ganspace_centered_gram(const float* x, const float* mu, float* g,
                                      int n, int d, void* stream) {
  const int tiles = (d + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles);
  centered_gram_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, mu, g, n, d);
  return static_cast<int>(cudaGetLastError());
}
