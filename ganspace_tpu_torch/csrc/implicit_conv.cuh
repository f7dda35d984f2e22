// Implicit-GEMM 3x3 correlation, stride 1, zero padding 1, NCHW float32,
// on the tensor cores in 3xTF32 (tf32x3.cuh): the machinery of kernel B's
// 3x3 modes (modconv3x3.cu, the modulated and the plain one).
//
//   y[b, o, m, n] = d[b,o] * sum_{c, a < 3, e < 3}
//       wt[o, c, a, e] * s[b,c] * x[b, c, m - 1 + a, n - 1 + e]
//
// with x read as zero outside the image and wt in its OIHW layout.  s and d
// are optional (null).
//
// Design (what bounds it and what the design does about it): 18*C*Co FLOP
// per output pixel over (C + Co)*4 bytes, compute-bound at every shape of
// the synthesis but the 4-8 px ones.
//   * M is output pixels, N is Co, K is 9*C; a block computes kBM pixels x
//     kBN output channels with 8 warps of 32 pixels x 8*kNT channels, and
//     walks K kCK = 8 input channels per stage (one m16n8k8 step per tap);
//   * a pixel tile is tr grid rows x tw columns, the rows counted across
//     samples (row R of the tile is row R mod oh of sample R / oh), so that
//     on small and odd grids one tile spans several samples and few of its
//     kBM pixels fall outside the grid.  tw is the grid's width under 64
//     columns when that width is not a power of two, else a power of two up
//     to 32.  Each fragment row carries its own sample for s and d;
//   * each stage (the zero-padded input halo: for each sample the tile
//     touches, its rows plus one above and one below, tw + 2 columns wide;
//     the weight slice; the stage's s) arrives through a 3-stage cp.async
//     ring.  Halo rows are padded so that their interior lands 16-byte
//     aligned and is copied 16 bytes at a time where the map's width allows;
//     the offset of each halo row in x is computed once per block into a
//     table;
//   * the weight slice keeps the global OIHW layout, one row of kCK*9 floats
//     per output channel, at a row stride of kCK*9 + 4 floats, which is
//     conflict-free;
//   * s is applied when the A fragment is formed, before the split, and d
//     in the epilogue, so no scaled copy of x or of the weight exists.  The
//     split happens in registers: shared memory holds each value once.
//     Without s (the plain mode) the scale is compiled out;
//   * sums run in two levels: each stage's products go into a fresh
//     accumulator, which is then added to the total in float32 (the tensor
//     core's own accumulation truncates);
//   * where the grids are small K is split across a thread-block cluster;
//     the partial tiles are summed through distributed shared memory, each
//     block reducing a slice of output channels over the ranks in the fixed
//     order 0..ks-1, with no atomics: two launches give the same bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace implicit_conv {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;           // 8 warps
constexpr int kStages = 3;
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kTY = 3, kTX = 3;         // the window
constexpr int kTMax = kTY * kTX;
constexpr int kCK = 8;                  // input channels per stage

// A halo row in shared memory holds columns w0 - 4 .. w0 + tw + 3 of x
// (tw + 8 floats): the tile's columns start 16-byte aligned at index 4, and
// the halo's own columns w0 - 1 and w0 + tw sit at indices 3 and tw + 4.
constexpr int kPad = 4;

// The output grid of a launch and its tiling.
struct Geometry {
  const float* wt;          // weight rows of krow floats per output channel
  long long krow;
  int oh, ow;               // output grid (the tiles cover it)
  int xvec;                 // 16-byte copies of the halo rows' interior
  int wvec;                 // 16-byte copies of the weight rows
  int tw, tr;               // pixel tile: tr grid rows (across samples) x tw columns
  unsigned m_tw, m_oh, m_ohp;  // ceil(2^32 / divisor) for tw, oh and oh + 2
  int tiles_w, tiles_r;
  int hs_w;                 // halo row stride (tw + 8)
  int segs;                 // samples one tile touches at most
  int rows, items;          // halo rows per channel, copies per halo row
  unsigned m_rows, m_items;  // ceil(2^32 / divisor) for rows and items
  int chs;                  // halo floats per channel in shared memory
  int stage;                // floats of one ring stage
  int table;                // offset (floats) of the halo row table
};

struct Launch {
  Geometry g;
  int b, c, h, w, co;       // x [b, c, h, w], co output channels; y [b, co, h, w]
  int n_tiles;              // output-channel tiles
  int ks, chunks_per_rank, chunks;
};

// n / d for n, d < 2^16, with m = ceil(2^32 / d).
__device__ __forceinline__ int fast_div(int n, unsigned m) {
  return static_cast<int>(__umulhi(static_cast<unsigned>(n), m));
}

// Copy one stage into the ring: the halo [kCK][chs], the weight slice
// [kBN][kCK * kTMax + 4] and, with kScale, the style scales [segs][kCK].
template <int kBN, bool kScale>
__device__ __forceinline__ void load_stage(float* st, const float* smem_base, const Launch& L,
                                           const Geometry& q, const float* __restrict__ x,
                                           const float* __restrict__ s, int c0, int b0,
                                           int w0, int o0) {
  constexpr int kWS = kCK * kTMax + 4;
  const int tid = threadIdx.x;
  const int tw = q.tw;
  const long long plane = static_cast<long long>(L.h) * L.w;
  // the input halo, zeros outside the image and past the last channel;
  // copy `item` of a row is a 16-byte chunk of the interior (xvec) or one
  // float, the two edge columns coming last
  const int* row_off = reinterpret_cast<const int*>(smem_base) + q.table;
  const float* xc = x + static_cast<long long>(c0) * plane;
  for (int idx = tid; idx < kCK * q.rows * q.items; idx += kThreads) {
    const int row = fast_div(idx, q.m_items);
    const int item = idx - row * q.items;
    const int ck = fast_div(row, q.m_rows);
    const int ri = row - ck * q.rows;
    const int off = row_off[ri];  // of column w0, or -1 outside the image
    const bool row_ok = off >= 0 && c0 + ck < L.c;
    float* dst = st + ck * q.chs + ri * q.hs_w;
    const float* src = xc + ck * plane + off;
    const int inner = q.xvec ? tw / 4 : tw;
    if (item < inner) {
      const int col = q.xvec ? 4 * item : item;
      const bool ok = row_ok && w0 + col < L.w;
      if (q.xvec)
        tf32x3::cp_async16(dst + kPad + col, ok ? src + col : x, ok);
      else
        tf32x3::cp_async4(dst + kPad + col, ok ? src + col : x, ok);
    } else {
      const int col = item == inner ? -1 : tw;
      const bool ok = row_ok && w0 + col >= 0 && w0 + col < L.w;
      tf32x3::cp_async4(dst + kPad + col, ok ? src + col : x, ok);
    }
  }
  // the weight slice [o0, o0 + kBN) x [c0 * 9, (c0 + kCK) * 9)
  float* ws = st + kCK * q.chs;
  const long long kend = q.krow - static_cast<long long>(c0) * kTMax;  // valid entries
  const float* wc = q.wt + static_cast<long long>(c0) * kTMax;
  if (q.wvec) {
    for (int idx = tid; idx < kBN * kCK * kTMax / 4; idx += kThreads) {  // 18 chunks per row
      const int o = idx / (kCK * kTMax / 4);
      const int k = 4 * (idx % (kCK * kTMax / 4));
      const bool ok = o0 + o < L.co && k < kend;
      tf32x3::cp_async16(ws + o * kWS + k, ok ? wc + (o0 + o) * q.krow + k : q.wt, ok);
    }
  } else {
    for (int idx = tid; idx < kBN * kCK * kTMax; idx += kThreads) {
      const int o = idx / (kCK * kTMax);
      const int k = idx - o * (kCK * kTMax);
      const bool ok = o0 + o < L.co && k < kend;
      tf32x3::cp_async4(ws + o * kWS + k, ok ? wc + (o0 + o) * q.krow + k : q.wt, ok);
    }
  }
  // the style scales of the stage's channels for the tile's samples
  if constexpr (kScale) {
    float* ss = ws + kBN * kWS;
    for (int idx = tid; idx < q.segs * kCK; idx += kThreads) {
      const int sb = idx / kCK, ck = idx % kCK;
      const bool ok = b0 + sb < L.b && c0 + ck < L.c;
      tf32x3::cp_async4(ss + idx, ok ? s + static_cast<long long>(b0 + sb) * L.c + c0 + ck : s,
                        ok);
    }
  }
}

// kWN warps across the output channels, each warp 32 pixels x 8 * kNT
// channels: a block is (256 / kWN) pixels x (8 * kNT * kWN) channels.  The
// weight row is OIHW (channel-major, tap innermost).  A stage holds kCK
// input channels (one k8 step per tap).  kScale: s is given.
template <int kWN, int kNT, bool kScale>
__global__ void __launch_bounds__(kThreads, 2)
conv_kernel(const float* __restrict__ x, const float* __restrict__ s,
            const float* __restrict__ dmod, float* __restrict__ y,
            const __grid_constant__ Launch L) {
  constexpr int kWS = kCK * kTMax + 4;
  constexpr int kChS = kTMax;   // channel stride in a weight row
  constexpr int kBN = 8 * kNT * kWN;
  constexpr int kBM = 256 / kWN;
  constexpr int kPStride = kBM + 4;  // partial tile row stride
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());

  // This block's tile: blockIdx.x = (m_tile * n_tiles + n_tile) * ks +
  // rank, so the blocks that share an input tile run side by side.
  const Geometry& q = L.g;
  const int t = static_cast<int>(blockIdx.x) / L.ks;
  const int nt_blk = t % L.n_tiles;
  const int mt_blk = t / L.n_tiles;
  const int o0 = nt_blk * kBN;
  const int rt = mt_blk / q.tiles_w;
  const int w0 = (mt_blk - rt * q.tiles_w) * q.tw;
  const int row0 = rt * q.tr;            // first grid row, counted across samples
  const int b0 = row0 / q.oh;
  const int r0 = row0 - b0 * q.oh;       // its row in sample b0

  const int chunk_beg = rank * L.chunks_per_rank;
  const int steps = max(0, min(L.chunks, chunk_beg + L.chunks_per_rank) - chunk_beg);

  // Each halo row's offset in channel 0 of x at column w0, or -1 where the
  // row lies outside the image.  The halo stacks, for each sample from b0
  // on, input rows -1 .. oh (oh + 2 rows), starting at sample b0's row
  // r0 - 1: halo row ri is row (ri + r0) mod (oh + 2) - 1 of sample
  // b0 + (ri + r0) / (oh + 2).
  {
    int* row_off = reinterpret_cast<int*>(smem) + q.table;
    const long long plane = static_cast<long long>(L.h) * L.w;
    for (int ri = threadIdx.x; ri < q.rows; ri += kThreads) {
      const int j = ri + r0;
      const int k = fast_div(j, q.m_ohp);
      const int hh = j - k * (q.oh + 2) - 1;
      const int bb = b0 + k;
      const bool ok = bb < L.b && hh >= 0 && hh < L.h;
      row_off[ri] = ok ? static_cast<int>(bb * L.c * plane + hh * L.w + w0) : -1;
    }
    __syncthreads();
  }

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int wm = (warp / kWN) * 32;
  const int wn = (warp % kWN) * 8 * kNT;

  // Halo offset (channel tq, window origin) and s index of each fragment
  // row, pixel wm + mt*16 + gq + 8h: tile row i (grid row r0 + i of sample
  // b0, counted on), column col; its window's first halo row is i + 2k
  // for its k-th sample.  Pixels past the tile's tr rows read row 0 and are
  // not stored.
  int poff[2][2], samp[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm + mt * 16 + gq + 8 * h;
      int i = fast_div(m, q.m_tw);
      const int col = m - i * q.tw;
      i = i < q.tr ? i : 0;
      const int k = fast_div(r0 + i, q.m_oh);
      poff[mt][h] = (i + 2 * k) * q.hs_w + kPad - 1 + col + tq * q.chs;
      samp[mt][h] = k * kCK + tq;
    }
  const int ch4 = 4 * q.chs;
  const int wrow = kCK * q.chs + (wn + gq) * kWS + tq * kChS;

  float acc[kNT][2][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][mt][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps)
      load_stage<kBN, kScale>(smem + st * q.stage, smem, L, q, x, s, (chunk_beg + st) * kCK,
                              b0, w0, o0);
    tf32x3::cp_async_commit();
  }

  for (int step = 0; step < steps; ++step) {
    tf32x3::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = step + kStages - 1;
    if (next < steps)
      load_stage<kBN, kScale>(smem + (next % kStages) * q.stage, smem, L, q, x, s,
                              (chunk_beg + next) * kCK, b0, w0, o0);
    tf32x3::cp_async_commit();

    const float* hx = smem + (step % kStages) * q.stage;
    const float* ss = hx + kCK * q.chs + kBN * kWS;
    float part[kNT][2][1][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nt][mt][0][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kCK / 8; ++j) {  // k8 steps: channels 8j .. 8j + 7
      // s for (row g, ch t), (row g+8, ch t), (row g, ch t+4), (row g+8, ch t+4)
      float sc[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        sc[mt][0] = kScale ? ss[samp[mt][0] + 8 * j] : 1.f;
        sc[mt][1] = kScale ? ss[samp[mt][1] + 8 * j] : 1.f;
        sc[mt][2] = kScale ? ss[samp[mt][0] + 8 * j + 4] : 1.f;
        sc[mt][3] = kScale ? ss[samp[mt][1] + 8 * j + 4] : 1.f;
      }
#pragma unroll
      for (int u = 0; u < kTY; ++u)
#pragma unroll
        for (int v = 0; v < kTX; ++v) {
          const int tap = 8 * j * q.chs + u * q.hs_w + v;
          uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            // rows g and g + 8, channels tq and tq + 4
            const float* p0 = hx + poff[mt][0] + tap;
            const float* p1 = hx + poff[mt][1] + tap;
            if constexpr (kScale) {
              tf32x3::split(p0[0] * sc[mt][0], a_hi[mt][0], a_lo[mt][0]);
              tf32x3::split(p1[0] * sc[mt][1], a_hi[mt][1], a_lo[mt][1]);
              tf32x3::split(p0[ch4] * sc[mt][2], a_hi[mt][2], a_lo[mt][2]);
              tf32x3::split(p1[ch4] * sc[mt][3], a_hi[mt][3], a_lo[mt][3]);
            } else {
              tf32x3::split(p0[0], a_hi[mt][0], a_lo[mt][0]);
              tf32x3::split(p1[0], a_hi[mt][1], a_lo[mt][1]);
              tf32x3::split(p0[ch4], a_hi[mt][2], a_lo[mt][2]);
              tf32x3::split(p1[ch4], a_hi[mt][3], a_lo[mt][3]);
            }
          }
          // the tap's column in the weight row: OIHW (channel, tap) at 9 c + tap
          const int wk = 8 * j * kTMax + (u * kTX + v);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const float* wp = hx + wrow + nt * 8 * kWS + wk;
            uint32_t b_hi[1][2], b_lo[1][2];
            tf32x3::split(wp[0], b_hi[0][0], b_lo[0][0]);
            tf32x3::split(wp[4 * kChS], b_hi[0][1], b_lo[0][1]);  // channel tq + 4
            tf32x3::mma_3xtf32(part[nt], a_hi, a_lo, b_hi, b_lo);
          }
        }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][mt][e] += part[nt][mt][0][e];
  }
  tf32x3::cp_async_wait<0>();
  __syncthreads();

  // Partial tile [channel][pixel] into shared memory, then the cluster sum.
  float* tile = smem;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = wm + mt * 16 + gq + 8 * (e / 2);
        const int o = wn + nt * 8 + 2 * tq + (e % 2);
        tile[o * kPStride + m] = acc[nt][mt][e];
      }
  cluster.sync();

  const int rows = kBN / L.ks;  // this block writes channels [c0, c0 + rows)
  const int c0 = rank * rows;
  const float* parts[kMaxCluster];
  for (int k = 0; k < L.ks; ++k) parts[k] = cluster.map_shared_rank(tile, k);
  const long long yplane = static_cast<long long>(L.h) * L.w;
  for (int e = threadIdx.x; e < rows * kBM; e += kThreads) {
    const int ol = c0 + e / kBM;
    const int m = e % kBM;
    float val = parts[0][ol * kPStride + m];
    for (int k = 1; k < L.ks; ++k) val += parts[k][ol * kPStride + m];
    const int o = o0 + ol;
    const int i = fast_div(m, q.m_tw);
    const int k = fast_div(r0 + i, q.m_oh);
    const int bb = b0 + k;
    const int hh = r0 + i - k * q.oh;
    const int ww = w0 + m - i * q.tw;
    if (i < q.tr && o < L.co && bb < L.b && ww < q.ow) {
      if (dmod) val *= dmod[static_cast<long long>(bb) * L.co + o];
      y[(static_cast<long long>(bb) * L.co + o) * yplane + static_cast<long long>(hh) * L.w
        + ww] = val;
    }
  }
  cluster.sync();  // keep every block's partial alive until all have read it
}

inline int log2_ceil(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

inline unsigned div_magic(int d) {
  return static_cast<unsigned>(((1ull << 32) + d - 1) / static_cast<unsigned>(d));
}

inline bool is_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

inline int gcd(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b, b = r;
  }
  return a;
}

// The shared memory (floats) of a tile of tr rows: the ring, then the halo
// offset table (the partial tile reuses the ring).
template <int kBN, bool kScale>
long long tile_floats(Geometry& q, bool vec) {
  constexpr int kWS = kCK * kTMax + 4;
  q.m_tw = div_magic(q.tw);
  q.m_oh = div_magic(q.oh);
  q.m_ohp = div_magic(q.oh + 2);
  // a tile starts at a multiple of gcd(tr, oh) within its sample
  const int g = gcd(q.tr, q.oh);
  q.segs = (q.oh - g + q.tr - 1) / q.oh + 1;
  q.hs_w = q.tw + 2 * kPad;
  q.rows = q.tr + 2 * q.segs;
  q.xvec = vec && q.tw % 4 == 0;
  q.items = (q.xvec ? q.tw / 4 : q.tw) + 2;
  q.m_rows = div_magic(q.rows);
  q.m_items = div_magic(q.items);
  q.chs = (q.rows * q.hs_w + 23) / 32 * 32 + 8;  // = 8 mod 32: conflict-free A reads
  q.stage = kCK * q.chs + kBN * kWS + (kScale ? (q.segs * kCK + 3) / 4 * 4 : 0);
  q.table = kStages * q.stage;
  return static_cast<long long>(q.table) + q.rows;
}

// The tiling of the grid (its output and weight fields set by the caller):
// the floats of shared memory it needs, or -1 when it cannot fit.  Columns:
// an odd grid under 64 columns whole, else power-of-two tiles up to 32;
// rows: as many as fill kBM pixels, counted across samples.
template <int kBN, int kBM, bool kScale>
long long tile_grid(Geometry& q, int batch) {
  q.tw = (q.ow < 64 && !is_pow2(q.ow)) ? q.ow : 1 << (log2_ceil(q.ow) < 5 ? log2_ceil(q.ow) : 5);
  const bool vec = q.xvec;
  q.tr = kBM / q.tw;
  long long floats = tile_floats<kBN, kScale>(q, vec);
  while (floats * 4 > kMaxSmem && q.tr > 1) {  // fewer rows while the ring does not fit
    q.tr = (q.tr + 1) / 2;
    floats = tile_floats<kBN, kScale>(q, vec);
  }
  q.tiles_w = (q.ow + q.tw - 1) / q.tw;
  q.tiles_r = static_cast<int>((static_cast<long long>(batch) * q.oh + q.tr - 1) / q.tr);
  return floats * 4 <= kMaxSmem ? floats : -1;
}

// Fill the tiling of L's grid (its sizes, and the grid's output and weight
// fields, set by the caller) and launch it.
template <int kWN, int kNT, bool kScale>
cudaError_t launch(const float* x, const float* s, const float* dmod, float* y, Launch L,
                   cudaStream_t stream) {
  constexpr int kBN = 8 * kNT * kWN;
  constexpr int kBM = 256 / kWN;
  auto kernel = conv_kernel<kWN, kNT, kScale>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);

  L.n_tiles = (L.co + kBN - 1) / kBN;
  L.chunks = (L.c + kCK - 1) / kCK;  // stages
  const long long floats = tile_grid<kBN, kBM, kScale>(L.g, L.b);
  if (floats < 0) return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(L.g.tiles_r) * L.g.tiles_w * L.n_tiles;
  // Split K over a cluster until the grid holds about four blocks per SM,
  // each rank keeping at least one stage.
  L.ks = 1;
  while (L.ks < kMaxCluster && blocks * L.ks < 4LL * sms && 2 * L.ks <= L.chunks) L.ks *= 2;
  L.chunks_per_rank = (L.chunks + L.ks - 1) / L.ks;
  if (blocks * L.ks >= (1LL << 31) || kBN * (kBM + 4) > floats) return cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks * L.ks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(floats) * 4;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = L.ks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, s, dmod, y, L);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The warp layout for co output channels: 64-channel blocks (two warps
// across N) from 33 channels, 32-channel blocks from 17, 16-channel blocks
// below, so that a 16-channel layer does not leave half the N tile empty.
// s null takes the plain kernel.
inline cudaError_t launch_for(const float* x, const float* s, const float* dmod, float* y,
                              const Launch& L, cudaStream_t stream) {
  if (s) {
    if (L.co <= 16) return launch<1, 2, true>(x, s, dmod, y, L, stream);
    if (L.co <= 32) return launch<1, 4, true>(x, s, dmod, y, L, stream);
    return launch<2, 4, true>(x, s, dmod, y, L, stream);
  }
  if (L.co <= 16) return launch<1, 2, false>(x, s, dmod, y, L, stream);
  if (L.co <= 32) return launch<1, 4, false>(x, s, dmod, y, L, stream);
  return launch<2, 4, false>(x, s, dmod, y, L, stream);
}

}  // namespace implicit_conv
