// Modulated 3x3 convolution, stride 1, zero padding 1, NCHW float32:
//
//   y[b,o,h,w] = d[b,o] * sum_{c,u,v} wt[o,c,u,v] * s[b,c] * x[b,c,h+u-1,w+v-1]
//
// with wt the He-scaled weight in its own OIHW layout, s the per-sample
// style scales and d the demodulation coefficients (omitted when null).
//
// Replaces ganspace_tpu/ops/pallas/blockconv.py::conv3x3_blocks_pallas
// together with the style scale and demodulation that
// ganspace_tpu/ops/s2d.py::modulated_conv3x3_blocks applies around it.  It
// runs every non-upsampling StyledConv of StyleGAN2 synthesis (conv1 and
// convs.1, 3, ..., 15 at 1024 px).  The TPU kernel's 2x2 space-to-depth
// layout and 16C patch packing exist for 128-lane TPU registers and are not
// carried over: this kernel works on the plain NCHW maps.
//
// What bounds it: 18*C*Co FLOP per output pixel over (C + Co)*4 bytes, so
// it is compute-bound at every synthesis shape but the 4-8 px ones, where
// reading the weight once is the bound.  The design is an implicit GEMM on
// the tensor cores in 3xTF32 (tf32x3.cuh), as accurate as IEEE FFMA:
//   * M is output pixels, N is Co, K is 9*C; a block computes 128 pixels x
//     64 output channels (256 x 32 where Co <= 32) with 8 warps of 32 x 32,
//     and walks K 8 input channels at a time (one m16n8k8 step per tap);
//   * a pixel tile is nb samples x th rows x tw columns (powers of two), so
//     at 4-16 px one tile spans several samples and each fragment row
//     carries its own sample for s and d;
//   * each stage (the zero-padded input halo, the weight slice as the OIHW
//     tensor stores it, which is already K-contiguous for the B fragment,
//     and the stage's s) arrives through a 3-stage cp.async ring.  Halo
//     rows are padded so that their interior lands 16-byte aligned and is
//     copied 16 bytes at a time where the map's width allows; the offset
//     of each halo row in x is computed once per block into a table;
//   * s is applied when the A fragment is formed, before the split, and d
//     in the epilogue, so no scaled copy of x or of the weight exists.  The
//     split happens in registers: shared memory holds each value once,
//     which keeps its bandwidth, and not the tensor cores' rate, from
//     being the limit;
//   * sums run in two levels: each stage's products go into a fresh
//     accumulator, which is then added to the total in float32.  The
//     tensor core's own accumulation truncates, and over K = 4608 that bias
//     alone would miss the bar;
//   * where the maps are small (4-32 px) K is split across a thread-block
//     cluster; the partial tiles are summed through distributed shared
//     memory, each block reducing a slice of output channels over the ranks
//     in the fixed order 0..ks-1, with no atomics: two launches give the
//     same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCK = 8;                  // input channels per stage (one k8 step)
constexpr int kThreads = 256;           // 8 warps of 32 pixels x 32 channels
constexpr int kWS = kCK * 9 + 4;        // weight row stride: conflict-free B reads
constexpr int kStages = 3;
constexpr int kMaxCluster = 8;

// A halo row in shared memory holds columns w0 - 4 .. w0 + tw + 3 of x
// (tw + 8 floats): the tile's columns start 16-byte aligned at index 4, and
// the halo's own columns w0 - 1 and w0 + tw sit at indices 3 and tw + 4.
constexpr int kPad = 4;

struct Geometry {
  int b, c, h, w, co;
  int lg_tw, lg_th, lg_nb;  // pixel tile: nb samples x th rows x tw columns
  int tiles_w, tiles_h, n_tiles;
  int hs_w, hs_img;         // halo row and image strides (tw + 8, (th + 2)(tw + 8))
  int rows, items;          // halo rows per channel, copies per halo row
  unsigned m_rows, m_items;  // ceil(2^32 / divisor) for rows and items
  int chs;                  // halo floats per channel in shared memory
  int stage;                // floats of one ring stage
  int table;                // offset (floats) of the halo row table
  int ks, chunks_per_rank, chunks;
  int xvec;                 // 16-byte copies of the halo rows' interior
  int wvec;                 // 16-byte copies of the weight rows
};

// n / d for n, d < 2^16, with m = ceil(2^32 / d).
__device__ __forceinline__ int fast_div(int n, unsigned m) {
  return static_cast<int>(__umulhi(static_cast<unsigned>(n), m));
}

// Copy one stage into the ring: the halo [kCK][chs], the weight slice
// [bn][kWS] and the style scales [nb][kCK].
template <int kBN>
__device__ __forceinline__ void load_stage(float* st, const float* smem_base, const Geometry& q,
                                           const float* __restrict__ x,
                                           const float* __restrict__ wt,
                                           const float* __restrict__ s, int c0, int b0,
                                           int w0, int o0) {
  const int tid = threadIdx.x;
  const int nb = 1 << q.lg_nb;
  const int tw = 1 << q.lg_tw;
  const long long plane = static_cast<long long>(q.h) * q.w;
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
    const bool row_ok = off >= 0 && c0 + ck < q.c;
    float* dst = st + ck * q.chs + ri * q.hs_w;
    const float* src = xc + ck * plane + off;
    const int inner = q.xvec ? tw / 4 : tw;
    if (item < inner) {
      const int col = q.xvec ? 4 * item : item;
      const bool ok = row_ok && w0 + col < q.w;
      if (q.xvec)
        tf32x3::cp_async16(dst + kPad + col, ok ? src + col : x, ok);
      else
        tf32x3::cp_async4(dst + kPad + col, ok ? src + col : x, ok);
    } else {
      const int col = item == inner ? -1 : tw;
      const bool ok = row_ok && w0 + col >= 0 && w0 + col < q.w;
      tf32x3::cp_async4(dst + kPad + col, ok ? src + col : x, ok);
    }
  }
  // the weight slice [o0, o0 + kBN) x [c0 * 9, c0 * 9 + 72)
  float* ws = st + kCK * q.chs;
  const long long krow = static_cast<long long>(q.c) * 9;
  const int kend = q.c * 9 - c0 * 9;  // valid K entries of this stage
  if (q.wvec) {
    constexpr int kChunks = kCK * 9 / 4;
    for (int idx = tid; idx < kBN * kChunks; idx += kThreads) {
      const int o = idx / kChunks;
      const int k = (idx % kChunks) * 4;
      const bool ok = o0 + o < q.co && k < kend;
      tf32x3::cp_async16(ws + o * kWS + k, ok ? wt + (o0 + o) * krow + c0 * 9 + k : wt, ok);
    }
  } else {
    for (int idx = tid; idx < kBN * kCK * 9; idx += kThreads) {
      const int o = idx / (kCK * 9);
      const int k = idx % (kCK * 9);
      const bool ok = o0 + o < q.co && k < kend;
      tf32x3::cp_async4(ws + o * kWS + k, ok ? wt + (o0 + o) * krow + c0 * 9 + k : wt, ok);
    }
  }
  // the style scales of the stage's channels for the tile's samples
  float* ss = ws + kBN * kWS;
  for (int idx = tid; idx < nb * kCK; idx += kThreads) {
    const int sb = idx / kCK, ck = idx % kCK;
    const bool ok = b0 + sb < q.b && c0 + ck < q.c;
    tf32x3::cp_async4(ss + idx, ok ? s + static_cast<long long>(b0 + sb) * q.c + c0 + ck : s,
                      ok);
  }
}

// kWN warps across the output channels: a block is (256 / kWN) pixels x
// (32 * kWN) channels.
template <int kWN>
__global__ void __launch_bounds__(kThreads, 2)
modconv3x3_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                  const float* __restrict__ s, const float* __restrict__ dmod,
                  float* __restrict__ y, const __grid_constant__ Geometry q) {
  constexpr int kBN = 32 * kWN;
  constexpr int kBM = 256 / kWN;
  constexpr int kPStride = kBM + 4;  // partial tile row stride
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());

  // blockIdx.x = (m_tile * n_tiles + n_tile) * ks + rank: the blocks that
  // share an input tile run side by side.
  const int t = blockIdx.x / q.ks;
  const int nt_blk = t % q.n_tiles;
  const int mt_blk = t / q.n_tiles;
  const int o0 = nt_blk * kBN;
  const int per_b = q.tiles_h * q.tiles_w;
  const int b0 = (mt_blk / per_b) << q.lg_nb;
  const int h0 = ((mt_blk % per_b) / q.tiles_w) << q.lg_th;
  const int w0 = (mt_blk % q.tiles_w) << q.lg_tw;

  const int chunk_beg = rank * q.chunks_per_rank;
  const int steps = max(0, min(q.chunks, chunk_beg + q.chunks_per_rank) - chunk_beg);

  // Each halo row's offset in channel 0 of x at column w0, or -1 where the
  // row lies outside the image.
  {
    int* row_off = reinterpret_cast<int*>(smem) + q.table;
    const long long plane = static_cast<long long>(q.h) * q.w;
    const int th2 = (1 << q.lg_th) + 2;
    for (int ri = threadIdx.x; ri < q.rows; ri += kThreads) {
      const int bb = b0 + ri / th2, hh = h0 - 1 + ri % th2;
      const bool ok = bb < q.b && hh >= 0 && hh < q.h;
      row_off[ri] = ok ? static_cast<int>(bb * q.c * plane + hh * q.w + w0) : -1;
    }
    __syncthreads();
  }

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int wm = (warp / kWN) * 32;
  const int wn = (warp % kWN) * 32;

  // Halo offset (channel tq) and s index of each fragment row, pixel
  // wm + mt*16 + gq + 8h.
  int poff[2][2], samp[2][2];
  const int tw_mask = (1 << q.lg_tw) - 1, th_mask = (1 << q.lg_th) - 1;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm + mt * 16 + gq + 8 * h;
      const int col = m & tw_mask;
      const int r = (m >> q.lg_tw) & th_mask;
      const int sb = m >> (q.lg_tw + q.lg_th);
      poff[mt][h] = sb * q.hs_img + r * q.hs_w + kPad - 1 + col + tq * q.chs;
      samp[mt][h] = sb * kCK + tq;
    }
  const int ch4 = 4 * q.chs;
  const int wrow = kCK * q.chs + (wn + gq) * kWS + tq * 9;

  float acc[4][2][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][mt][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps)
      load_stage<kBN>(smem + st * q.stage, smem, q, x, wt, s, (chunk_beg + st) * kCK, b0, w0, o0);
    tf32x3::cp_async_commit();
  }

  for (int step = 0; step < steps; ++step) {
    tf32x3::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = step + kStages - 1;
    if (next < steps)
      load_stage<kBN>(smem + (next % kStages) * q.stage, smem, q, x, wt, s,
                      (chunk_beg + next) * kCK, b0, w0, o0);
    tf32x3::cp_async_commit();

    const float* hx = smem + (step % kStages) * q.stage;
    const float* ss = hx + kCK * q.chs + kBN * kWS;
    // s for (row g, ch t), (row g+8, ch t), (row g, ch t+4), (row g+8, ch t+4)
    float sc[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      sc[mt][0] = ss[samp[mt][0]];
      sc[mt][1] = ss[samp[mt][1]];
      sc[mt][2] = ss[samp[mt][0] + 4];
      sc[mt][3] = ss[samp[mt][1] + 4];
    }
    float part[4][2][1][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nt][mt][0][e] = 0.f;
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const int tap = u * q.hs_w + v;
        uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // rows g and g + 8, channels tq and tq + 4
          const float* p0 = hx + poff[mt][0] + tap;
          const float* p1 = hx + poff[mt][1] + tap;
          tf32x3::split(p0[0] * sc[mt][0], a_hi[mt][0], a_lo[mt][0]);
          tf32x3::split(p1[0] * sc[mt][1], a_hi[mt][1], a_lo[mt][1]);
          tf32x3::split(p0[ch4] * sc[mt][2], a_hi[mt][2], a_lo[mt][2]);
          tf32x3::split(p1[ch4] * sc[mt][3], a_hi[mt][3], a_lo[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* wp = hx + wrow + nt * 8 * kWS + u * 3 + v;
          uint32_t b_hi[1][2], b_lo[1][2];
          tf32x3::split(wp[0], b_hi[0][0], b_lo[0][0]);
          tf32x3::split(wp[36], b_hi[0][1], b_lo[0][1]);  // channel tq + 4
          tf32x3::mma_3xtf32(part[nt], a_hi, a_lo, b_hi, b_lo);
        }
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
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
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = wm + mt * 16 + gq + 8 * (e / 2);
        const int o = wn + nt * 8 + 2 * tq + (e % 2);
        tile[o * kPStride + m] = acc[nt][mt][e];
      }
  cluster.sync();

  const int rows = kBN / q.ks;  // this block writes channels [r0, r0 + rows)
  const int r0 = rank * rows;
  const float* parts[kMaxCluster];
  for (int k = 0; k < q.ks; ++k) parts[k] = cluster.map_shared_rank(tile, k);
  const long long plane = static_cast<long long>(q.h) * q.w;
  for (int e = threadIdx.x; e < rows * kBM; e += kThreads) {
    const int ol = r0 + e / kBM;
    const int m = e % kBM;
    float val = parts[0][ol * kPStride + m];
    for (int k = 1; k < q.ks; ++k) val += parts[k][ol * kPStride + m];
    const int o = o0 + ol;
    const int bb = b0 + (m >> (q.lg_tw + q.lg_th));
    const int hh = h0 + ((m >> q.lg_tw) & th_mask);
    const int ww = w0 + (m & tw_mask);
    if (o < q.co && bb < q.b && hh < q.h && ww < q.w) {
      if (dmod) val *= dmod[static_cast<long long>(bb) * q.co + o];
      y[(static_cast<long long>(bb) * q.co + o) * plane + static_cast<long long>(hh) * q.w
        + ww] = val;
    }
  }
  cluster.sync();  // keep every block's partial alive until all have read it
}

int log2_ceil(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

unsigned div_magic(int d) {
  return static_cast<unsigned>(((1ull << 32) + d - 1) / static_cast<unsigned>(d));
}

template <int kWN>
cudaError_t launch(const float* x, const float* wt, const float* s, const float* dmod,
                   float* y, Geometry q, cudaStream_t stream) {
  constexpr int kBN = 32 * kWN;
  constexpr int kBM = 256 / kWN;
  constexpr int kMaxSmem = 227 * 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      modconv3x3_kernel<kWN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);

  const int lg_pix = log2_ceil(kBM);
  q.lg_tw = log2_ceil(q.w) < 5 ? log2_ceil(q.w) : 5;           // tw <= 32
  q.lg_th = log2_ceil(q.h) < lg_pix - q.lg_tw ? log2_ceil(q.h) : lg_pix - q.lg_tw;
  q.lg_nb = lg_pix - q.lg_tw - q.lg_th;
  const int tw = 1 << q.lg_tw, th = 1 << q.lg_th, nb = 1 << q.lg_nb;
  q.tiles_w = (q.w + tw - 1) / tw;
  q.tiles_h = (q.h + th - 1) / th;
  q.n_tiles = (q.co + kBN - 1) / kBN;
  const long long m_tiles =
      static_cast<long long>((q.b + nb - 1) / nb) * q.tiles_h * q.tiles_w;
  q.hs_w = tw + 2 * kPad;
  q.hs_img = (th + 2) * q.hs_w;
  q.rows = nb * (th + 2);
  q.xvec = q.xvec && tw >= 4;
  q.items = (q.xvec ? tw / 4 : tw) + 2;
  q.m_rows = div_magic(q.rows);
  q.m_items = div_magic(q.items);
  q.chs = (nb * q.hs_img + 23) / 32 * 32 + 8;  // = 8 mod 32: conflict-free A reads
  q.stage = kCK * q.chs + kBN * kWS + (nb * kCK + 3) / 4 * 4;
  q.table = kStages * q.stage;
  q.chunks = (q.c + kCK - 1) / kCK;
  // Split K over a cluster until the grid holds about four blocks per SM,
  // each rank keeping at least one stage.
  const long long blocks = m_tiles * q.n_tiles;
  q.ks = 1;
  while (q.ks < kMaxCluster && blocks * q.ks < 4LL * sms && 2 * q.ks <= q.chunks) q.ks *= 2;
  q.chunks_per_rank = (q.chunks + q.ks - 1) / q.ks;
  // the ring, then the halo offset table; the partial tile reuses the ring
  const long long floats = static_cast<long long>(q.table) + q.rows;
  if (blocks * q.ks >= (1LL << 31) || floats * 4 > kMaxSmem || kBN * (kBM + 4) > q.table)
    return cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks * q.ks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(floats) * 4;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = q.ks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, modconv3x3_kernel<kWN>, x, wt, s, dmod, y, q);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// x [b, c, h, w], wt [co, c, 3, 3], s [b, c], dmod [b, co] or null,
// y [b, co, h, w]: contiguous float32 device buffers.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int ganspace_modconv3x3(const float* x, const float* wt, const float* s,
                                   const float* dmod, float* y, int b, int c,
                                   int h, int w, int co, void* stream) {
  Geometry q = {};
  q.b = b, q.c = c, q.h = h, q.w = w, q.co = co;
  q.xvec = (w % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  q.wvec = (c % 4 == 0) && (reinterpret_cast<uintptr_t>(wt) % 16 == 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(co <= 32 ? launch<1>(x, wt, s, dmod, y, q, st)
                                   : launch<2>(x, wt, s, dmod, y, q, st));
}
