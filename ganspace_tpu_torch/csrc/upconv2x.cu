// Kernel B, stride-2 mode: a stride-2 transposed convolution, NCHW float32,
// with an optional style scale and demodulation:
//
//   y = d * conv_transpose2d(x * s, wt, stride 2, padding p)
//
// (wt [co, c, k, k] in the correlation orientation of a conv weight, k = 3 or
// 4, p = 0 or 1).  Input pixel (i, j) sends tap (u, v) of every output
// channel to output (2i + u - p, 2j + v - p), so the layer is a dense product
//
//   P[pixel, (tap, o)] = sum_c (x * s)[pixel, c] * wt[o, c, tap]
//
// (M = pixels, N = taps x output channels, K = input channels) followed by
// an overlap-add of the k^2 tap products into the output.  Every product
// meets a real input pixel: there is no zero-inserted input and no phase
// window reaching into the zero pad.
//
// Replaces no TPU kernel: the JAX package leaves the transposed convolution
// to XLA (ganspace_tpu/ops/modconv.py, StyleGAN2's upsampling StyledConv;
// ganspace_tpu/models/stylegan.py:156-166, StyleGAN's fused conv0_up at
// 128 px and up).  cuDNN's transposed convolution sums in no fixed order, so
// a regenerated tap forward would not repeat bit for bit; here every launch
// gives identical bits.
//
// What bounds it: 2 k^2 C Co FLOP per input pixel in 3xTF32, compute-bound
// at the 512-channel shapes (the conv-tap path's 4 -> 9 and 8 -> 17 px at
// batch 128), bytes at the render's 256-1024 px maps with 16-64 channels.
// The design (a tile = 128 pixels x N = k^2 * kCoT, two warpgroups):
//   * wgmma on sm_90a (wgmma_tf32.cuh), three products per k8 step (lo*hi,
//     hi*lo, hi*hi).  B, the weight, is split into TF32 hi and lo once per
//     layer by the wrapper (ops/modconv.py::UpsampleWeights), laid out as
//     the K-major 128-byte-swizzled tiles wgmma reads, one [N][32] tile pair
//     per (output-channel tile, 32-channel chunk), and arrives through two
//     TMA bulk copies per stage.  A, x * s, is pixel-contiguous in NCHW,
//     which tf32 wgmma cannot read from shared memory, so it is staged by
//     cp.async, scaled and split in registers: the only split in the loop;
//   * sums in two levels: each 32-channel stage's twelve products start a
//     fresh accumulator (scale-d 0), which is added to the total in float32
//     (the tensor core's own accumulation truncates);
//   * a tile's pixels are whole samples where a sample's map
//     fits (8 samples of 4x4, 2 of 8x8: x is read once, with no halo), else
//     a rectangle of one sample plus one halo row above and one halo column
//     to the left, whose taps land in the tile's output rectangle.  Each
//     tile owns its output pixels, so no two tiles write one pixel;
//   * the overlap-add runs from shared memory: each output sums its taps in
//     a fixed order (u, then v, ascending), then takes d.  No atomics and a
//     fixed K order, so two launches give the same bits;
//   * persistent blocks, one per SM, over a 3-stage ring (cp.async for x
//     and s, an mbarrier for the weights) that runs on from one tile to the
//     next: the next tile's first stages load while this tile's last stage
//     and its overlap-add run, which is what the 16-64-channel maps (one or
//     two stages per tile) live on.  The overlap-add takes half of the P tile
//     at a time, in the slot of the tile's last stage.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"
#include "wgmma_tf32.cuh"

namespace upconv {

constexpr int kThreads = 256;   // two warpgroups of 64 pixels each
constexpr int kM = 128;         // pixels per tile
constexpr int kKC = 32;         // input channels per stage (four k8 steps)
constexpr int kStages = 3;
constexpr int kAS = kM + 8;     // A row stride: = 8 mod 32, conflict-free fragment reads
constexpr int kMaxSpt = 32;     // samples per tile at most
constexpr int kMaxSmem = 227 * 1024;

// The tiling, chosen by the wrapper (ops/modconv.py::upsample_tiling).
// Along each axis a tile owns `t` input rows (columns) and loads `l` of them:
// l = t = the whole axis, or l = t + 1 with one halo row above.  Whole
// samples are packed `spt` to a tile.
struct Tiling {
  int b, c, h, w, co, p, oh, ow;
  int spt;
  int tr, lr, hr, tiles_r;
  int tc, lc, hc, tiles_c;
  int n_co, chunks, vec, has_s;
  int tiles;                // (b / spt) * tiles_r * tiles_c * n_co
};

// One ring slot (floats): the weight's hi and lo tiles, 1024-byte aligned
// for the swizzle, the x tile [kKC][kAS] and the style scales [kMaxSpt][kKC].
// After a tile's last stage its slot holds half of the P tile at a time.
template <int kN>
struct Slot {
  static constexpr int kBTile = kN * 32;
  static constexpr int kA = 2 * kBTile;
  static constexpr int kS = kA + kKC * kAS;
  static constexpr int kFloats = (kS + kMaxSpt * kKC + 255) / 256 * 256;
  // row stride of half of P: = 1 mod 32, so that lanes along X, which read
  // rows a pixel apart, fall in different banks
  static constexpr int kPH = kN / 2 + (33 - kN / 2 % 32) % 32;
  static constexpr int kMaxOut = 2 * kM + 4;      // output rows (columns) of a tile at most
  static_assert(kM * kPH + kMaxSpt * 16 + 4 * kMaxOut <= kFloats,
                "half of the P tile, d and the tap tables fit a slot");
  static constexpr int kBytes = kStages * kFloats * 4 + 1024 + 8 * kStages;
};

// n / d for n, d < 2^16, with m = ceil(2^32 / d).
__device__ __forceinline__ int fast_div(int n, unsigned m) {
  return static_cast<int>(__umulhi(static_cast<unsigned>(n), m));
}

struct TileAt {
  int ct, b0, i0, j0;
};

__device__ __forceinline__ TileAt tile_at(const Tiling& T, int tile) {
  TileAt a;
  a.ct = tile % T.n_co;
  int mt = tile / T.n_co;
  a.j0 = (mt % T.tiles_c) * T.tc;
  mt /= T.tiles_c;
  a.i0 = (mt % T.tiles_r) * T.tr;
  a.b0 = (mt / T.tiles_r) * T.spt;
  return a;
}

// Offset of tile pixel m in channel 0 of x, or -1 outside the image.
__device__ __forceinline__ int pixel_offset(const Tiling& T, const TileAt& a, int m) {
  const int per = T.lr * T.lc;
  const int sb = m / per, r = (m % per) / T.lc, cc = m % T.lc;
  const int i = a.i0 - T.hr + r, j = a.j0 - T.hc + cc;
  const bool ok = sb < T.spt && a.b0 + sb < T.b && i >= 0 && i < T.h && j >= 0 && j < T.w;
  return ok ? static_cast<int>((static_cast<long long>(a.b0 + sb) * T.c * T.h + i) * T.w + j)
            : -1;
}

// This thread's pixel in the x copies of load_stage: one pixel, or the
// first of four of a row at 16 bytes.
__device__ __forceinline__ int load_pixel(const Tiling& T) {
  return T.vec ? 4 * (threadIdx.x % 32) : threadIdx.x % kM;
}

// Copy stage `chunk` of tile `a` into `slot`: the weight tile pair (TMA, on
// the slot's mbarrier), this thread's x copies from offset `o` of its pixel
// (load_pixel) and the stage's style scales.
template <int kN>
__device__ __forceinline__ void load_stage(float* slot, uint64_t* bar, const Tiling& T,
                                           const float* __restrict__ x,
                                           const float* __restrict__ s,
                                           const float* __restrict__ wimg, const TileAt& a,
                                           int o, int chunk) {
  using S = Slot<kN>;
  const int tid = threadIdx.x;
  if (tid == 0) {
    const float* src = wimg + (static_cast<long long>(a.ct) * T.chunks + chunk) * 2 * S::kBTile;
    wgmma::mbar_expect_tx(bar, 2 * S::kBTile * 4);
    wgmma::bulk_copy(slot, src, S::kBTile * 4, bar);
    wgmma::bulk_copy(slot + S::kBTile, src + S::kBTile, S::kBTile * 4, bar);
  }
  const int c0 = chunk * kKC;
  const long long plane = static_cast<long long>(T.h) * T.w;
  float* as = slot + S::kA;
  const int m = load_pixel(T);
  if (T.vec) {  // pixels m .. m + 3 of one row, channels tid / 32 + 8 r
#pragma unroll
    for (int r = 0; r < kKC * kM / 4 / kThreads; ++r) {
      const int ck = tid / 32 + 8 * r;
      const bool ok = o >= 0 && c0 + ck < T.c;
      tf32x3::cp_async16(as + ck * kAS + m, ok ? x + o + (c0 + ck) * plane : x, ok);
    }
  } else {      // pixel m, channels tid / 128 + 2 r
#pragma unroll 4
    for (int r = 0; r < kKC * kM / kThreads; ++r) {
      const int ck = tid / kM + 2 * r;
      const bool ok = o >= 0 && c0 + ck < T.c;
      tf32x3::cp_async4(as + ck * kAS + m, ok ? x + o + (c0 + ck) * plane : x, ok);
    }
  }
  if (T.has_s) {
    float* ss = slot + S::kS;
    for (int idx = tid; idx < T.spt * kKC; idx += kThreads) {
      const int sb = idx / kKC, ck = idx % kKC;
      const bool ok = a.b0 + sb < T.b && c0 + ck < T.c;
      tf32x3::cp_async4(ss + idx, ok ? s + static_cast<long long>(a.b0 + sb) * T.c + c0 + ck : s,
                        ok);
    }
  }
}

// Persistent blocks: block i takes tiles i, i + gridDim.x, ...; the ring
// runs on across tiles, so the next tile's first stages load while this
// tile's last stage and its overlap-add run.
template <int kK, int kCoT>
__global__ void __launch_bounds__(kThreads, 1)
upconv_kernel(const float* __restrict__ x, const float* __restrict__ wimg,
              const float* __restrict__ s, const float* __restrict__ dmod,
              float* __restrict__ y, const __grid_constant__ Tiling T) {
  constexpr int kN = kK * kK * kCoT;
  constexpr int kHalf = kCoT / 2;   // output channels per overlap-add pass
  using S = Slot<kN>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzled weight tiles need 1024-byte alignment
  const uint32_t raw = wgmma::smem_addr(smem_raw);
  float* ring = reinterpret_cast<float*>(smem_raw + ((1024 - raw % 1024) % 1024));
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + kStages * S::kFloats);

  const int tid = threadIdx.x;
  const int my_tiles = T.tiles > static_cast<int>(blockIdx.x)
      ? (T.tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1 : 0;
  const int steps = my_tiles * T.chunks;
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) wgmma::mbar_init(bar + st, 1);
    wgmma::fence_barrier_init();
  }
  __syncthreads();

  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int m_a = 64 * (tid / 128) + 16 * ((tid % 128) / 32) + g;  // fragment rows m_a, m_a + 8
  const int m_b = m_a + 8;
  const int per = T.lr * T.lc;  // pixels of one sample's tile
  const int s_a = min(m_a / per, T.spt - 1), s_b = min(m_b / per, T.spt - 1);
  // the tile being loaded and this thread's x offset in it
  int ld_tile = -1, ld_off = -1;
  TileAt ld = {};
  auto load = [&](int step) {
    const int tile = static_cast<int>(blockIdx.x)
                     + (step / T.chunks) * static_cast<int>(gridDim.x);
    if (tile != ld_tile) {
      ld_tile = tile;
      ld = tile_at(T, tile);
      ld_off = pixel_offset(T, ld, load_pixel(T));
    }
    load_stage<kN>(ring + (step % kStages) * S::kFloats, bar + step % kStages, T, x, s, wimg,
                   ld, ld_off, step % T.chunks);
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load(st);
    tf32x3::cp_async_commit();
  }

  float total[kN / 2], part[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) part[i] = 0.f;
  int step = 0;
  for (int ti = 0; ti < my_tiles; ++ti) {
    const TileAt a = tile_at(T, static_cast<int>(blockIdx.x) + ti * static_cast<int>(gridDim.x));
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) total[i] = 0.f;
    float* slot = ring;
    for (int chunk = 0; chunk < T.chunks; ++chunk, ++step) {
      slot = ring + (step % kStages) * S::kFloats;
      tf32x3::cp_async_wait<kStages - 2>();
      wgmma::mbar_wait(bar + step % kStages, (step / kStages) & 1);
      __syncthreads();  // the stage is in; every warpgroup is done with the slot refilled next
      const int next = step + kStages - 1;
      if (next < steps) load(next);
      tf32x3::cp_async_commit();

      // A: x * s for rows m_a, m_b and the stage's channels, split in registers
      const float* as = slot + S::kA;
      const float* ss = slot + S::kS;
      uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ck = 8 * j + t + 4 * (e / 2);
          float v = as[ck * kAS + (e % 2 ? m_b : m_a)];
          if (T.has_s) v *= ss[(e % 2 ? s_b : s_a) * kKC + ck];
          tf32x3::split(v, a_hi[j][e], a_lo[j][e]);
        }
      const uint64_t d_hi = wgmma::desc_sw128(wgmma::smem_addr(slot));
      const uint64_t d_lo = wgmma::desc_sw128(wgmma::smem_addr(slot + S::kBTile));
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) wgmma::fence_operand(part[i]);
      wgmma::fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // k8 step j: the descriptors advance 32 bytes
        wgmma::mma<kN>(part, a_lo[j], d_hi + 2 * j, j > 0);
        wgmma::mma<kN>(part, a_hi[j], d_lo + 2 * j, 1);
        wgmma::mma<kN>(part, a_hi[j], d_hi + 2 * j, 1);
      }
      wgmma::commit();
      wgmma::wait<0>();
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) wgmma::fence_operand(part[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          wgmma::fence_operand(a_hi[j][e]);
          wgmma::fence_operand(a_lo[j][e]);
        }
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) total[i] += part[i];
    }
    __syncthreads();  // every warpgroup is done with the last stage's slot

    // Overlap-add into the tile's own output rectangle, kHalf channels at a
    // time through half of P [kM][kPH] in the last stage's slot (column tap *
    // kHalf + o), taps in a fixed order.
    const bool last_r = a.i0 + T.tr >= T.h, last_c = a.j0 + T.tc >= T.w;
    const int y0 = a.i0 == 0 ? 0 : 2 * a.i0 - T.p;
    const int y1 = last_r ? T.oh : 2 * (a.i0 + T.tr) - T.p;
    const int x0 = a.j0 == 0 ? 0 : 2 * a.j0 - T.p;
    const int x1 = last_c ? T.ow : 2 * (a.j0 + T.tc) - T.p;
    const int ny = y1 - y0, nx = x1 - x0;
    const int ilo = a.i0 - T.hr, jlo = a.j0 - T.hc;
    const int count = T.spt * kHalf * ny * nx;   // < 2^16: fast_div is exact
    const unsigned m_nx = 0xFFFFFFFFu / nx + 1, m_ny = 0xFFFFFFFFu / ny + 1;
    float* P = slot;
    float* dsm = slot + kM * S::kPH;  // d of the tile's samples and channels
    // The taps that reach output row Y are u = (Y + p) mod 2 and u + 2, each
    // from input row (Y + p - u) / 2: rtab[Y - y0] holds, for each, its
    // offset in P (local row * lc * kPH + u * k * kHalf), or -1 where it
    // misses the image.  Likewise ctab for columns (local column * kPH + v *
    // kHalf).
    int2* rtab = reinterpret_cast<int2*>(dsm + kMaxSpt * 16);
    int2* ctab = rtab + S::kMaxOut;
    for (int i = tid; i < ny + nx; i += kThreads) {
      const bool is_row = i < ny;
      const int z = is_row ? y0 + i : x0 + i - ny;
      const int n = is_row ? T.h : T.w, lo = is_row ? ilo : jlo;
      const int stride = is_row ? T.lc * S::kPH : S::kPH;
      const int tap = is_row ? kK * kHalf : kHalf;
      int off[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int u = ((z + T.p) & 1) + 2 * q, iz = z + T.p - u;
        off[q] = u < kK && iz >= 0 && (iz >> 1) < n ? ((iz >> 1) - lo) * stride + u * tap : -1;
      }
      (is_row ? rtab[i] : ctab[i - ny]) = make_int2(off[0], off[1]);
    }
    for (int i = tid; dmod && i < T.spt * kCoT; i += kThreads) {
      const int sb = i / kCoT, o = a.ct * kCoT + i % kCoT;
      dsm[i] = a.b0 + sb < T.b && o < T.co
               ? dmod[static_cast<long long>(a.b0 + sb) * T.co + o] : 0.f;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // d[4q + e] = P[m_a + 8 (e / 2)][8q + 2t + e % 2]: n = tap * kCoT + o
#pragma unroll
      for (int q = 0; q < kN / 8; ++q) {
        const int n = 8 * q + 2 * t;
        const int tap = n / kCoT, o = n % kCoT;
        if (o / kHalf == half) {
          const int col = tap * kHalf + o - half * kHalf;
          P[m_a * S::kPH + col] = total[4 * q];
          P[m_a * S::kPH + col + 1] = total[4 * q + 1];
          P[m_b * S::kPH + col] = total[4 * q + 2];
          P[m_b * S::kPH + col + 1] = total[4 * q + 3];
        }
      }
      __syncthreads();
      // the outputs [spt][kHalf][ny][nx] spread over the threads, X fastest
      for (int e = tid; e < count; e += kThreads) {
        const int row = fast_div(e, m_nx), xx = e - row * nx;
        const int rest = fast_div(row, m_ny), yy = row - rest * ny;
        const int oh = rest % kHalf, sb = rest / kHalf;
        const int bb = a.b0 + sb, ol = half * kHalf + oh, o = a.ct * kCoT + ol;
        if (bb >= T.b || o >= T.co) continue;
        const int2 ru = rtab[yy], cv = ctab[xx];
        const float* pm = P + sb * per * S::kPH + oh;
        float val = 0.f;   // taps (u, v) in ascending order
        if (ru.x >= 0) {
          if (cv.x >= 0) val += pm[ru.x + cv.x];
          if (cv.y >= 0) val += pm[ru.x + cv.y];
        }
        if (ru.y >= 0) {
          if (cv.x >= 0) val += pm[ru.y + cv.x];
          if (cv.y >= 0) val += pm[ru.y + cv.y];
        }
        if (dmod) val *= dsm[sb * kCoT + ol];
        y[((static_cast<long long>(bb) * T.co + o) * T.oh + y0 + yy) * T.ow + x0 + xx] = val;
      }
      __syncthreads();
    }
    // order these generic accesses before the TMA that refills the slot
    wgmma::fence_proxy_async();
  }
  tf32x3::cp_async_wait<0>();
}

template <int kK, int kCoT>
cudaError_t launch(const float* x, const float* wimg, const float* s, const float* dmod,
                   float* y, const Tiling& T, cudaStream_t stream) {
  constexpr int kBytes = Slot<kK * kK * kCoT>::kBytes;
  static_assert(kBytes <= kMaxSmem, "the ring does not fit in shared memory");
  auto kernel = upconv_kernel<kK, kCoT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return attr;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = T.tiles < sms ? T.tiles : sms;  // one block per SM
  kernel<<<blocks, kThreads, kBytes, stream>>>(x, wimg, s, dmod, y, T);
  return cudaGetLastError();
}

}  // namespace upconv

// x [b, c, h, w]; wimg: the layer's split weight (ops/modconv.py::
// upsample_weight_image), [n_co][chunks][hi, lo][k^2 * cot][32] swizzled;
// s [b, c] or null; dmod [b, co] or null; y [b, co, oh, ow] with oh = 2h + k
// - 2 - 2p; tiling (host memory): spt, tr, lr, hr, tiles_r, tc, lc, hc,
// tiles_c.  Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int ganspace_upsample_conv(const float* x, const float* wimg, const float* s,
                                      const float* dmod, float* y, const int* tiling, int b,
                                      int c, int h, int w, int co, int k, int p,
                                      void* stream) {
  using upconv::Tiling;
  Tiling T = {};
  T.b = b, T.c = c, T.h = h, T.w = w, T.co = co, T.p = p;
  T.oh = 2 * h + k - 2 - 2 * p, T.ow = 2 * w + k - 2 - 2 * p;
  T.spt = tiling[0];
  T.tr = tiling[1], T.lr = tiling[2], T.hr = tiling[3], T.tiles_r = tiling[4];
  T.tc = tiling[5], T.lc = tiling[6], T.hc = tiling[7], T.tiles_c = tiling[8];
  const int cot = k == 3 ? 16 : 8;
  T.vec = T.hc == 0 && w % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  T.n_co = (co + cot - 1) / cot;
  T.chunks = (c + upconv::kKC - 1) / upconv::kKC;
  T.has_s = s != nullptr;
  bool ok = (k == 3 || k == 4) && (p == 0 || p == 1) && b > 0 && c > 0 && co > 0
            && T.spt >= 1 && T.spt <= upconv::kMaxSpt && T.lr * T.lc * T.spt <= upconv::kM
            && T.tr >= 1 && T.tc >= 1 && T.lr == T.tr + T.hr && T.lc == T.tc + T.hc
            && T.tiles_r == (h + T.tr - 1) / T.tr && T.tiles_c == (w + T.tc - 1) / T.tc
            && (T.spt == 1 || (T.hr == 0 && T.hc == 0))
            && static_cast<long long>(b) * c * h * w < (1LL << 31)
            && reinterpret_cast<uintptr_t>(wimg) % 16 == 0;
  if (ok) {
    const long long tiles = static_cast<long long>((b + T.spt - 1) / T.spt) * T.tiles_r
                            * T.tiles_c * T.n_co;
    ok = tiles < (1LL << 31);
    T.tiles = static_cast<int>(tiles);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(k == 3 ? upconv::launch<3, 16>(x, wimg, s, dmod, y, T, st)
                                 : upconv::launch<4, 8>(x, wimg, s, dmod, y, T, st));
}
