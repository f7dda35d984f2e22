// The stride-2 kernel's bf16 datapath (the preview policy of
// ops/precision.py; modes 1 and 2 of ganspace_upsample_conv): a stride-2
// transposed convolution, NCHW, on bf16 operands with float32 sums, x and y
// stored in float32 (mode 1) or bf16 (mode 2):
//
//   y = d * conv_transpose2d(bf16(x * s), bf16(wt), stride 2, padding p)
//
// with s [b, c] and d [b, co] optional, k = 3 or 4, p = 0 or 1, and y
// rounded to x's storage.  As in upconv2x.cu (the 3xTF32 mode), the layer is
// the dense product P[pixel, (tap, o)] = sum_c A[pixel, c] * B[(tap, o), c]
// (M = input pixels, N = k^2 x output channels, K = input channels) followed
// by an overlap-add of the k^2 tap products into the output.
//
// Replaces no TPU kernel: the JAX package leaves the transposed convolution
// to XLA, at the preview precision (ganspace_tpu/ops/modconv.py, StyleGAN2's
// upsampling; ganspace_tpu/models/stylegan.py:156-166, StyleGAN's fused
// conv0_up; ganspace_tpu/ops/s2d.py:370-382, BigGAN's and ProGAN's
// nearest-up convs on composite 4x4 kernels).
//
// What bounds it: 2 k^2 C Co operations per input pixel on the bf16 tensor
// cores, bound by them at the 512-channel shapes (4-64 px) and by the bytes
// of x and y at the 128-1024 px maps with 16-128 channels.  The design:
//   * a tile is 128 input pixels (upsample_tiling_bf16 in ops/modconv.py:
//     whole samples where they fit, else a rectangle of one sample with one
//     halo row above and one halo column to the left, its owned columns a
//     multiple of 8 so that its rows start on 16-byte boundaries) by N =
//     k^2 * 16 columns (144 for k = 3, 256 for k = 4): one m64nNk16 wgmma
//     per warpgroup and k16 step (wgmma_bf16.cuh), 64 input channels a
//     stage, both operands read from shared memory;
//   * B, the weight, is a bf16 image made once per layer by the wrapper
//     (ops/modconv.py::upsample_weight_image_bf16: K-major, 64 channels per
//     128-byte swizzled row), one TMA bulk copy per stage into a ring of
//     kBStages slots, completed on an mbarrier;
//   * x lands in x's own storage by one TMA tensor copy a stage (a box of
//     whole samples, or of the tile's loaded rows and columns; zeros where
//     it leaves the image; element copies only where x's strides are not
//     multiples of 16 bytes), s by cp.async beside it, in a ring of two raw
//     slots;
//   * one pass per stage forms A = bf16(x * s) (x's bf16 bits as they are
//     where there is no s) into a K-major 128-byte-swizzled tile that both
//     warpgroups' wgmma read, each element rounded once; the pass of stage
//     t + 1 runs while stage t's wgmma group is in flight (A is
//     double-buffered);
//   * one float32 sum over all stages in the wgmma accumulator (bf16
//     products are exact in float32; the float32-storage bar of 1e-5
//     relative holds without a second level: chip_smoke.py, PERF.md);
//   * the overlap-add, as in upconv2x.cu, writes the tile's own output
//     rectangle, each output summing its taps in a fixed order (u, then v,
//     ascending), d in float32, then y rounded to x's storage.  P passes
//     through shared memory kPCh output channels at a time, column-major so
//     that both its writes and its reads are free of bank conflicts; a
//     thread takes a 2 x 2 block of outputs (k = 3, padding 0: nine taps
//     read once) or two neighbouring outputs of a row, finds their taps'
//     offsets once and runs over the channels.  Where P holds all 16
//     channels (k = 3, bf16 storage) a tile's outputs are written while the
//     next stage's wgmma group runs;
//   * persistent blocks, one per SM; each block walks its steps with
//     cursors (no division but once a tile), so the next tile's first
//     stages load while this tile's last stage and its overlap-add run.
// No atomics and a fixed summation order: two launches give the same bits.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tf32x3.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace upconv_bf16 {

constexpr int kThreads = 256;   // two warpgroups of 64 pixels each
constexpr int kM = 128;         // pixels per tile
constexpr int kKC = 64;         // input channels per stage (four k16 steps)
constexpr int kCoT = 16;        // output channels per tile
constexpr int kMaxSpt = 8;      // samples per tile at most
constexpr int kRawPix = 168;    // raw elements of one channel in a stage at most
// raw slots: deeper rings (3-4 slots, at the cost of P's width) measured no
// faster on the H100 (PERF.md)
constexpr int kRawStages = 2;
constexpr int kMaxOut = 2 * kM + 4;   // output rows (columns) of a tile at most
constexpr int kMaxSmem = 227 * 1024;

// The tiling, chosen by the wrapper (ops/modconv.py::upsample_tiling_bf16),
// and the raw layout of a stage derived from it by ganspace_upsample_conv.
// Along each axis a tile owns `t` input rows (columns) and loads `l` of them:
// l = t = the whole axis, or l = t + 1 with one halo row above.  Whole
// samples are packed `spt` to a tile.
struct Tiling {
  int b, c, h, w, co, p, oh, ow;
  int spt;
  int tr, lr, hr, tiles_r;
  int tc, lc, hc, tiles_c;
  int n_co, chunks, has_s;
  int tiles;                // (b / spt) * tiles_r * tiles_c * n_co
  // A stage's raw x (elements): whole samples (hr = hc = 0), [spt][64][rw]
  // with a sample's map flat in a run of rw >= h * w; else rows, [64][lr][rw]
  // with local column cc (image column j0 - hc + cc) at coff + cc: with a
  // halo column the row starts on the 16-byte boundary j0 - coff - 1, so
  // coff = 16 / sizeof(TX) - 1 (the tiling's owned columns are a multiple
  // of 8).  `cs` and `ss` are the channel and sample strides.  `tma`: one
  // tensor copy a stage (a 3-d box of whole samples, a 4-d one of rows);
  // else element copies of `run` elements per (sample or row, channel),
  // `runs` per channel.
  int rw, cs, ss, coff, tma, run, runs;
  unsigned m_run, m_runs;          // div_magic of run and runs
  int box_bytes;
};

// B slots: three for k = 3 and bf16 storage, else two, so that P holds 16
// output channels (k = 3) or 8 (k = 4, bf16 storage)
constexpr int b_stages(int k, bool f32) { return k == 3 && !f32 ? 3 : 2; }

// The shared-memory layout of one instantiation (bytes).  B slots and the
// A tiles first, 1024-byte aligned for the swizzle.
template <int kK, typename TX>
struct Layout {
  static constexpr bool kF32 = sizeof(TX) == 4;
  static constexpr int kTaps = kK * kK;
  static constexpr int kN = kTaps * kCoT;              // 144 or 256
  static constexpr int kBBytes = kN * 128;             // one stage's weight tile
  static constexpr int kBStages = b_stages(kK, kF32);
  static constexpr int kABytes = kM * 128;             // one A tile
  static constexpr int kRawBytes = kKC * kRawPix * static_cast<int>(sizeof(TX));
  static constexpr int kSFloats = kMaxSpt * kKC;
  static constexpr int kFixed = kBStages * kBBytes + 2 * kABytes
                                + kRawStages * (kRawBytes + kSFloats * 4)
                                + 2 * kMaxOut * 8 + kMaxSpt * kCoT * 4
                                + 8 * (kBStages + kRawStages) + 1024;
  // P [kTaps * kPCh][kPM] for kPCh output channels, a column's pixels
  // contiguous: kPM = 4 mod 32, so that the accumulator's lanes (8 rows by 4
  // column pairs) store to 32 distinct banks, and lanes along X, which read
  // pixels in turn, read consecutive words
  static constexpr int kPM = kM + 4;
  static constexpr bool fits(int ch) { return kFixed + kTaps * ch * kPM * 4 <= kMaxSmem; }
  static constexpr int kPCh = fits(16) ? 16 : fits(8) ? 8 : 4;
  static_assert(fits(kPCh), "the ring, the A tiles and P do not fit in shared memory");
  static constexpr int kBytes = kFixed + kTaps * kPCh * kPM * 4;
};

// ceil(2^32 / d) for 1 < d < 2^16, and 0 for d = 1 (fast_div's divisor).
__host__ __device__ __forceinline__ unsigned div_magic(int d) {
  return d == 1 ? 0u : 0xFFFFFFFFu / static_cast<unsigned>(d) + 1;
}

// n / d for n, d < 2^16, with m = div_magic(d).
__device__ __forceinline__ int fast_div(int n, unsigned m) {
  return m ? static_cast<int>(__umulhi(static_cast<unsigned>(n), m)) : n;
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

// A block's walk over its steps (a tile's stages, then the next tile's):
// the stage and tile of one step, advanced without a division but once a
// tile.
struct Cursor {
  int chunk, tile;
  TileAt at;
  __device__ __forceinline__ void start(const Tiling& T, int first) {
    chunk = 0, tile = first, at = tile_at(T, first);
  }
  __device__ __forceinline__ void next(const Tiling& T, int grid) {
    if (++chunk == T.chunks) {
      chunk = 0, tile += grid;
      at = tile_at(T, tile);
    }
  }
};

// One element copy of x into the raw slot: cp.async for float32; a bf16
// element, under cp.async's 4 bytes, by a plain load (the slot being filled
// is read by no thread until a later step's barrier).
__device__ __forceinline__ void copy1(float* dst, const float* x, long long off, bool ok) {
  tf32x3::cp_async4(dst, ok ? x + off : x, ok);
}

__device__ __forceinline__ void copy1(__nv_bfloat16* dst, const __nv_bfloat16* x, long long off,
                                      bool ok) {
  *dst = ok ? x[off] : __ushort_as_bfloat16(0);
}

// A tensor copy (TMA) of a 3-d or 4-d box of x at coordinates c (innermost
// first) into shared memory, completed on `bar`; the box's parts outside x
// land as zeros.
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int dims,
                                            const int (&c)[4], uint64_t* bar) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (dims == 3)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4}], [%5];\n"
        :: "r"(wgmma::smem_addr(dst)), "l"(m), "r"(c[0]), "r"(c[1]), "r"(c[2]),
           "r"(wgmma::smem_addr(bar)) : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(wgmma::smem_addr(dst)), "l"(m), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]),
           "r"(wgmma::smem_addr(bar)) : "memory");
}

// Copy stage `chunk` of tile `a` into raw slot `raw` (x, TX) and `ss` (s):
// zeros outside the image and past the last sample and channel.  x comes by
// one tensor copy (thread 0, on `bar`) or, where x's strides do not allow
// one, by element copies.
template <typename TX>
__device__ __forceinline__ void load_raw(TX* raw, float* ss, uint64_t* bar, const Tiling& T,
                                         const CUtensorMap* xmap, const TX* __restrict__ x,
                                         const float* __restrict__ s, const TileAt& a,
                                         int chunk) {
  const int tid = threadIdx.x;
  const int c0 = chunk * kKC;
  const bool whole = T.hr == 0 && T.hc == 0;
  if (T.tma) {
    if (tid == 0) {
      const int c[4] = {whole ? 0 : a.j0 - T.hc - T.coff, whole ? c0 : a.i0 - T.hr,
                        whole ? a.b0 : c0, a.b0};
      wgmma::mbar_expect_tx(bar, T.box_bytes);
      tensor_copy(raw, xmap, whole ? 3 : 4, c, bar);
    }
  } else {
    // element copies: run `r` of channel ck is sample b0 + r's map (whole
    // samples) or loaded row r (rows)
    const int total = kKC * T.runs * T.run;
    for (int idx = tid; idx < total; idx += kThreads) {
      const int rr = fast_div(idx, T.m_run);
      const int e = idx - rr * T.run;
      const int ck = fast_div(rr, T.m_runs);
      const int r = rr - ck * T.runs;
      const int c = c0 + ck;
      if (whole) {
        const int bb = a.b0 + r;
        const bool ok = bb < T.b && c < T.c;
        copy1(raw + r * T.ss + ck * T.cs + e, x,
              (static_cast<long long>(bb) * T.c + c) * T.h * T.w + e, ok);
      } else {
        const int i = a.i0 - T.hr + r, j = a.j0 - T.hc + e;
        const bool ok = a.b0 < T.b && c < T.c && i >= 0 && i < T.h && j >= 0 && j < T.w;
        copy1(raw + ck * T.cs + r * T.rw + T.coff + e, x,
              ((static_cast<long long>(a.b0) * T.c + c) * T.h + i) * T.w + j, ok);
      }
    }
  }
  if (T.has_s) {
    for (int idx = tid; idx < T.spt * kKC; idx += kThreads) {
      const int sb = idx / kKC, ck = idx % kKC;
      const bool ok = a.b0 + sb < T.b && c0 + ck < T.c;
      tf32x3::cp_async4(ss + idx, ok ? s + static_cast<long long>(a.b0 + sb) * T.c + c0 + ck : s,
                        ok);
    }
  }
}

// Form this thread's four chunks of the A tile (row pm, chunks pj, pj + 2,
// pj + 4, pj + 6: channels 8j .. 8j + 7) from the raw slot (channel stride
// cs): bf16(x * s), each element rounded once; zeros for a row past the
// tile's pixels (poff < 0) and for chunks past the stage's nc channels.
template <typename TX>
__device__ __forceinline__ void form_a(unsigned char* A, const TX* raw, const float* ss,
                                       bool has_s, int cs, int nc, int pm, int pj, int poff,
                                       int psb) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = pj + 2 * i;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (poff >= 0 && 8 * j < nc) {
      const TX* src = raw + 8 * j * cs + poff;
      if (std::is_same<TX, __nv_bfloat16>::value && !has_s) {
        // bf16 storage, no scale: the stored bits are A's
        const unsigned short* u = reinterpret_cast<const unsigned short*>(src);
        uint32_t* p = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = static_cast<uint32_t>(u[2 * e * cs])
                 | (static_cast<uint32_t>(u[(2 * e + 1) * cs]) << 16);
      } else {
        float f[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = tf32x3::widen(src[e * cs]);
        if (has_s) {
          const float4 s0 = *reinterpret_cast<const float4*>(ss + psb * kKC + 8 * j);
          const float4 s1 = *reinterpret_cast<const float4*>(ss + psb * kKC + 8 * j + 4);
          f[0] *= s0.x, f[1] *= s0.y, f[2] *= s0.z, f[3] *= s0.w;
          f[4] *= s1.x, f[5] *= s1.y, f[6] *= s1.z, f[7] *= s1.w;
        }
        v = wgmma_bf16::pack8(f);
      }
    }
    wgmma_bf16::store_chunk(A, pm, j, v);
  }
}

// The overlap-add of a tile, in three parts: oa_tables (its tap tables and
// d), oa_dump (kPCh output channels of the accumulators into P, column tap
// * kPCh + o) and oa_emit (those channels' outputs from P).
//
// The tile's output rectangle: rows y0 .. y1 - 1, columns x0 .. x1 - 1.
struct OutRect {
  int y0, x0, ny, nx;
};

__device__ __forceinline__ OutRect out_rect(const Tiling& T, const TileAt& a) {
  const bool last_r = a.i0 + T.tr >= T.h, last_c = a.j0 + T.tc >= T.w;
  OutRect r;
  r.y0 = a.i0 == 0 ? 0 : 2 * a.i0 - T.p;
  r.x0 = a.j0 == 0 ? 0 : 2 * a.j0 - T.p;
  r.ny = (last_r ? T.oh : 2 * (a.i0 + T.tr) - T.p) - r.y0;
  r.nx = (last_c ? T.ow : 2 * (a.j0 + T.tc) - T.p) - r.x0;
  return r;
}

// The taps that reach output row Y are u = (Y + p) mod 2 and u + 2, each
// from input row (Y + p - u) / 2: rtab[Y - y0] holds, for each, its offset
// in P (local row * lc + u * k * kPCh * kPM), or -1 where it misses the
// image.  Likewise ctab for columns (local column + v * kPCh * kPM).  dsm:
// d of the tile's samples and channels.
template <int kK, typename TX>
__device__ __forceinline__ void oa_tables(int2* rtab, int2* ctab, float* dsm, const Tiling& T,
                                          const TileAt& a, const float* __restrict__ dmod) {
  using L = Layout<kK, TX>;
  const int tid = threadIdx.x;
  const OutRect r = out_rect(T, a);
  const int ilo = a.i0 - T.hr, jlo = a.j0 - T.hc;
  for (int i = tid; i < r.ny + r.nx; i += kThreads) {
    const bool is_row = i < r.ny;
    const int z = is_row ? r.y0 + i : r.x0 + i - r.ny;
    const int n = is_row ? T.h : T.w, lo = is_row ? ilo : jlo;
    const int stride = is_row ? T.lc : 1;
    const int tap = (is_row ? kK * L::kPCh : L::kPCh) * L::kPM;
    int off[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int u = ((z + T.p) & 1) + 2 * q, iz = z + T.p - u;
      off[q] = u < kK && iz >= 0 && (iz >> 1) < n ? ((iz >> 1) - lo) * stride + u * tap : -1;
    }
    (is_row ? rtab[i] : ctab[i - r.ny]) = make_int2(off[0], off[1]);
  }
  for (int i = tid; dmod && i < T.spt * kCoT; i += kThreads) {
    const int sb = i / kCoT, o = a.ct * kCoT + i % kCoT;
    dsm[i] = a.b0 + sb < T.b && o < T.co ? dmod[static_cast<long long>(a.b0 + sb) * T.co + o]
                                         : 0.f;
  }
}

// acc[4q + e] = D[m_a + 8 (e / 2)][8q + 2t + e % 2], n = tap * kCoT + o:
// the columns of output channels part * kPCh .. + kPCh - 1 into P.
template <int kK, typename TX>
__device__ __forceinline__ void oa_dump(const float (&acc)[Layout<kK, TX>::kN / 2], float* P,
                                        int part, int m_a, int t) {
  using L = Layout<kK, TX>;
  const int m_b = m_a + 8;
#pragma unroll
  for (int q = 0; q < L::kN / 8; ++q) {
    const int n = 8 * q + 2 * t;
    const int tap = n / kCoT, o = n % kCoT;
    if (o / L::kPCh == part) {
      float* pc = P + (tap * L::kPCh + o % L::kPCh) * L::kPM;
      pc[m_a] = acc[4 * q];
      pc[L::kPM + m_a] = acc[4 * q + 1];
      pc[m_b] = acc[4 * q + 2];
      pc[L::kPM + m_b] = acc[4 * q + 3];
    }
  }
}

// The outputs of channels part * kPCh .. + kPCh - 1 from P.  A thread takes
// two neighbouring outputs of a row (local columns 2q, 2q + 1) of one
// sample, their taps' offsets found once, and runs over the channels: each
// output sums its taps in a fixed order (u, then v, ascending), a missing
// tap adding +0 (exact: the sum starts at +0 and so is never -0), then
// takes d, then is rounded to the storage.
template <int kK, typename TX>
__device__ __forceinline__ void oa_emit(const float* P, const int2* rtab, const int2* ctab,
                                        const float* dsm, const Tiling& T, const TileAt& a,
                                        int part, bool has_d, TX* __restrict__ y) {
  using L = Layout<kK, TX>;
  constexpr int kPCh = L::kPCh;
  const OutRect r = out_rect(T, a);
  const int per = T.lr * T.lc;
  const int npq = (r.nx + 1) >> 1;
  const int count = T.spt * r.ny * npq;     // < 2^16: fast_div is exact
  const unsigned m_q = div_magic(npq), m_y = div_magic(r.ny);
  const long long plane = static_cast<long long>(T.oh) * T.ow;
  const int o0 = a.ct * kCoT + part * kPCh;
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const int row = fast_div(e, m_q), q = e - row * npq;
    const int sb = fast_div(row, m_y), yy = row - sb * r.ny;
    const int bb = a.b0 + sb;
    if (bb >= T.b) continue;
    const int xx = 2 * q;
    const bool two = xx + 1 < r.nx;
    const int2 ru = rtab[yy], c0 = ctab[xx];
    const int2 c1 = two ? ctab[xx + 1] : make_int2(-1, -1);
    // the P offsets of the two outputs' taps in the fixed order, -1 for none
    const int f0[4] = {ru.x >= 0 && c0.x >= 0 ? ru.x + c0.x : -1,
                       ru.x >= 0 && c0.y >= 0 ? ru.x + c0.y : -1,
                       ru.y >= 0 && c0.x >= 0 ? ru.y + c0.x : -1,
                       ru.y >= 0 && c0.y >= 0 ? ru.y + c0.y : -1};
    const int f1[4] = {ru.x >= 0 && c1.x >= 0 ? ru.x + c1.x : -1,
                       ru.x >= 0 && c1.y >= 0 ? ru.x + c1.y : -1,
                       ru.y >= 0 && c1.x >= 0 ? ru.y + c1.x : -1,
                       ru.y >= 0 && c1.y >= 0 ? ru.y + c1.y : -1};
    const float* pm = P + sb * per;
    TX* out = y + ((static_cast<long long>(bb) * T.co + o0) * T.oh + r.y0 + yy) * T.ow
              + r.x0 + xx;
#pragma unroll
    for (int oh = 0; oh < kPCh; ++oh) {
      if (o0 + oh < T.co) {
        float v0 = 0.f, v1 = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p0 = pm[max(f0[i], 0) + oh * L::kPM];
          const float p1 = pm[max(f1[i], 0) + oh * L::kPM];
          v0 += f0[i] >= 0 ? p0 : 0.f;
          v1 += f1[i] >= 0 ? p1 : 0.f;
        }
        if (has_d) {
          const float dd = dsm[sb * kCoT + part * kPCh + oh];
          v0 *= dd;
          v1 *= dd;
        }
        tf32x3::store(out + oh * plane, v0);
        if (two) tf32x3::store(out + oh * plane + 1, v1);
      }
    }
  }
}

// oa_emit for k = 3 and padding 0 (StyleGAN2's up-convs), where output
// parity fixes the taps: an even row (column) takes u (v) = 0 and 2, an odd
// one u (v) = 1 alone.  A thread takes a 2 x 2 block of outputs (local rows
// 2yb, 2yb + 1, columns 2xb, 2xb + 1; y0 and x0 are even) and half of the
// channels, and reads each of the block's nine taps once: the same sums, in
// the same order, as oa_emit's.
template <typename TX>
__device__ __forceinline__ void oa_emit_k3(const float* P, const int2* rtab, const int2* ctab,
                                           const float* dsm, const Tiling& T, const TileAt& a,
                                           int part, bool has_d, TX* __restrict__ y) {
  using L = Layout<3, TX>;
  constexpr int kHalf = L::kPCh / 2;
  const OutRect r = out_rect(T, a);
  const int per = T.lr * T.lc;
  const int nyb = (r.ny + 1) >> 1, nxb = (r.nx + 1) >> 1;
  const int count = T.spt * nyb * nxb * 2;   // < 2^16: fast_div is exact
  const unsigned m_x = div_magic(nxb), m_y = div_magic(nyb);
  const long long plane = static_cast<long long>(T.oh) * T.ow;
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const int rest = fast_div(e, m_x), xb = e - rest * nxb;
    const int half = rest & 1, row = rest >> 1;
    const int sb = fast_div(row, m_y), yb = row - sb * nyb;
    const int bb = a.b0 + sb;
    if (bb >= T.b) continue;
    const int yy = 2 * yb, xx = 2 * xb;
    const bool y2 = yy + 1 < r.ny, x2 = xx + 1 < r.nx;
    const int2 re = rtab[yy], ce = ctab[xx];
    const int ro = y2 ? rtab[yy + 1].x : -1, co = x2 ? ctab[xx + 1].x : -1;
    // the nine taps' offsets, -1 for none: (even or odd row, even or odd column)
    const int t_ee[4] = {re.x >= 0 && ce.x >= 0 ? re.x + ce.x : -1,
                         re.x >= 0 && ce.y >= 0 ? re.x + ce.y : -1,
                         re.y >= 0 && ce.x >= 0 ? re.y + ce.x : -1,
                         re.y >= 0 && ce.y >= 0 ? re.y + ce.y : -1};
    const int t_eo[2] = {re.x >= 0 && co >= 0 ? re.x + co : -1,
                         re.y >= 0 && co >= 0 ? re.y + co : -1};
    const int t_oe[2] = {ro >= 0 && ce.x >= 0 ? ro + ce.x : -1,
                         ro >= 0 && ce.y >= 0 ? ro + ce.y : -1};
    const int t_oo = ro >= 0 && co >= 0 ? ro + co : -1;
    const int c0 = half * kHalf;   // the item's first channel in P
    const float* pm = P + sb * per + c0 * L::kPM;
    const int o0 = a.ct * kCoT + part * L::kPCh + c0;
    TX* out = y + ((static_cast<long long>(bb) * T.co + o0) * T.oh + r.y0 + yy) * T.ow
              + r.x0 + xx;
#pragma unroll
    for (int oh = 0; oh < kHalf; ++oh) {
      if (o0 + oh < T.co) {
        auto tap = [&](int f) {
          const float p = pm[max(f, 0) + oh * L::kPM];
          return f >= 0 ? p : 0.f;
        };
        float vee = 0.f, veo = 0.f, voe = 0.f, voo = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) vee += tap(t_ee[i]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          veo += tap(t_eo[i]);
          voe += tap(t_oe[i]);
        }
        voo += tap(t_oo);
        if (has_d) {
          const float dd = dsm[sb * kCoT + part * L::kPCh + c0 + oh];
          vee *= dd, veo *= dd, voe *= dd, voo *= dd;
        }
        TX* o = out + oh * plane;
        tf32x3::store(o, vee);
        if (x2) tf32x3::store(o + 1, veo);
        if (y2) {
          tf32x3::store(o + T.ow, voe);
          if (x2) tf32x3::store(o + T.ow + 1, voo);
        }
      }
    }
  }
}

// The outputs of part `part` of a tile: oa_emit_k3 where it applies.
template <int kK, typename TX>
__device__ __forceinline__ void oa_out(const float* P, const int2* rtab, const int2* ctab,
                                       const float* dsm, const Tiling& T, const TileAt& a,
                                       int part, bool has_d, TX* __restrict__ y) {
  if constexpr (kK == 3) {
    if (T.p == 0) {
      oa_emit_k3<TX>(P, rtab, ctab, dsm, T, a, part, has_d, y);
      return;
    }
  }
  oa_emit<kK, TX>(P, rtab, ctab, dsm, T, a, part, has_d, y);
}

// Persistent blocks: block i takes tiles i, i + gridDim.x, ...; the rings
// run on across tiles.  Each step issues stage t's wgmma group, forms stage
// t + 1's A while it runs, then waits for it; after a tile's last stage
// comes its overlap-add, while the next stages' copies are in flight.
// TX: the storage of x and y (float or __nv_bfloat16).
template <int kK, typename TX>
__global__ void __launch_bounds__(kThreads, 1)
upconv_bf16_kernel(const TX* __restrict__ x, const __nv_bfloat16* __restrict__ wimg,
                   const float* __restrict__ s, const float* __restrict__ dmod,
                   TX* __restrict__ y, const __grid_constant__ Tiling T,
                   const __grid_constant__ CUtensorMap xmap) {
  using L = Layout<kK, TX>;
  constexpr int kN = L::kN;
  constexpr int kSB = L::kBStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = wgmma::smem_addr(smem_raw);
  unsigned char* bsm = smem_raw + ((1024 - raw_addr % 1024) % 1024);   // B ring
  unsigned char* asm_ = bsm + kSB * L::kBBytes;                        // A tiles
  unsigned char* rawsm = asm_ + 2 * L::kABytes;                        // raw x ring
  float* ssm = reinterpret_cast<float*>(rawsm + kRawStages * L::kRawBytes);  // s ring
  float* P = ssm + kRawStages * L::kSFloats;
  int2* rtab = reinterpret_cast<int2*>(P + L::kTaps * L::kPCh * L::kPM);
  int2* ctab = rtab + kMaxOut;
  float* dsm = reinterpret_cast<float*>(ctab + kMaxOut);
  uint64_t* bar = reinterpret_cast<uint64_t*>(dsm + kMaxSpt * kCoT);   // B slots, then raw

  const int tid = threadIdx.x;
  const int grid = static_cast<int>(gridDim.x), blk = static_cast<int>(blockIdx.x);
  const int my_tiles = T.tiles > blk ? (T.tiles - 1 - blk) / grid + 1 : 0;
  const int steps = my_tiles * T.chunks;
  uint64_t* rbar = bar + kSB;
  if (tid == 0) {
    for (int st = 0; st < kSB + kRawStages; ++st) wgmma::mbar_init(bar + st, 1);
    wgmma::fence_barrier_init();
  }
  __syncthreads();

  const int lane = tid % 32, t = lane % 4;
  const int wg = tid / 128;
  const int m_a = 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;  // accumulator rows m_a, m_a + 8
  // the A row this thread forms in the pass, and its place in the raw slot
  const int pm = tid % kM, pj = tid / kM;
  int poff = -1, psb = 0;
  {
    const int per = T.lr * T.lc;
    const int sb = pm / per, rem = pm - sb * per;
    if (sb < T.spt) {
      psb = sb;
      if (T.hr == 0 && T.hc == 0) {
        poff = sb * T.ss + rem;
      } else {
        const int r = rem / T.lc;
        poff = r * T.rw + T.coff + rem - r * T.lc;
      }
    }
  }

  // the walks of the raw loads, the B loads and the products
  Cursor rc, bc, cc;
  rc.start(T, blk), bc.start(T, blk), cc.start(T, blk);
  int r_step = 0, b_step = 0;
  auto raw_next = [&]() {
    const int slot = r_step % kRawStages;
    load_raw<TX>(reinterpret_cast<TX*>(rawsm + slot * L::kRawBytes), ssm + slot * L::kSFloats,
                 rbar + slot, T, &xmap, x, s, rc.at, rc.chunk);
    ++r_step;
    rc.next(T, grid);
  };
  auto b_next = [&]() {
    if (tid == 0) {
      const __nv_bfloat16* src =
          wimg + (static_cast<long long>(bc.at.ct) * T.chunks + bc.chunk) * kN * kKC;
      uint64_t* b = bar + b_step % kSB;
      wgmma::mbar_expect_tx(b, L::kBBytes);
      wgmma::bulk_copy(bsm + (b_step % kSB) * L::kBBytes, src, L::kBBytes, b);
      bc.next(T, grid);
    }
    ++b_step;
  };
  // stage `step`'s A from its raw slot, once the slot has landed
  auto pass = [&](int step, int chunk) {
    const int slot = step % kRawStages;
    tf32x3::cp_async_wait<kRawStages - 1>();
    if (T.tma) wgmma::mbar_wait(rbar + slot, (step / kRawStages) & 1);
    __syncthreads();  // the stage's x and s are in
    form_a<TX>(asm_ + (step & 1) * L::kABytes,
               reinterpret_cast<const TX*>(rawsm + slot * L::kRawBytes),
               ssm + slot * L::kSFloats, T.has_s, T.cs, T.c - chunk * kKC, pm, pj, poff, psb);
    wgmma::fence_proxy_async();   // the A tile, written here, is read by wgmma
  };

#pragma unroll
  for (int st = 0; st < kRawStages; ++st) {
    if (st < steps) raw_next();
    tf32x3::cp_async_commit();
  }
#pragma unroll
  for (int st = 0; st < kSB - 1; ++st)
    if (st < steps) b_next();
  if (steps > 0) pass(0, 0);

  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  // With P whole (one part), a tile's outputs are emitted while the next
  // stage's wgmma group runs: `pending` names the tile whose P waits.
  constexpr bool kOnePart = L::kPCh == kCoT;
  bool pending = false;
  TileAt pa = {};
  for (int step = 0; step < steps; ++step) {
    const int chunk = cc.chunk;
    __syncthreads();  // stage step's A is whole; the raw slot it came from,
                      // the other A tile and the previous stage's B slot are free
    if (r_step < steps) raw_next();
    tf32x3::cp_async_commit();
    if (b_step < steps) b_next();
    wgmma::mbar_wait(bar + step % kSB, (step / kSB) & 1);
    const uint64_t da = wgmma::desc_sw128(
        wgmma::smem_addr(asm_ + (step & 1) * L::kABytes + wg * (kM / 2) * 128));
    const uint64_t db = wgmma::desc_sw128(wgmma::smem_addr(bsm + (step % kSB) * L::kBBytes));
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) wgmma::fence_operand(acc[i]);
    wgmma::fence();
#pragma unroll
    for (int j = 0; j < kKC / 16; ++j)   // k16 step j: the descriptors advance 32 bytes
      wgmma_bf16::mma<kN>(acc, da + 2 * j, db + 2 * j, chunk > 0 || j > 0);
    wgmma::commit();
    if (kOnePart && pending) {
      oa_out<kK, TX>(P, rtab, ctab, dsm, T, pa, 0, dmod != nullptr, y);
      pending = false;
    }
    if (step + 1 < steps) pass(step + 1, chunk + 1 == T.chunks ? 0 : chunk + 1);
    wgmma::wait<0>();
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) wgmma::fence_operand(acc[i]);
    if (chunk == T.chunks - 1) {
      const TileAt a = cc.at;
      __syncthreads();   // every thread is done with P, the tables and d
      oa_tables<kK, TX>(rtab, ctab, dsm, T, a, dmod);
      if (kOnePart) {    // emitted after the next step's barrier
        oa_dump<kK, TX>(acc, P, 0, m_a, t);
        pending = true;
        pa = a;
      } else {
#pragma unroll
        for (int part = 0; part < kCoT / L::kPCh; ++part) {
          if (part > 0) __syncthreads();   // every thread is done with the last part's P
          oa_dump<kK, TX>(acc, P, part, m_a, t);
          __syncthreads();
          oa_out<kK, TX>(P, rtab, ctab, dsm, T, a, part, dmod != nullptr, y);
        }
      }
    }
    cc.next(T, grid);
  }
  if (pending) {
    __syncthreads();
    oa_out<kK, TX>(P, rtab, ctab, dsm, T, pa, 0, dmod != nullptr, y);
  }
  tf32x3::cp_async_wait<0>();
}

// Launch modes 1 (x and y float32) and 2 (bf16) of ganspace_upsample_conv on
// the bf16 weight image `wimg` (ops/modconv.py::upsample_weight_image_bf16,
// [n_co][chunks][k^2 * 16][64] swizzled) with the tiling of
// upsample_tiling_bf16 (host memory, nine ints); returns cudaErrorInvalidValue
// for what the kernel does not take.  Defined in upconv2x_bf16.cu.
cudaError_t upsample_conv(const void* x, const void* wimg, const float* s, const float* dmod,
                          void* y, const int* tiling, int b, int c, int h, int w, int co, int k,
                          int p, bool bf16_storage, cudaStream_t stream);

}  // namespace upconv_bf16
