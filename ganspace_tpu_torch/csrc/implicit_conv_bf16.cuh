// Kernel B's bf16 datapath (the preview policy of ops/precision.py): the
// implicit-GEMM 3x3 correlation, stride 1, zero padding 1, NCHW, on bf16
// operands with float32 sums, x and y stored in float32 or bf16:
//
//   y[b, o, m, n] = d[b,o] * sum_{c, a < 3, e < 3}
//       bf16(wt[o, c, a, e]) * bf16(s[b,c] * x[b, c, m - 1 + a, n - 1 + e])
//
// with x read as zero outside the image.  s and d are optional (null).  It
// is the TPU kernel's bf16 case (ganspace_tpu/ops/pallas/blockconv.py:164,
// :177-180, :188; x * s rounded first, as ganspace_tpu/ops/s2d.py:242-261
// gives it), with the demodulation applied in float32 and y rounded to x's
// storage.  The 3xTF32 float32 datapath is implicit_conv.cuh.
//
// Design (what bounds it and what the design does about it): 18*C*Co
// operations per output pixel against (C + Co) activations of 2 or 4 bytes,
// bound by the bf16 tensor rate at the synthesis' 16-1024 px shapes and by
// the weight read at 4-8 px.
//   * M is output pixels, N is Co, K is 9*C: the tiling of implicit_conv.cuh
//     (kBM pixels of tr grid rows across samples x tw columns, by kBN output
//     channels; 8 warps of 32 pixels x 8*kNT channels; K split over a
//     thread-block cluster where the grid is small, reduced through
//     distributed shared memory in a fixed order), with kCK = 16 input
//     channels a stage: one m16n8k16 bf16 MMA per tap and 8-pixel n-tile,
//     twice the depth of a TF32 m16n8k8 at the same issue count;
//   * a 3-stage cp.async ring carries the raw input halo (x's storage: bf16
//     copied straight in, float32 as it is; 16 bytes a copy where the map's
//     width and alignment allow, a bf16 row's two edge columns as the aligned
//     4-byte pairs that hold them; plain loads only on odd or unaligned
//     maps), the weight slice and the stage's s;
//   * the weight arrives bf16, rounded once per layer by the wrapper
//     (ops/modconv.LayerWeights) in an [Co][3][3][Cp] layout (channels
//     innermost, Cp = C rounded up to 16 with zeros), so a stage's slice is
//     two 16-byte copies per (output channel, tap), read at half the bytes
//     of float32;
//   * after a stage lands, one pass over its halo forms bf16(x * s) once per
//     staged element (the rounding of the plain version) and writes it
//     channel-innermost, 16 channels (32 bytes) per halo pixel: the packed
//     tile.  Every element then feeds all nine taps and every n-tile with no
//     further conversion;
//   * A and B fragments come by ldmatrix.x4 from the packed tile and the
//     weight slice; both are 32-byte rows whose two 16-byte halves swap on
//     bit 2 of the row index (the XOR swizzle), so the eight rows of each
//     8x8 matrix land in eight distinct bank groups: conflict-free;
//   * sums run in two levels, each stage's products into a fresh
//     accumulator then added in float32, and the demodulation multiplies in
//     float32 in the epilogue, which rounds y to the storage.  Two launches
//     give the same bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tf32x3.cuh"

namespace implicit_conv_bf16 {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;           // 8 warps
constexpr int kStages = 3;
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kTaps = 9;
constexpr int kCK = 16;                 // input channels per stage: one k16 step per tap
constexpr int kWRow = kTaps * kCK;      // bf16 values of one output channel's slice

// The output grid of a launch, its tiling and the shared-memory layout
// (byte offsets).  A raw halo row holds columns w0 - pad .. w0 + tw + pad - 1
// of x, its interior (from index pad) aligned to the copy width.
struct Geometry {
  const __nv_bfloat16* wt;  // [co][9][cp] bf16, zero past c
  int cp;                   // the weight's channel stride
  int oh, ow;               // output grid (the tiles cover it)
  int xvec;                 // elements per copy of a halo row's interior
  int pad;                  // raw halo row: elements left of column w0
  int tw, tr;               // pixel tile: tr grid rows (across samples) x tw columns
  unsigned m_tw, m_oh, m_ohp;  // ceil(2^32 / divisor) for tw, oh and oh + 2
  int tiles_w, tiles_r;
  int hs_w;                 // raw halo row stride (tw + 2 pad)
  int pw;                   // packed halo row stride, pixels (>= tw + 2)
  int segs;                 // samples one tile touches at most
  int rows, items;          // halo rows, copies per raw halo row and channel
  unsigned m_rows, m_items, m_cols;  // ceil(2^32 / divisor): rows, items, tw + 2
  int chs;                  // raw halo elements per channel
  int raw_bytes;            // raw halo bytes of a stage
  int stage;                // bytes of one ring stage: raw halo, weight slice, s
  int packed;               // offset of the packed tile (rows * pw pixels x 32 B)
  int table;                // offset of the halo row table (rows ints)
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(smem)), "l"(gmem), "r"(ok ? 8 : 0) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a * b for one m16n8k16 tile, bf16 operands, float32 sums.  Fragments
// (g = lane / 4, t = lane % 4): a = A[g][2t..2t+1], A[g+8][2t..], A[g][2t+8..],
// A[g+8][2t+8..]; b = B[2t..2t+1][g], B[2t+8..2t+9][g]; d as m16n8k8's.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two values rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v));
}

// The byte offset of 16-byte half `half` of 32-byte row `row`: the halves
// swap on bit 2 of the row (the swizzle that keeps ldmatrix conflict-free).
__device__ __forceinline__ int swz(int row, int half) {
  return row * 32 + ((half ^ ((row >> 2) & 1)) << 4);
}

// One copy of `n` elements of a halo row's interior (zeros where !ok).
template <typename TX>
__device__ __forceinline__ void copy_interior(TX* dst, const TX* src, bool ok, int n) {
  if constexpr (std::is_same<TX, float>::value) {
    if (n == 4)
      tf32x3::cp_async16(dst, src, ok);
    else if (n == 2)
      cp_async8(dst, src, ok);
    else
      tf32x3::cp_async4(dst, src, ok);
  } else {
    if (n == 8) {
      tf32x3::cp_async16(dst, src, ok);
    } else if (n == 4) {
      cp_async8(dst, src, ok);
    } else if (n == 2) {
      tf32x3::cp_async4(dst, src, ok);
    } else {
      // a 2-byte element: below cp.async's 4 bytes, a plain load.  The
      // slot being filled is read by no thread until a later step's barrier.
      *dst = ok ? *src : __ushort_as_bfloat16(0);
    }
  }
}

// Copy one stage into the ring: the raw halo [kCK][chs], the weight slice
// [kBN][kWRow] (swizzled 32-byte rows per (output channel, tap)) and, with
// kScale, the style scales [segs][kCK].
template <int kBN, bool kScale, typename TX>
__device__ __forceinline__ void load_stage(unsigned char* st, const int* row_off, const Launch& L,
                                           const Geometry& q, const TX* __restrict__ x,
                                           const float* __restrict__ s, int c0, int b0, int w0,
                                           int o0) {
  const int tid = threadIdx.x;
  const long long plane = static_cast<long long>(L.h) * L.w;
  TX* hx = reinterpret_cast<TX*>(st);
  const TX* xc = x + static_cast<long long>(c0) * plane;
  const int inner = q.tw / q.xvec;
  // the input halo, zeros outside the image and past the last channel;
  // copy `item` of a row is an interior chunk of xvec elements or one edge
  // element, the two edge columns coming last
  for (int idx = tid; idx < kCK * q.rows * q.items; idx += kThreads) {
    const int row = fast_div(idx, q.m_items);
    const int item = idx - row * q.items;
    const int ck = fast_div(row, q.m_rows);
    const int ri = row - ck * q.rows;
    const int off = row_off[ri];  // of column w0, or -1 outside the image
    const bool row_ok = off >= 0 && c0 + ck < L.c;
    TX* dst = hx + ck * q.chs + ri * q.hs_w + q.pad;  // column w0
    const TX* src = xc + ck * plane + off;
    if (item < inner) {
      const int col = item * q.xvec;
      const bool ok = row_ok && w0 + col < L.w;
      copy_interior<TX>(dst + col, ok ? src + col : x, ok, q.xvec);
    } else if (std::is_same<TX, float>::value || q.xvec == 1) {
      const int col = item == inner ? -1 : q.tw;
      const bool ok = row_ok && w0 + col >= 0 && w0 + col < L.w;
      copy_interior<TX>(dst + col, ok ? src + col : x, ok, 1);
    } else {
      // a bf16 edge column as the aligned pair that holds it (the map's
      // width is even here): columns w0 - 2, w0 - 1 or w0 + tw, w0 + tw + 1,
      // the other one landing in the row's padding
      const int col = item == inner ? -2 : q.tw;
      const bool ok = row_ok && w0 + col >= 0 && w0 + col < L.w;
      tf32x3::cp_async4(dst + col, ok ? src + col : x, ok);
    }
  }
  // the weight slice [o0, o0 + kBN) x 9 taps x [c0, c0 + 16): two 16-byte
  // copies per (output channel, tap), zeros past co
  unsigned char* ws = st + q.raw_bytes;
  for (int idx = tid; idx < kBN * kTaps * 2; idx += kThreads) {
    const int o = idx / (kTaps * 2);
    const int r = idx - o * (kTaps * 2);   // tap * 2 + half
    const bool ok = o0 + o < L.co;
    const __nv_bfloat16* src =
        q.wt + (static_cast<long long>(o0 + o) * kTaps + (r >> 1)) * q.cp + c0 + 8 * (r & 1);
    tf32x3::cp_async16(ws + swz(o * kTaps + (r >> 1), r & 1), ok ? src : q.wt, ok);
  }
  // the style scales of the stage's channels for the tile's samples
  if constexpr (kScale) {
    float* ss = reinterpret_cast<float*>(ws + kBN * kWRow * 2);
    for (int idx = tid; idx < q.segs * kCK; idx += kThreads) {
      const int sb = idx / kCK, ck = idx % kCK;
      const bool ok = b0 + sb < L.b && c0 + ck < L.c;
      tf32x3::cp_async4(ss + idx, ok ? s + static_cast<long long>(b0 + sb) * L.c + c0 + ck : s,
                        ok);
    }
  }
}

// The landed stage's halo as the packed tile: for each halo pixel (halo row
// ri, column col of w0 - 1 .. w0 + tw) and each 8-channel half, bf16(x * s)
// (bf16(x) without s; a bf16 x without s moves as it is), four channel
// pairs in one 16-byte store.
template <int kBN, bool kScale, typename TX>
__device__ __forceinline__ void pack_stage(const unsigned char* st, unsigned char* pk,
                                           const Geometry& q, int r0) {
  const TX* hx = reinterpret_cast<const TX*>(st);
  const float* ss = reinterpret_cast<const float*>(st + q.raw_bytes + kBN * kWRow * 2);
  const int cols = q.tw + 2;
  const int pixels = q.rows * cols;
  for (int idx = threadIdx.x; idx < 2 * pixels; idx += kThreads) {
    const int half = idx >= pixels ? 1 : 0;
    const int p = idx - half * pixels;
    const int ri = fast_div(p, q.m_cols);
    const int col = p - ri * cols;
    const TX* src = hx + 8 * half * q.chs + ri * q.hs_w + q.pad - 1 + col;
    uint32_t v[4];
    if constexpr (kScale) {
      const float* sc = ss + fast_div(ri + r0, q.m_ohp) * kCK + 8 * half;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = pack_rn(tf32x3::widen(src[2 * j * q.chs]) * sc[2 * j],
                       tf32x3::widen(src[(2 * j + 1) * q.chs]) * sc[2 * j + 1]);
    } else if constexpr (std::is_same<TX, float>::value) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = pack_rn(src[2 * j * q.chs], src[(2 * j + 1) * q.chs]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = bits(src[2 * j * q.chs]) | (bits(src[(2 * j + 1) * q.chs]) << 16);
    }
    *reinterpret_cast<uint4*>(pk + swz(ri * q.pw + col, half)) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// kWN warps across the output channels, each warp 32 pixels x 8 * kNT
// channels (kNT even: one B ldmatrix.x4 feeds two n-tiles): a block is
// (256 / kWN) pixels x (8 * kNT * kWN) channels.  kScale: s is given.  TX:
// the storage of x and y (float, or __nv_bfloat16).
template <int kWN, int kNT, bool kScale, typename TX>
__global__ void __launch_bounds__(kThreads, 2)
conv_bf16_kernel(const TX* __restrict__ x, const float* __restrict__ s,
                 const float* __restrict__ dmod, TX* __restrict__ y,
                 const __grid_constant__ Launch L) {
  static_assert(kNT % 2 == 0, "B fragments come two n-tiles at a time");
  constexpr int kBN = 8 * kNT * kWN;
  constexpr int kBM = 256 / kWN;
  constexpr int kPStride = kBM + 4;  // partial tile row stride
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());

  // This block's tile: blockIdx.x = (m_tile * n_tiles + n_tile) * ks + rank.
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
  // row lies outside the image: halo row ri is row (ri + r0) mod (oh + 2) - 1
  // of sample b0 + (ri + r0) / (oh + 2).
  int* row_off = reinterpret_cast<int*>(smem + q.table);
  {
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

  // A: this lane's row of each 16-pixel m-tile (pixel wm + mt*16 + lane % 16,
  // tile row i of its k-th sample, column col: packed pixel (i + 2k) * pw +
  // col at tap (0, 0)) and its 16-byte half (channels 8 * (lane / 16) ..).
  // Pixels past the tile's tr rows read row 0 and are not stored.
  int apix[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int m = wm + mt * 16 + lane % 16;
    int i = fast_div(m, q.m_tw);
    const int col = m - i * q.tw;
    i = i < q.tr ? i : 0;
    const int k = fast_div(r0 + i, q.m_oh);
    apix[mt] = (i + 2 * k) * q.pw + col;
  }
  const int ahalf = lane / 16;
  // B: this lane's output channel of each 16-channel pair of n-tiles and its
  // half (ldmatrix.x4: b0, b1 of n-tile 2np, then of n-tile 2np + 1)
  const int bo = wn + (lane / 16) * 8 + lane % 8;
  const int bhalf = (lane / 8) % 2;

  float acc[kNT][2][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][mt][e] = 0.f;

  unsigned char* pk = smem + q.packed;
  const uint32_t pk_addr = smem_addr(pk);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps)
      load_stage<kBN, kScale, TX>(smem + st * q.stage, row_off, L, q, x, s,
                                  (chunk_beg + st) * kCK, b0, w0, o0);
    tf32x3::cp_async_commit();
  }

  for (int step = 0; step < steps; ++step) {
    tf32x3::cp_async_wait<kStages - 2>();
    __syncthreads();  // the stage has landed; every warp is past the last step's products
    const int next = step + kStages - 1;
    if (next < steps)
      load_stage<kBN, kScale, TX>(smem + (next % kStages) * q.stage, row_off, L, q, x, s,
                                  (chunk_beg + next) * kCK, b0, w0, o0);
    tf32x3::cp_async_commit();

    const unsigned char* slot = smem + (step % kStages) * q.stage;
    pack_stage<kBN, kScale, TX>(slot, pk, q, r0);
    __syncthreads();

    const uint32_t w_addr = smem_addr(slot + q.raw_bytes);
    float part[kNT][2][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nt][mt][e] = 0.f;
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], pk_addr + swz(apix[mt] + u * q.pw + v, ahalf));
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, w_addr + swz((bo + 16 * np) * kTaps + u * 3 + v, bhalf));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(part[2 * np][mt], a[mt], b[0], b[1]);
            mma_bf16(part[2 * np + 1][mt], a[mt], b[2], b[3]);
          }
        }
      }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][mt][e] += part[nt][mt][e];
  }
  tf32x3::cp_async_wait<0>();
  __syncthreads();

  // Partial tile [channel][pixel] into shared memory, then the cluster sum.
  float* tile = reinterpret_cast<float*>(smem);
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
      tf32x3::store(y + (static_cast<long long>(bb) * L.co + o) * yplane
                    + static_cast<long long>(hh) * L.w + ww, val);
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

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The tile's width: an odd grid under 64 columns whole, else a power of two
// up to 32.
inline int tile_width(int ow) {
  return (ow < 64 && !is_pow2(ow)) ? ow : 1 << (log2_ceil(ow) < 5 ? log2_ceil(ow) : 5);
}

// The shared memory (bytes) of a tile of tr rows: the ring, the packed tile,
// then the halo row table (the partial tile reuses the ring).
template <int kBN, bool kScale, typename TX>
long long tile_bytes(Geometry& q) {
  q.m_tw = div_magic(q.tw);
  q.m_oh = div_magic(q.oh);
  q.m_ohp = div_magic(q.oh + 2);
  // a tile starts at a multiple of gcd(tr, oh) within its sample
  const int g = gcd(q.tr, q.oh);
  q.segs = (q.oh - g + q.tr - 1) / q.oh + 1;
  q.rows = q.tr + 2 * q.segs;
  q.hs_w = q.tw + 2 * q.pad;
  q.items = q.tw / q.xvec + 2;
  q.m_rows = div_magic(q.rows);
  q.m_items = div_magic(q.items);
  q.m_cols = div_magic(q.tw + 2);
  // 4-pixel rows take a packed stride of 12 (4 mod 8): the two rows of an
  // 8-pixel ldmatrix then fall in distinct bank groups
  q.pw = q.tw == 4 ? 12 : q.tw + 2;
  q.chs = round_up(q.rows * q.hs_w, 8);
  q.raw_bytes = kCK * q.chs * static_cast<int>(sizeof(TX));
  q.stage = q.raw_bytes + kBN * kWRow * 2 + (kScale ? round_up(q.segs * kCK * 4, 16) : 0);
  q.packed = kStages * q.stage;
  q.table = q.packed + q.rows * q.pw * 32;
  return static_cast<long long>(q.table) + 4LL * q.rows;
}

// The tiling of the grid (its width q.tw set): the bytes of shared memory
// it needs, or -1 when it cannot fit.  Rows: as many as fill kBM pixels,
// counted across samples, fewer while the ring does not fit.
template <int kBN, int kBM, bool kScale, typename TX>
long long tile_grid(Geometry& q, int batch) {
  q.tr = kBM / q.tw;
  long long bytes = tile_bytes<kBN, kScale, TX>(q);
  while (bytes > kMaxSmem && q.tr > 1) {
    q.tr = (q.tr + 1) / 2;
    bytes = tile_bytes<kBN, kScale, TX>(q);
  }
  q.tiles_w = (q.ow + q.tw - 1) / q.tw;
  q.tiles_r = static_cast<int>((static_cast<long long>(batch) * q.oh + q.tr - 1) / q.tr);
  return bytes <= kMaxSmem ? bytes : -1;
}

// The widest interior copy of x's rows: xvec elements of TX dividing the
// tile's and the map's width, x aligned to its bytes (1 when none does).
template <typename TX>
void choose_copies(Geometry& q, const void* x, int w) {
  const int widths[3] = {16 / static_cast<int>(sizeof(TX)), 8 / static_cast<int>(sizeof(TX)),
                         4 / static_cast<int>(sizeof(TX))};
  q.xvec = 1;
  for (int n : widths)
    if (n > 1 && q.tw % n == 0 && w % n == 0
        && reinterpret_cast<uintptr_t>(x) % (n * sizeof(TX)) == 0) {
      q.xvec = n;
      break;
    }
  q.pad = q.xvec;
}

template <int kWN, int kNT, bool kScale, typename TX>
cudaError_t launch(const TX* x, const float* s, const float* dmod, TX* y, Launch L,
                   cudaStream_t stream) {
  constexpr int kBN = 8 * kNT * kWN;
  constexpr int kBM = 256 / kWN;
  auto kernel = conv_bf16_kernel<kWN, kNT, kScale, TX>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);

  L.n_tiles = (L.co + kBN - 1) / kBN;
  L.chunks = (L.c + kCK - 1) / kCK;  // stages
  // the tile's width first (it decides the copies), then the tiling
  Geometry& q = L.g;
  q.tw = tile_width(q.ow);
  choose_copies<TX>(q, x, L.w);
  const long long bytes = tile_grid<kBN, kBM, kScale, TX>(q, L.b);
  if (bytes < 0) return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(q.tiles_r) * q.tiles_w * L.n_tiles;
  // Split K over a cluster until the grid holds about four blocks per SM,
  // each rank keeping at least one stage.
  L.ks = 1;
  while (L.ks < kMaxCluster && blocks * L.ks < 4LL * sms && 2 * L.ks <= L.chunks) L.ks *= 2;
  L.chunks_per_rank = (L.chunks + L.ks - 1) / L.ks;
  if (blocks * L.ks >= (1LL << 31) || 4LL * kBN * (kBM + 4) > q.table)
    return cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks * L.ks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
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

// The warp layout for co output channels, as implicit_conv.cuh's: 64-channel
// blocks from 33 channels, 32-channel blocks from 17, 16-channel blocks
// below.  s null takes the plain kernel.
template <typename TX>
cudaError_t launch_for(const TX* x, const float* s, const float* dmod, TX* y, const Launch& L,
                       cudaStream_t stream) {
  if (s) {
    if (L.co <= 16) return launch<1, 2, true, TX>(x, s, dmod, y, L, stream);
    if (L.co <= 32) return launch<1, 4, true, TX>(x, s, dmod, y, L, stream);
    return launch<2, 4, true, TX>(x, s, dmod, y, L, stream);
  }
  if (L.co <= 16) return launch<1, 2, false, TX>(x, s, dmod, y, L, stream);
  if (L.co <= 32) return launch<1, 4, false, TX>(x, s, dmod, y, L, stream);
  return launch<2, 4, false, TX>(x, s, dmod, y, L, stream);
}

}  // namespace implicit_conv_bf16
