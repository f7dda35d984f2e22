// One block of the Nystrom sketch (estimators/ipca.py::nystrom_update) for
// x [n, D] and Omega [D, l], float32:
//
//   P = x Omega [n, l]                       (kernel 1, K = D)
//   y' = y + x^T P [D, l],  s' = s + sum_rows x   (kernel 2, K = n)
//   sq' = sq + sum x^2                        (kernel 1's units, summed by
//                                              the image kernel between)
//
// Replaces no TPU kernel: the JAX package leaves these two products to XLA
// at Precision.HIGHEST (ganspace_tpu/estimators/ipca.py, the sketch tier's
// block update).  Added because the stock float32 products run on FFMA,
// which cannot pass 67 / 165 = 41% of the 3xTF32 bound below.
//
// What bounds it: 4 n D l FLOP in 3xTF32 against x read (twice, once per
// product), Omega read and y read and written.  At the gen_z block (n =
// 10000, D = 32768, l = 320) the operations: 419 GFLOP, 2.54 ms at 165
// TFLOP/s; at the conv taps' block (n = 128, D = 131072, l = 320) the bytes:
// 0.17 ms.  One algorithm for both; the wrapper (ops/sketch.py::tiling)
// sizes kernel 1's split of K from (n, D, l) and the SM count alone.
// The design (a unit = 128 rows x kN columns, two warpgroups of 64 rows):
//   * wgmma on sm_90a (wgmma_tf32.cuh), three products per k8 step (lo*hi,
//     hi*lo, hi*hi; a stage's small ones first).  B arrives split into TF32 hi and lo, in the K-major
//     128-byte-swizzled [kN][32] tiles wgmma reads, through two TMA bulk
//     copies per stage: kernel 1's B is Omega^T, whose image the wrapper
//     makes once per Omega (ops/sketch.py::omega_image); kernel 2's B is
//     P^T, written between the two; image_kernel makes both.  A is x,
//     staged by cp.async and split in registers: row-major for kernel 1
//     (K = D contiguous), read transposed for kernel 2 (x^T: K = n
//     strided), which tf32 wgmma could not take from shared memory;
//   * sums in two levels: each 32-deep stage's twelve products start a
//     fresh accumulator, added to the total in float32 (the tensor core's
//     own accumulation truncates);
//   * kernel 1 splits K = D into `splits` ranges where the (n, l) tiles are
//     too few for the card's SMs (one row tile at n = 128); each range
//     writes its own partial tile, and the image kernel adds them in the
//     order 0 .. splits-1 while it splits P into its image: no float
//     atomics;
//   * kernel 2's units own a D tile for all of n, so y' is written once,
//     new (the out-of-place update the factor memo keys on), from the old
//     y in the epilogue, its tile sent toward L2 when the unit starts;
//   * the sums of x ride the product passes on the values already in
//     registers: sum x^2 in kernel 1's column-tile-0 units (per unit, then
//     in unit order by the image kernel), the column sums in kernel 2's
//     (lanes combined in a fixed order).  Each stage's values are summed fresh and
//     the stages' sums added with Kahan's compensation, as are the units':
//     the mean and the energy are differences of large sums later (the
//     centering in sketch_grams), so a sequential float32 sum over n would
//     not do.  No x-sized temporary;
//   * persistent blocks, one per SM, over a 3-stage ring that runs on from
//     one unit to the next, so a unit's first stages load while the last
//     one's products and epilogue run.
// Every sum has a fixed order, so two launches give the same bits.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"
#include "wgmma_tf32.cuh"

namespace sketch {

constexpr int kThreads = 256;   // two warpgroups of 64 rows each
constexpr int kM = 128;         // rows of a unit
constexpr int kKC = 32;         // K per stage (four k8 steps)
constexpr int kStages = 3;
constexpr int kN = 160;         // columns of a unit: l = 320 (c = 80) is two tiles
constexpr int kMaxSmem = 227 * 1024;

// One product's geometry: the wrapper's tiling (ops/sketch.py::tiling).
struct Geo {
  int n, d, l;       // x [n, d], Omega [d, l]
  int n_nt;          // column tiles of kN over l
  int chunks;        // 32-deep K stages of the product
  int per_split;     // stages of one unit
  int n_mt;          // row tiles of kM (kernel 1: over n; kernel 2: over d)
  int units;         // n_nt * n_mt * splits, column tile fastest
  int vec;           // 16-byte x copies (d % 4 == 0, x 16-byte aligned)
};

struct Unit {
  int nt, mt, ks, c0, c1;
};

// sum += v with Kahan's compensation: -comp is what sum is short of.
// (No product here, so nothing contracts into an FMA.)
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float v) {
  const float y = v - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// Column tile fastest, then row tile, then K range: the units running at
// one time share a K range, so its B tiles stay in L2.
__device__ __forceinline__ Unit unit_at(const Geo& G, int u) {
  Unit U;
  U.nt = u % G.n_nt;
  const int r = u / G.n_nt;
  U.mt = r % G.n_mt;
  U.ks = r / G.n_mt;
  U.c0 = U.ks * G.per_split;
  U.c1 = min(U.c0 + G.per_split, G.chunks);
  return U;
}

// One ring slot (floats): B's hi and lo tiles [kN][32], 1024-byte aligned
// for the swizzle, then the x tile: [kM][kKC + 4] for kernel 1 (stride = 4
// mod 32), [kKC][kM + 8] for kernel 2 (= 8 mod 32): either way the fragment
// reads of a warp fall in 32 different banks.
template <bool kT>
struct Slot {
  static constexpr int kBTile = kN * kKC;
  static constexpr int kAS = kT ? kM + 8 : kKC + 4;
  static constexpr int kA = 2 * kBTile;
  static constexpr int kFloats = (kA + (kT ? kKC : kM) * kAS + 255) / 256 * 256;
  static constexpr int kBytes = kStages * kFloats * 4 + 1024 + 8 * kStages + 8 * 4;
};

// Copy stage `c` of unit `U` into `slot`: the B tile pair (TMA, on the
// slot's mbarrier) and x's tile (cp.async; rows past n and columns past d
// are zeros).
template <bool kT>
__device__ __forceinline__ void load_stage(float* slot, uint64_t* bar, const Geo& G,
                                           const float* __restrict__ x,
                                           const float* __restrict__ bimg, const Unit& U,
                                           int c) {
  using S = Slot<kT>;
  const int tid = threadIdx.x;
  if (tid == 0) {
    const float* src = bimg + (static_cast<long long>(U.nt) * G.chunks + c) * 2 * S::kBTile;
    wgmma::mbar_expect_tx(bar, 2 * S::kBTile * 4);
    wgmma::bulk_copy(slot, src, S::kBTile * 4, bar);
    wgmma::bulk_copy(slot + S::kBTile, src + S::kBTile, S::kBTile * 4, bar);
  }
  float* as = slot + S::kA;
  const int k0 = c * kKC;
  if constexpr (!kT) {  // x rows U.mt * kM + m, columns k0 + k: As[m][k]
    const int row0 = U.mt * kM;
    if (G.vec) {        // piece tid % 8 (four columns) of rows tid / 8 + 32 r
      const int p = tid % 8;
#pragma unroll
      for (int r = 0; r < kM * kKC / 4 / kThreads; ++r) {
        const int m = tid / 8 + 32 * r, row = row0 + m, col = k0 + 4 * p;
        const bool ok = row < G.n && col < G.d;
        tf32x3::cp_async16(as + m * S::kAS + 4 * p,
                           ok ? x + static_cast<long long>(row) * G.d + col : x, ok);
      }
    } else {            // column tid % 32 of rows tid / 32 + 8 r
      const int k = tid % 32;
#pragma unroll 4
      for (int r = 0; r < kM * kKC / kThreads; ++r) {
        const int m = tid / 32 + 8 * r, row = row0 + m, col = k0 + k;
        const bool ok = row < G.n && col < G.d;
        tf32x3::cp_async4(as + m * S::kAS + k,
                          ok ? x + static_cast<long long>(row) * G.d + col : x, ok);
      }
    }
  } else {              // x rows k0 + k, columns U.mt * kM + m: As[k][m] = x^T[m][k]
    const int col0 = U.mt * kM;
    if (G.vec) {        // piece tid % 32 (four columns) of rows tid / 32 + 8 r
      const int p = tid % 32;
#pragma unroll
      for (int r = 0; r < kM * kKC / 4 / kThreads; ++r) {
        const int k = tid / 32 + 8 * r, row = k0 + k, col = col0 + 4 * p;
        const bool ok = row < G.n && col < G.d;
        tf32x3::cp_async16(as + k * S::kAS + 4 * p,
                           ok ? x + static_cast<long long>(row) * G.d + col : x, ok);
      }
    } else {            // column tid % 128 of rows tid / 128 + 2 r
      const int m = tid % kM;
#pragma unroll 4
      for (int r = 0; r < kM * kKC / kThreads; ++r) {
        const int k = tid / kM + 2 * r, row = k0 + k, col = col0 + m;
        const bool ok = row < G.n && col < G.d;
        tf32x3::cp_async4(as + k * S::kAS + m,
                          ok ? x + static_cast<long long>(row) * G.d + col : x, ok);
      }
    }
  }
}

// kT = false, kernel 1: out = the partial tiles [splits][n_mt * kM][n_nt *
// kN] of P, sqpart[ks * n_mt + mt] = the unit's sum of x^2 (column tile 0).
// kT = true, kernel 2: out = y' [d, l] = yin + x^T P, s_out = s_in + the
// column sums (column tile 0).  Block i takes units i, i + gridDim.x, ...
template <bool kT>
__global__ void __launch_bounds__(kThreads, 1)
product_kernel(const float* __restrict__ x, const float* __restrict__ bimg,
               const float* __restrict__ yin, float* __restrict__ out,
               const float* __restrict__ s_in, float* __restrict__ s_out,
               float* __restrict__ sqpart, const __grid_constant__ Geo G) {
  using S = Slot<kT>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzled B tiles need 1024-byte alignment
  const uint32_t raw = wgmma::smem_addr(smem_raw);
  float* ring = reinterpret_cast<float*>(smem_raw + ((1024 - raw % 1024) % 1024));
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + kStages * S::kFloats);
  float* red = reinterpret_cast<float*>(bar + kStages);   // one float a warp

  const int tid = threadIdx.x, blk = blockIdx.x, nblk = gridDim.x;
  const int my_units = G.units > blk ? (G.units - 1 - blk) / nblk + 1 : 0;
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) wgmma::mbar_init(bar + st, 1);
    wgmma::fence_barrier_init();
  }
  __syncthreads();

  const int lane = tid % 32, g = lane / 4, t = lane % 4, warp = tid / 32;
  const int m_a = 64 * (tid / 128) + 16 * ((tid % 128) / 32) + g;  // fragment rows m_a, m_a + 8
  const int m_b = m_a + 8;

  // The loads run kStages - 1 stages ahead, in the consumers' order: unit
  // by unit, stage by stage (every unit has at least one stage).
  int p_ti = 0, p_c = 0, p_step = 0;
  Unit pu = {};
  if (my_units > 0) {
    pu = unit_at(G, blk);
    p_c = pu.c0;
  }
  auto produce = [&]() {
    if (p_ti < my_units && p_c >= pu.c1 && ++p_ti < my_units) {
      pu = unit_at(G, blk + p_ti * nblk);
      p_c = pu.c0;
    }
    if (p_ti < my_units) {
      load_stage<kT>(ring + (p_step % kStages) * S::kFloats, bar + p_step % kStages, G, x,
                         bimg, pu, p_c);
      ++p_c;
      ++p_step;
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    produce();
    tf32x3::cp_async_commit();
  }

  float total[kN / 2], part[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) part[i] = 0.f;
  int step = 0;
  for (int ti = 0; ti < my_units; ++ti) {
    const Unit U = unit_at(G, blk + ti * nblk);
    const bool sums = U.nt == 0;   // this unit also sums x
    if constexpr (kT) {  // the old y tile, read by the epilogue: toward L2 now
      constexpr int kLines = kN / 32 + 2;   // 128-byte lines of a tile row, at most
      const int c0 = U.nt * kN, c1 = min(c0 + kN, G.l);
      for (int i = tid; i < kM * kLines; i += kThreads) {
        const int row = U.mt * kM + i / kLines;
        const long long first = static_cast<long long>(row) * G.l + c0;
        const long long line = (first * 4 / 128 + i % kLines) * 128;
        if (row < G.d && line < (static_cast<long long>(row) * G.l + c1) * 4)
          prefetch_l2(reinterpret_cast<const char*>(yin) + line);
      }
    }
    // the sums of x: each stage's values summed fresh, the stages' sums
    // added with compensation (rows m_a and m_b of x^T in kernel 2; x^2 in
    // kernel 1, in acc_a)
    float acc_a = 0.f, acc_b = 0.f, comp_a = 0.f, comp_b = 0.f;
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) total[i] = 0.f;
    for (int c = U.c0; c < U.c1; ++c, ++step) {
      const float* slot = ring + (step % kStages) * S::kFloats;
      tf32x3::cp_async_wait<kStages - 2>();
      wgmma::mbar_wait(bar + step % kStages, (step / kStages) & 1);
      __syncthreads();  // the stage is in; every warpgroup is done with the slot refilled next
      produce();
      tf32x3::cp_async_commit();

      // A: x (kernel 1) or x^T (kernel 2) at rows m_a, m_b, split in registers
      const float* as = slot + S::kA;
      uint32_t a_hi[4][4], a_lo[4][4];
      float stage_a = 0.f, stage_b = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 8 * j + t + 4 * (e / 2), m = e % 2 ? m_b : m_a;
          const float v = kT ? as[k * S::kAS + m] : as[m * S::kAS + k];
          if constexpr (kT) {
            if (e % 2) stage_b += v;
            else stage_a += v;
          } else {
            stage_a = fmaf(v, v, stage_a);
          }
          tf32x3::split(v, a_hi[j][e], a_lo[j][e]);
        }
      const uint64_t d_hi = wgmma::desc_sw128(wgmma::smem_addr(slot));
      const uint64_t d_lo = wgmma::desc_sw128(wgmma::smem_addr(slot + S::kBTile));
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) wgmma::fence_operand(part[i]);
      wgmma::fence();
      // k8 step j at descriptor + 2j (32 bytes); the eight small products
      // first, the four large ones last: the tensor core truncates each sum
      // to the accumulator's exponent, so a small term added to a large
      // partial loses its low bits, always toward zero
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma::mma<kN>(part, a_lo[j], d_hi + 2 * j, j > 0);
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma::mma<kN>(part, a_hi[j], d_lo + 2 * j, 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma::mma<kN>(part, a_hi[j], d_hi + 2 * j, 1);
      wgmma::commit();
      if (sums) {   // while the products run
        kahan_add(acc_a, comp_a, stage_a);
        if constexpr (kT) kahan_add(acc_b, comp_b, stage_b);
      }
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

    // total[4q + e] = D[m_a + 8 (e / 2)][8q + 2t + e % 2] of the unit's tile
    if constexpr (!kT) {
      const long long lp = static_cast<long long>(G.n_nt) * kN;
      float* base = out + (static_cast<long long>(U.ks) * G.n_mt + U.mt) * kM * lp + U.nt * kN;
#pragma unroll
      for (int q = 0; q < kN / 8; ++q) {
        const int col = 8 * q + 2 * t;
        *reinterpret_cast<float2*>(base + m_a * lp + col) = make_float2(total[4 * q], total[4 * q + 1]);
        *reinterpret_cast<float2*>(base + m_b * lp + col) =
            make_float2(total[4 * q + 2], total[4 * q + 3]);
      }
      if (sums) {   // the unit's sum of x^2: lanes, then warps, in a fixed order
        acc_a -= comp_a;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc_a += __shfl_xor_sync(0xffffffffu, acc_a, o);
        if (lane == 0) red[warp] = acc_a;
        __syncthreads();
        if (tid == 0) {
          float s = 0.f;
          for (int w = 0; w < kThreads / 32; ++w) s += red[w];
          sqpart[U.ks * G.n_mt + U.mt] = s;
        }
        __syncthreads();
      }
    } else {
      // y' = y + total: the old y into part (free until the next stage),
      // every load issued before the first store
      const int ra = U.mt * kM + m_a, rb = ra + 8;
      const bool ok_a = ra < G.d, ok_b = rb < G.d;
      const long long oa = static_cast<long long>(ra) * G.l, ob = static_cast<long long>(rb) * G.l;
      if (G.l % 2 == 0) {   // column pairs 8q + 2t, + 1: 8-byte words
#pragma unroll
        for (int q = 0; q < kN / 8; ++q) {
          const int col = U.nt * kN + 8 * q + 2 * t;
          const float2 va = col < G.l && ok_a ? *reinterpret_cast<const float2*>(yin + oa + col)
                                              : make_float2(0.f, 0.f);
          const float2 vb = col < G.l && ok_b ? *reinterpret_cast<const float2*>(yin + ob + col)
                                              : make_float2(0.f, 0.f);
          part[4 * q] = va.x, part[4 * q + 1] = va.y, part[4 * q + 2] = vb.x, part[4 * q + 3] = vb.y;
        }
#pragma unroll
        for (int q = 0; q < kN / 8; ++q) {
          const int col = U.nt * kN + 8 * q + 2 * t;
          if (col < G.l && ok_a)
            *reinterpret_cast<float2*>(out + oa + col) =
                make_float2(part[4 * q] + total[4 * q], part[4 * q + 1] + total[4 * q + 1]);
          if (col < G.l && ok_b)
            *reinterpret_cast<float2*>(out + ob + col) =
                make_float2(part[4 * q + 2] + total[4 * q + 2], part[4 * q + 3] + total[4 * q + 3]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < kN / 8; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = U.nt * kN + 8 * q + 2 * t + h;
            part[4 * q + h] = col < G.l && ok_a ? yin[oa + col] : 0.f;
            part[4 * q + 2 + h] = col < G.l && ok_b ? yin[ob + col] : 0.f;
          }
#pragma unroll
        for (int q = 0; q < kN / 8; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = U.nt * kN + 8 * q + 2 * t + h;
            if (col < G.l && ok_a) out[oa + col] = part[4 * q + h] + total[4 * q + h];
            if (col < G.l && ok_b) out[ob + col] = part[4 * q + 2 + h] + total[4 * q + 2 + h];
          }
      }
      if (sums) {   // column sums of rows m_a, m_b: the four lanes t, in a fixed order
        acc_a -= comp_a;
        acc_b -= comp_b;
        acc_a += __shfl_xor_sync(0xffffffffu, acc_a, 1);
        acc_b += __shfl_xor_sync(0xffffffffu, acc_b, 1);
        acc_a += __shfl_xor_sync(0xffffffffu, acc_a, 2);
        acc_b += __shfl_xor_sync(0xffffffffu, acc_b, 2);
        if (t == 0) {
          if (ok_a) s_out[ra] = s_in[ra] + acc_a;
          if (ok_b) s_out[rb] = s_in[rb] + acc_b;
        }
      }
    }
  }
  tf32x3::cp_async_wait<0>();
}

// A B operand's image: src [rows][cols] (row stride ld), summed over
// `splits` copies `split_stride` floats apart in the order 0 .. splits-1,
// split into TF32 hi and lo and written as the K-major tiles the products
// read, [n_nt][ceil(rows / 32)][hi, lo][kN][32] (src^T: a tile row is a
// column of src, K its rows, 128-byte swizzled; rows past `rows` and
// columns past `cols` zero).  Between the products it makes P's image from
// kernel 1's partial tiles, and with sqpart set block (0, 0) also finishes
// sq' = sq + the units' sums of x^2 in unit order; alone, Omega's image.  A
// block takes 8 rows x 32 columns through shared memory: src is read along
// its rows, the image written along its K.
__global__ void __launch_bounds__(256)
image_kernel(const float* __restrict__ src, float* __restrict__ img, int rows, int cols,
             long long ld, int splits, long long split_stride, int n_nt,
             const float* __restrict__ sqpart, const float* __restrict__ sq_in,
             float* __restrict__ sq_out, int n_sq) {
  __shared__ float tile[8][33];
  const int i0 = blockIdx.x * 8, j0 = blockIdx.y * 32;
  {
    const int i = i0 + threadIdx.x / 32, j = j0 + threadIdx.x % 32;
    float v = 0.f;
    if (i < rows && j < cols) {
      const float* p = src + i * ld + j;
#pragma unroll 8
      for (int s = 0; s < splits; ++s) v += p[s * split_stride];
    }
    tile[threadIdx.x / 32][threadIdx.x % 32] = v;
  }
  __syncthreads();
  {
    const int kk = threadIdx.x % 8, jj = threadIdx.x / 8;
    const int i = i0 + kk, j = j0 + jj;
    if (j < n_nt * kN) {
      const int nt = j / kN, r = j % kN, k = i % kKC;
      uint32_t hi, lo;
      tf32x3::split(tile[kk][jj], hi, lo);
      constexpr long long tile_f = kN * kKC;
      const long long base = (static_cast<long long>(nt) * gridDim.x / 4 + i / kKC) * 2 * tile_f;
      const int off = r * kKC + ((k / 4) ^ (r % 8)) * 4 + k % 4;
      img[base + off] = __uint_as_float(hi);
      img[base + tile_f + off] = __uint_as_float(lo);
    }
  }
  if (sqpart && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    float s = 0.f, comp = 0.f;
    for (int u = 0; u < n_sq; ++u) kahan_add(s, comp, sqpart[u]);
    sq_out[0] = sq_in[0] + (s - comp);
  }
}

// The image_kernel launch: one block per 8 rows (four per 32-deep stage)
// and 32 columns of the image.
cudaError_t launch_image(const float* src, float* img, int rows, int cols, long long ld,
                         int splits, long long split_stride, const float* sqpart,
                         const float* sq_in, float* sq_out, int n_sq, cudaStream_t stream) {
  const int n_nt = (cols + kN - 1) / kN;
  const long long stages = (rows + kKC - 1) / kKC;
  image_kernel<<<dim3(static_cast<unsigned>(stages * kKC / 8), n_nt * kN / 32), 256, 0,
                 stream>>>(src, img, rows, cols, ld, splits, split_stride, n_nt, sqpart,
                           sq_in, sq_out, n_sq);
  return cudaGetLastError();
}

template <bool kT>
cudaError_t launch_product(const float* x, const float* bimg, const float* yin, float* out,
                           const float* s_in, float* s_out, float* sqpart, const Geo& G,
                           int sms, cudaStream_t stream) {
  constexpr int kBytes = Slot<kT>::kBytes;
  static_assert(kBytes <= kMaxSmem, "the ring does not fit in shared memory");
  auto kernel = product_kernel<kT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return attr;
  const int blocks = G.units < sms ? G.units : sms;  // one block per SM
  kernel<<<blocks, kThreads, kBytes, stream>>>(x, bimg, yin, out, s_in, s_out, sqpart, G);
  return cudaGetLastError();
}

cudaError_t update(const float* x, const float* oimg, const float* y, const float* s,
                   const float* sq, float* y_out, float* s_out, float* sq_out, float* part,
                   float* pimg, float* sqpart, const Geo& G1, const Geo& G2,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = launch_product<false>(x, oimg, nullptr, part, nullptr, nullptr, sqpart,
                                              G1, sms, stream);
  if (err != cudaSuccess) return err;
  const long long lp = static_cast<long long>(G1.n_nt) * kN;
  const int splits = G1.units / (G1.n_nt * G1.n_mt);
  err = launch_image(part, pimg, G1.n, G1.l, lp, splits, lp * G1.n_mt * kM, sqpart, sq, sq_out,
                     G1.n_mt * splits, stream);
  if (err != cudaSuccess) return err;
  return launch_product<true>(x, pimg, y, y_out, s, s_out, nullptr, G2, sms, stream);
}

}  // namespace sketch

// Omega's image for kernel 1 (ops/sketch.py::omega_image): omega [d, l]
// float32, contiguous; img [ceil(l / 160)][ceil(d / 32)][hi, lo][160 * 32].
extern "C" int ganspace_sketch_omega_image(const float* omega, float* img, int d, int l,
                                           void* stream) {
  if (d < 1 || l < 1 || reinterpret_cast<uintptr_t>(img) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sketch::launch_image(omega, img, d, l, l, 1, 0, nullptr, nullptr,
                                               nullptr, 0, static_cast<cudaStream_t>(stream)));
}

// x [n, d], y and y_out [d, l] (8-byte aligned: the epilogue moves column
// pairs), s and s_out [d], sq and sq_out [] (float32, contiguous); oimg Omega's image (ops/sketch.py::omega_image, [n_nt][ceil(d
// / 32)][hi, lo][kn * 32]); scratch: part [splits][ceil(n / 128) * 128][n_nt
// * kn], pimg [n_nt][ceil(n / 32)][2][kn * 32], sqpart [ceil(n / 128) *
// splits]; kn = 160 (the wrapper's column tile, checked), n_nt = ceil(l /
// kn), and each of the `splits` K ranges of ceil(ceil(d / 32) / splits)
// stages non-empty (ops/sketch.py::tiling).  Launches the two products and
// the image kernel between them on `stream`; returns cudaGetLastError() as
// an int.
extern "C" int ganspace_sketch_update(const float* x, const float* oimg, const float* y,
                                      const float* s, const float* sq, float* y_out,
                                      float* s_out, float* sq_out, float* part, float* pimg,
                                      float* sqpart, int n, int d, int l, int kn, int splits,
                                      void* stream) {
  using sketch::Geo;
  using sketch::kKC;
  using sketch::kM;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || d < 1 || l < 1 || kn != sketch::kN || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_nt = (l + kn - 1) / kn;
  const int chunks1 = (d + kKC - 1) / kKC, chunks2 = (n + kKC - 1) / kKC;
  const int per_split = (chunks1 + splits - 1) / splits;
  const int n_mt1 = (n + kM - 1) / kM, n_mt2 = (d + kM - 1) / kM;
  const long long units1 = static_cast<long long>(n_nt) * n_mt1 * splits;
  const long long units2 = static_cast<long long>(n_nt) * n_mt2;
  if (splits > chunks1 || static_cast<long long>(splits - 1) * per_split >= chunks1
      || units1 >= (1LL << 31) || units2 >= (1LL << 31)
      || reinterpret_cast<uintptr_t>(oimg) % 16 != 0 || reinterpret_cast<uintptr_t>(pimg) % 16 != 0
      || reinterpret_cast<uintptr_t>(part) % 8 != 0 || reinterpret_cast<uintptr_t>(y) % 8 != 0
      || reinterpret_cast<uintptr_t>(y_out) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const Geo G1 = {n, d, l, n_nt, chunks1, per_split, n_mt1, static_cast<int>(units1), vec};
  const Geo G2 = {n, d, l, n_nt, chunks2, chunks2, n_mt2, static_cast<int>(units2), vec};
  return static_cast<int>(sketch::update(x, oimg, y, s, sq, y_out, s_out, sq_out, part, pimg,
                                         sqpart, G1, G2, st));
}
