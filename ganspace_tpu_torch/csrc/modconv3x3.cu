// Modulated 3x3 convolution, stride 1, zero padding 1, NCHW float32:
//
//   y[b,o,h,w] = d[b,o] * sum_{c,u,v} wt[c,u,v,o] * s[b,c] * x[b,c,h+u-1,w+v-1]
//
// with wt the He-scaled weight (scale * W, transposed to [C, 3, 3, Co] by
// the wrapper), s the per-sample style scales and d the demodulation
// coefficients (omitted when null).
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
// it is compute-bound at C >= 128 and nearer the memory bound at the
// C = 32 / 64 tail stages (1024 and 512 px).  The design:
//   * each block computes a 16 x 16 tile of output pixels for 32 output
//     channels of one sample; its 256 threads each keep a 4-pixel x
//     8-channel register tile;
//   * it loops over the input channels 8 at a time, staging the 18 x 18
//     halo of those channels (zeros outside the image) and their 3x3x32
//     weights in shared memory;
//   * the style scale is applied on the halo load, so no scaled copy of x
//     exists, and d is applied in the epilogue;
//   * sums run in two levels (72-term partials per channel chunk), which
//     keeps float32 rounding well below a plain running sum;
//   * plain float32 FFMA, no tensor cores (the f32 path stays IEEE).
// Implicit GEMM with wgmma, TMA staging and bf16 are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kCoTile = 32;    // output channels per block
constexpr int kChunk = 8;      // input channels staged per step
constexpr int kThreads = 256;  // 4 channel groups x 64 pixel groups

__global__ void __launch_bounds__(kThreads)
modconv3x3_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                  const float* __restrict__ s, const float* __restrict__ dmod,
                  float* __restrict__ y, int n_in, int h, int w, int n_out,
                  int tiles_w) {
  const int b = blockIdx.z;
  const int o0 = blockIdx.y * kCoTile;
  const int h0 = (blockIdx.x / tiles_w) * kTileH;
  const int w0 = (blockIdx.x % tiles_w) * kTileW;

  __shared__ float x_s[kChunk][kHaloH][kHaloW];
  __shared__ __align__(16) float w_s[kChunk][9][kCoTile];

  const int tid = threadIdx.x;
  const int cog = tid % 4;        // output channels cog*8 .. cog*8+7
  const int pg = tid / 4;         // pixel group 0..63
  const int prow = pg / 4;        // tile row 0..15
  const int pcol = (pg % 4) * 4;  // tile columns pcol .. pcol+3

  const long long plane = static_cast<long long>(h) * w;
  const float* xb = x + static_cast<long long>(b) * n_in * plane;
  const float* sb = s + static_cast<long long>(b) * n_in;

  float acc[4][8];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;

  for (int c0 = 0; c0 < n_in; c0 += kChunk) {
    for (int idx = tid; idx < kChunk * kHaloH * kHaloW; idx += kThreads) {
      const int ck = idx / (kHaloH * kHaloW);
      const int rem = idx % (kHaloH * kHaloW);
      const int r = rem / kHaloW;
      const int cc = rem % kHaloW;
      const int c = c0 + ck;
      const int hh = h0 - 1 + r;
      const int ww = w0 - 1 + cc;
      float v = 0.f;
      if (c < n_in && hh >= 0 && hh < h && ww >= 0 && ww < w)
        v = xb[c * plane + static_cast<long long>(hh) * w + ww] * sb[c];
      x_s[ck][r][cc] = v;
    }
    for (int idx = tid; idx < kChunk * 9 * kCoTile; idx += kThreads) {
      const int ck = idx / (9 * kCoTile);
      const int rem = idx % (9 * kCoTile);
      const int uv = rem / kCoTile;
      const int co = rem % kCoTile;
      const int c = c0 + ck;
      const int o = o0 + co;
      w_s[ck][uv][co] = (c < n_in && o < n_out)
          ? wt[(static_cast<long long>(c) * 9 + uv) * n_out + o] : 0.f;
    }
    __syncthreads();

    float part[4][8];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) part[p][q] = 0.f;

#pragma unroll 2
    for (int ck = 0; ck < kChunk; ++ck) {
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        float xv[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) xv[j] = x_s[ck][prow + u][pcol + j];
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const float4 wa = *reinterpret_cast<const float4*>(&w_s[ck][u * 3 + v][cog * 8]);
          const float4 wb = *reinterpret_cast<const float4*>(&w_s[ck][u * 3 + v][cog * 8 + 4]);
          const float wr[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < 8; ++q)
              part[p][q] = fmaf(xv[p + v], wr[q], part[p][q]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] += part[p][q];
    __syncthreads();
  }

  const int oh = h0 + prow;
  if (oh >= h) return;
  const int ow = w0 + pcol;
  const bool vec = (w % 4 == 0) && (ow + 3 < w);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int o = o0 + cog * 8 + q;
    if (o >= n_out) continue;
    const float dq = dmod ? dmod[static_cast<long long>(b) * n_out + o] : 1.f;
    float* yo = y + (static_cast<long long>(b) * n_out + o) * plane
                + static_cast<long long>(oh) * w;
    if (vec) {
      *reinterpret_cast<float4*>(yo + ow) =
          make_float4(acc[0][q] * dq, acc[1][q] * dq, acc[2][q] * dq, acc[3][q] * dq);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (ow + p < w) yo[ow + p] = acc[p][q] * dq;
    }
  }
}

}  // namespace

// x [b, c, h, w], wt [c, 3, 3, co], s [b, c], dmod [b, co] or null,
// y [b, co, h, w]: contiguous float32 device buffers.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int ganspace_modconv3x3(const float* x, const float* wt, const float* s,
                                   const float* dmod, float* y, int b, int c,
                                   int h, int w, int co, void* stream) {
  const int tiles_h = (h + kTileH - 1) / kTileH;
  const int tiles_w = (w + kTileW - 1) / kTileW;
  const dim3 grid(tiles_h * tiles_w, (co + kCoTile - 1) / kCoTile, b);
  modconv3x3_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, wt, s, dmod, y, c, h, w, co, tiles_w);
  return static_cast<int>(cudaGetLastError());
}
