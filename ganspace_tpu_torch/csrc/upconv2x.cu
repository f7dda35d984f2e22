// Kernel B, stride-2 mode: a stride-2 transposed convolution, NCHW float32,
// with an optional style scale and demodulation:
//
//   y = d * conv_transpose2d(x * s, wt, stride 2, padding p)
//
// (wt [co, c, k, k] in the correlation orientation, k = 3 or 4).  Output
// row Y + p of the full transposed convolution collects the taps u with
// u = Y + p (mod 2), each from input row (Y + p - u) / 2, so each of the
// four output phases (Y mod 2, X mod 2) is a stride-1 correlation of x with
// that phase's taps only (2x2, 2x1, 1x2 or 1x1 for k = 3; 2x2 for k = 4),
// written interleaved into y.  The wrapper (ops/modconv.py::upsample_conv)
// describes the phases (ops/modconv.py::upsample_phases) and gathers their
// taps, once per layer, into one buffer of [co][c/8][ty*tx][8] per phase;
// this file launches the four phases as one grid, each block a tile of one
// phase, the 2x2 phase's blocks first.
//
// Replaces no TPU kernel: the JAX package leaves the transposed convolution
// to XLA (ganspace_tpu/ops/modconv.py, StyleGAN2's upsampling StyledConv;
// ganspace_tpu/models/stylegan.py:156-166, StyleGAN's fused conv0_up at
// 128 px and up).  The port had it on cuDNN, whose dgrad algorithm sums in
// no fixed order, so a regenerated tap forward did not repeat bit for bit.
// Here the phases run kernel B's implicit GEMM (implicit_conv.cuh): a fixed
// K order, a cluster reduction in rank order and no atomics, so every launch
// gives identical bits.  It multiplies only the taps that meet a real input
// (no zero-inserted input): per output pixel 2 * (k^2 / 4) * C * Co FLOP on
// average, compute-bound at the synthesis shapes but the 4-8 px inputs.

#include <cstdint>

#include "implicit_conv.cuh"

// x [b, c, h, w]; wt: the n phases' weights one after another, each
// [co, ceil(c / 8)][ty * tx][8], zero past channel c (read 16 channels per
// stage, so the kernel zero-fills a last odd chunk); s [b, c] or null;
// dmod [b, co] or null; y [b, co, yh, yw].  phases (host memory) [n][8]:
// ty, tx, dy, dx, oh, ow, py, px: phase (py, px) writes y[:, :, py + 2m,
// px + 2n] for m < oh, n < ow from the window of ty x tx taps whose first
// row and column are m - 1 + dy, n - 1 + dx of x.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int ganspace_upsample_conv(const float* x, const float* wt, const float* s,
                                      const float* dmod, float* y, const int* phases, int n,
                                      int b, int c, int h, int w, int co, int yh, int yw,
                                      void* stream) {
  using implicit_conv::Geometry;
  if (n < 1 || n > implicit_conv::kMaxGrids) return static_cast<int>(cudaErrorInvalidValue);
  implicit_conv::Launch L = {};
  L.n = n;
  L.b = b, L.c = c, L.h = h, L.w = w, L.co = co;
  L.yh = yh, L.yw = yw, L.ostr = 2;
  const long long c8 = (c + 7) / 8 * 8;
  const float* wp = wt;
  for (int p = 0; p < n; ++p) {
    const int* ph = phases + 8 * p;
    Geometry& q = L.g[p];
    q.ty = ph[0], q.tx = ph[1], q.dy = ph[2], q.dx = ph[3];
    q.oh = ph[4], q.ow = ph[5], q.oy = ph[6], q.ox = ph[7];
    if (q.ty < 1 || q.tx < 1 || q.dy < 0 || q.dx < 0 || q.dy + q.ty > 3 || q.dx + q.tx > 3
        || q.ty > 2 || q.tx > 2 || q.oh < 1 || q.ow < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    q.wt = wp;
    q.krow = c8 * q.ty * q.tx;
    wp += co * q.krow;
    q.xvec = (w % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    q.wvec = reinterpret_cast<uintptr_t>(wt) % 16 == 0;
  }
  constexpr int kCK = 16;  // input channels per stage: the windows hold 1-4 taps
  return static_cast<int>(implicit_conv::launch_for<2, 2, false, kCK>(
      x, s, dmod, y, L, static_cast<cudaStream_t>(stream)));
}
