"""The yardstick's arithmetic: published peaks of the card, and the
operations and bytes of each layer as functions of its shapes.

A roofline's bound is the larger of operations over the 3xTF32 rate (the
rate the program's float32 kernels run at: the TF32 tensor cores' 495
TFLOP/s over three passes) and bytes over the HBM rate; each input byte is
read once and each output byte written once, whatever a kernel reads again.
Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit.
"""

from __future__ import annotations

PEAK_3XTF32 = 495e12 / 3      # FLOP/s, TF32 tensor cores, three passes
PEAK_FFMA = 67e12             # FLOP/s, float32 outside the tensor cores
PEAK_BYTES = 3.35e12          # bytes/s, HBM3
F32 = 4


def bound_s(flop: float, nbytes: float) -> float:
    """The least seconds the card needs for the work."""
    return max(flop / PEAK_3XTF32, nbytes / PEAK_BYTES)


def modconv3x3(b: int, c: int, co: int, h: int, w: int) -> tuple:
    """Kernel B's modulated mode, ``d * conv3x3(x * s, W)``, stride 1,
    padding 1: (FLOP, bytes) of x, W, s, d read and y written."""
    flop = 2.0 * b * h * w * co * 9 * c
    nbytes = F32 * (b * c * h * w + co * c * 9 + b * c + b * co + b * co * h * w)
    return flop, nbytes


def _up_taps(n: int, k: int, pad: int) -> int:
    size = 2 * n + k - 2 - 2 * pad
    return sum(0 <= 2 * i + u - pad < size for i in range(n) for u in range(k))


def upconv(b: int, c: int, co: int, h: int, w: int, k: int = 3, pad: int = 0,
           modulated: bool = True) -> tuple:
    """The stride-2 transposed conv (B-up), ``d * convT(x * s, W)``: 2 C Co
    per (input pixel, tap) whose output lands in the map (no zero-inserted
    or padded input counted); bytes of x, W, s, d read and y written."""
    flop = 2.0 * b * c * co * _up_taps(h, k, pad) * _up_taps(w, k, pad)
    ho, wo = 2 * h + k - 2 - 2 * pad, 2 * w + k - 2 - 2 * pad
    sd = (b * c + b * co) if modulated else 0
    nbytes = F32 * (b * c * h * w + co * c * k * k + b * co * ho * wo + sd)
    return flop, nbytes


def sketch_update(n: int, d: int, l: int) -> tuple:
    """One block of the Nystrom sketch, ``Y += x^T (x Omega)``: its two
    products, and x, Omega and Y read, Y written."""
    return 4.0 * n * d * l, F32 * (n * d + d * l + 2 * d * l)


def linear(n: int, fan_in: int, fan_out: int) -> float:
    return 2.0 * n * fan_in * fan_out
