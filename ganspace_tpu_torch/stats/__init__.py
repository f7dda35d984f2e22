"""Streaming statistics of the dissection passes (``ganspace_tpu/stats``)."""

from ganspace_tpu_torch.stats.running import (
    RunningConditionalQuantile,
    RunningCrossCovariance,
    RunningQuantile,
    RunningTopK,
    RunningVariance,
)

__all__ = [
    "RunningTopK",
    "RunningQuantile",
    "RunningConditionalQuantile",
    "RunningCrossCovariance",
    "RunningVariance",
]
