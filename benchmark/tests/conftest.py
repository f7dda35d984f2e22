"""Fixtures of the benchmark's tests."""

from __future__ import annotations

import pytest


@pytest.fixture
def cuda():
    """Skip unless a CUDA device is there (decided in the fixture)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
