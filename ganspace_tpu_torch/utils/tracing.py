"""Profiling and timing utilities: the port of ``ganspace_tpu/utils/tracing.py``
(SURVEY.md §5 tracing/profiling), on ``torch.profiler``.

* :func:`trace` — context manager around ``torch.profiler.profile`` that
  writes a trace file TensorBoard (torch-tb-profiler) and Perfetto load:
  the host ops and, on the card, the CUDA kernels on their streams;
* :class:`StepTimer` — named phase timers, the device drained at the end of
  a phase when one is given;
* :func:`annotate` — ``torch.profiler.record_function``, so pipeline phases
  show up named in the trace;
* :func:`device_sync` — a barrier on the devices of the given tensors.
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

import torch

from ganspace_tpu_torch import require_device


@contextlib.contextmanager
def trace(outdir: Optional[str] = None, *, device="cuda"):
    """``with trace('dir'): ...`` -> a ``*.pt.trace.json`` under ``dir``
    (a fresh temporary directory when none is named), which the block gets.

    ``device="cuda"`` (the default) records the CPU and CUDA activities and
    refuses a missing GPU (:func:`require_device`); ``device="cpu"`` records
    the CPU activity alone."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    dev = require_device(device)
    outdir = str(outdir or tempfile.mkdtemp(prefix="ganspace-trace-"))
    Path(outdir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(outdir)):
        yield outdir


def annotate(name: str):
    """Named region in the trace."""
    return torch.profiler.record_function(name)


def _tensors(tree):
    """The tensors among the leaves of nested dicts, lists and tuples
    (named tuples included)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def device_sync(*trees) -> None:
    """Device barrier: synchronises the device of every CUDA tensor among
    the leaves of ``trees`` (CPU tensors need none); with no arguments, the
    current CUDA device when CUDA is initialised."""
    if not trees:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    done = set()
    for tree in trees:
        for t in _tensors(tree):
            if t.is_cuda and t.device not in done:
                torch.cuda.synchronize(t.device)
                done.add(t.device)


class StepTimer:
    """Accumulating named phase timers.

        t = StepTimer()
        with t.phase("sample"): ...
        with t.phase("fit", sync=acts): ...
        print(t.report())
    """

    def __init__(self):
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                device_sync(sync)
            self._total[name] += time.perf_counter() - t0
            self._count[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self._total, key=lambda n: -self._total[n]):
            tot, cnt = self._total[name], self._count[name]
            lines.append(f"{name:>24}: {tot:8.2f}s total, {cnt:5d} calls, "
                         f"{tot / cnt * 1000:8.1f} ms/call")
        return "\n".join(lines)

    def totals(self) -> Dict[str, float]:
        return dict(self._total)
