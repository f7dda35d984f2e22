"""The benchmark's own tracing: ranges around the program's layer entry
points, and a ``torch.profiler`` trace over whole units of work.

A range wraps a function of the program (``module``, ``attr``) for the
length of one profiled stretch: each call is recorded with its arguments'
shapes and runs inside ``record_function("bench:<name>")``.  The device
time of a range is the time of the device operations whose launch (the
CUDA runtime call with the operation's correlation id) falls inside one
of its intervals on the host: what the layer launched, whatever kernels
implement it.  The stretch itself runs inside ``bench:unit`` and ends in
a synchronize, so its length is the traced window.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

UNIT = "bench:unit"


def _shape(v):
    return tuple(v.shape) if isinstance(v, torch.Tensor) else v


def _shapes(v):
    """Tensors -> their shapes, tuples (a state) -> the shapes of their
    tensors, anything else as it is."""
    if isinstance(v, tuple):
        return tuple(_shape(t) for t in v)
    return _shape(v)


@dataclass
class Summary:
    span_s: float                                   # the traced window
    busy_s: float                                   # union of device activity in it
    range_s: Dict[str, float]                       # device seconds launched in each range
    calls: Dict[str, list]                          # each range's calls: (args, kwargs) shapes
    top_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)
    n_device_ops: int = 0


@contextlib.contextmanager
def ranges(entry_points: Dict[str, Tuple[str, str]], calls: Dict[str, list]):
    """Wrap each ``name -> (module, attr)`` for the length of the block."""
    saved = []
    try:
        for name, (modname, attr) in entry_points.items():
            mod = importlib.import_module(modname)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            log = calls.setdefault(name, [])

            def wrapped(*a, __fn=fn, __name=f"bench:{name}", __log=log, **k):
                __log.append((tuple(_shapes(v) for v in a),
                              {kk: _shapes(v) for kk, v in k.items()}))
                with torch.profiler.record_function(__name):
                    return __fn(*a, **k)
            setattr(mod, attr, functools.update_wrapper(wrapped, fn))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


class Profiled:
    """``with Profiled(entry_points) as p: ...`` traces the block as one
    stretch of whole units; ``p.summary`` afterwards."""

    def __init__(self, entry_points: Dict[str, Tuple[str, str]]):
        self.entry_points = entry_points
        self.calls: Dict[str, list] = {}
        self.summary: Optional[Summary] = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._ranges = ranges(self.entry_points, self.calls)
        self._ranges.__enter__()
        self._unit = torch.profiler.record_function(UNIT)
        self._unit.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._unit.__exit__(*exc)
        self._ranges.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(self._prof.profiler.kineto_results.events(),
                                     list(self.entry_points), self.calls)
        return False


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events, range_names, calls) -> Summary:
    cuda = torch.autograd.DeviceType.CUDA
    device, runtime, cpu = [], {}, []
    unit = None
    for e in events:
        if e.device_type() == cuda:
            if e.name().startswith("bench:") or e.is_user_annotation():
                continue              # a range's mirror on the device, not an operation
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id(),
                           e.name()))
            continue
        name = e.name()
        if name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
            runtime[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
        elif name == UNIT:
            unit = (e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
        else:
            cpu.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id(), name))
    if unit is None:
        raise RuntimeError("the profiler recorded no bench:unit range")
    u0, u1, tid = unit
    device = [d for d in device if d[1] > u0 and d[0] < u1]
    busy = _union((max(a, u0), min(b, u1)) for a, b, _, _ in device)
    busy_ns = sum(b - a for a, b in busy)

    main = sorted((a, b, n) for a, b, t, n in cpu if t == tid and u0 <= a <= u1)
    spans = {r: sorted((a, b) for a, b, n in main if n == f"bench:{r}") for r in range_names}
    starts = {r: [a for a, _ in s] for r, s in spans.items()}

    def in_range(r, t):
        i = bisect.bisect_right(starts[r], t) - 1
        return i >= 0 and spans[r][i][1] >= t

    range_ns = defaultdict(int)
    by_name = defaultdict(int)
    launch_of = {}
    for a, b, corr, name in device:
        by_name[name[:160]] += b - a
        hit = runtime.get(corr)             # the CUDA runtime call that launched it
        if hit is None or hit[1] != tid:
            continue
        launch_of[(a, corr)] = hit[0]
        for r in range_names:
            if in_range(r, hit[0]):
                range_ns[r] += b - a

    # the idle gaps, by the host op that launched the operation ending each
    gaps = []
    ends = sorted(device, key=lambda d: d[0])
    for (a0, b0), (a1, _) in zip(busy, busy[1:] + [[u1, u1]]):
        if a1 <= b0:
            continue
        k = bisect.bisect_left(ends, (a1,))
        nxt = ends[k] if k < len(ends) else None
        t = launch_of.get((nxt[0], nxt[2])) if nxt is not None and nxt[0] == a1 else None
        gaps.append((a1 - b0, t))
    if busy and busy[0][0] > u0:
        gaps.append((busy[0][0] - u0, None))
    labels = _innermost(main, sorted(t for _, t in gaps if t is not None))
    idle = defaultdict(int)
    for g, t in gaps:
        idle[labels.get(t, "host (no launch: the stretch's end or a sync)")] += g

    def top(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return Summary(span_s=(u1 - u0) / 1e9, busy_s=busy_ns / 1e9,
                   range_s={r: range_ns[r] / 1e9 for r in range_names},
                   calls=calls, top_ops=top(by_name), idle_gaps=top(idle),
                   n_device_ops=len(device))


def _innermost(main, times) -> Dict[int, str]:
    """For each host time, the chain of recorded ops enclosing it on the
    main thread: outermost benchmark range > innermost op ("python" when
    no op encloses it)."""
    out, stack, j = {}, [], 0
    for t in times:
        while j < len(main) and main[j][0] <= t:
            while stack and stack[-1][1] < main[j][0]:
                stack.pop()
            stack.append(main[j])
            j += 1
        live = [s for s in stack if s[1] >= t]
        bench = next((s[2] for s in live if s[2].startswith("bench:")), None)
        inner = live[-1][2] if live else "python"
        out[t] = inner if bench is None or bench == inner else f"{bench} > {inner}"
    return out
