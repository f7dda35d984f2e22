"""The port's tracing: spans and counters inside the program, kept as
per-request records, and ``torch.profiler`` traces.

* :class:`annotate` — the one span: ``with annotate("stream.block"): ...``.
  Each span reads ``time.perf_counter_ns()`` on entry and exit and sits on
  a per-thread stack, so it knows its parent and its self time (its
  duration less its children's).  A span nested in an open span of its
  own name is folded into the outer one.  While a ``torch.profiler``
  records, a span also opens ``torch.profiler.record_function(name)``, so
  it shows as a named range on the profiler's timeline beside the CUDA
  launches and kernels; with no profiler recording it makes none.
* :func:`count` — ``count("stream.passes")`` adds to a counter of the open
  request (nothing when none is open).
* **Requests** — the outermost open span on a thread is a request (a unit
  of work: a fit, a strip, a model build).  When it closes, one record goes
  into a ring of the last :data:`RING` requests of the process:
  ``{"id", "name", "start_ns", "end_ns", "traced", "spans", "counters"}``.
  ``start_ns`` and ``end_ns`` are on the clock of the profiler's events
  (nanoseconds since the Unix epoch); ``traced`` is true when a profiler
  was recording at a span boundary of the request; ``spans`` maps every
  span name in it, its own included, to ``[count, total_ns, self_ns]``, so
  the self times sum to the request's wall exactly; ``counters`` maps a
  counter to its sum.  :func:`units` returns copies of the records, and
  :func:`format_unit` prints one as a table.
* :func:`trace` — a ``torch.profiler`` trace file (``*.pt.trace.json``) of
  the block, for TensorBoard or Perfetto: the host ops, the spans above
  and, on the card, the CUDA kernels on their streams.
* :func:`device_sync` — a barrier on the devices of the given tensors.

The spans are always on: a span costs about two microseconds of host time
with no profiler recording (``tests/test_torch_port_spans.py`` prints the
figure), and nothing is kept but the ring.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

import torch

from ganspace_tpu_torch import require_device

#: requests kept, the newest last
RING = 4096

_units = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_tls = threading.local()
_now = time.perf_counter_ns
_epoch = time.time_ns
_profiling = torch._C._autograd._profiler_enabled


class _Thread:
    """A thread's open spans and the request they belong to."""

    __slots__ = ("top", "names", "spans", "counters", "traced", "offset")

    def __init__(self):
        self.top = None                  # the innermost open span
        self.names: list = []            # the open spans' names, outermost first
        self.spans: dict = {}            # the open request's rows
        self.counters: dict = {}
        self.traced = False
        self.offset = 0                  # epoch ns - perf_counter ns, per request


class annotate:
    """A named span (see the module's docstring).  After a request's
    outermost span closes, its ``record`` is the request's record (a copy of
    what went into the ring); it is None for a nested span."""

    __slots__ = ("name", "record", "_t0", "_child", "_rf", "_live", "_parent")

    def __init__(self, name: str):
        self.name = name
        self.record = None

    def __enter__(self):
        try:
            st = _tls.state
        except AttributeError:
            st = _tls.state = _Thread()
        name, names = self.name, st.names
        if name in names:
            self._live = False           # folded into the open span of this name
            return self
        self._live = True
        if not names:
            st.spans, st.counters, st.traced = {}, {}, False
            st.offset = _epoch() - _now()
        names.append(name)
        self._parent, st.top = st.top, self
        self._child = 0
        if _profiling():
            st.traced = True
            self._rf = torch.profiler.record_function(name)
            self._rf.__enter__()
        else:
            self._rf = None
        self._t0 = _now()
        return self

    def __exit__(self, *exc):
        if not self._live:
            return False
        t1 = _now()
        dur = t1 - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        st = _tls.state
        st.names.pop()
        parent = st.top = self._parent
        name = self.name
        row = st.spans.get(name)
        if row is None:
            st.spans[name] = [1, dur, dur - self._child]
        else:
            row[0] += 1
            row[1] += dur
            row[2] += dur - self._child
        if parent is not None:
            parent._child += dur
            return False
        record = {"id": next(_ids), "name": name,
                  "start_ns": self._t0 + st.offset, "end_ns": t1 + st.offset,
                  "traced": st.traced or _profiling(),
                  "spans": st.spans, "counters": st.counters}
        st.spans, st.counters = {}, {}
        _units.append(record)
        self.record = _copy(record)
        return False


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` of this thread's open request."""
    st = getattr(_tls, "state", None)
    if st is not None and st.names:
        st.counters[name] = st.counters.get(name, 0) + n


def _copy(record: dict) -> dict:
    return {**record, "spans": {k: list(v) for k, v in record["spans"].items()},
            "counters": dict(record["counters"])}


def units(name: Optional[str] = None) -> List[dict]:
    """Copies of the kept request records, oldest first; those named
    ``name`` when one is given."""
    return [_copy(r) for r in list(_units) if name is None or r["name"] == name]


def format_unit(record: dict, prefix: str = "") -> str:
    """A request record as a table: each span's count, total and self
    milliseconds, by total, then the counters; each line after ``prefix``."""
    wall = (record["end_ns"] - record["start_ns"]) / 1e6
    lines = [f"request {record['name']} #{record['id']}: {wall:.3f} ms"
             + (" (traced)" if record["traced"] else ""),
             f"  {'span':28s} {'count':>7s} {'total ms':>11s} {'self ms':>11s}"]
    for span, (n, total, own) in sorted(record["spans"].items(), key=lambda kv: -kv[1][1]):
        lines.append(f"  {span:28s} {n:7d} {total / 1e6:11.3f} {own / 1e6:11.3f}")
    for counter, v in sorted(record["counters"].items()):
        lines.append(f"  counter {counter} = {v}")
    return "\n".join(prefix + line for line in lines)


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
