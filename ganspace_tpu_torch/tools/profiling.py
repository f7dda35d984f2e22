"""What ``profile_wpca`` and ``profile_convtap`` share: wall-clock stamps,
method wrappers that take them, the repeated fit, and the summary of a
traced repetition (``utils/tracing``).

Each tool fits one configuration through ``get_or_compute`` once to warm
up, then ``REPS`` more times (its own default when unset), and prints each
repetition's stamps.  With ``GANSPACE_PHASE_TRACE=1``, which the tools set,
``decomposition._compute`` prints its phase trace on stderr.  When
``TRACE_DIR`` is set, the last repetition runs under
``tracing.trace(TRACE_DIR)`` and the tool prints the device's busy share of
it (the union of its kernels' and copies' intervals), its longest idle
stretches by the program span (``utils.tracing.annotate``) that launched the
work ending each, and the host ops that take the most self CPU time.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Optional

#: host ops printed from a traced repetition, by self CPU time
TOP_HOST_OPS = 12
#: idle chains printed from a traced repetition, by idle time
TOP_IDLE = 10


class Stamps:
    """(label, perf_counter) pairs of one repetition."""

    def __init__(self):
        self.marks: list[tuple[str, float]] = []

    def __call__(self, label: str) -> None:
        self.marks.append((label, time.perf_counter()))

    def lines(self, width: int) -> list[str]:
        """``label +dt (t=since the first stamp)`` for every stamp after the first."""
        t0 = prev = self.marks[0][1]
        out = []
        for label, t in self.marks[1:]:
            out.append(f"  {label:{width}s} +{t - prev:7.3f}s (t={t - t0:7.3f})")
            prev = t
        return out


@contextlib.contextmanager
def environ(**kw):
    """Environment variables set for the region, then restored."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update({k: str(v) for k, v in kw.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def patched(cls, name: str, make):
    """``cls.name`` replaced by ``make(original)`` for the region."""
    orig = getattr(cls, name)
    setattr(cls, name, make(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


#: trace-event categories: the device's work, and the host's spans
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
#: the host calls that launch device work (their ``args.correlation`` is
#: the device operation's)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "(no program span)"


def host_self_times(events) -> dict:
    """{name: [self microseconds, count]} of the host spans of a chrome
    trace: each span's duration less its direct children's on its thread."""
    spans = sorted((e for e in events if e.get("cat") in HOST_CATS and "dur" in e),
                   key=lambda e: (e["pid"], e["tid"], e["ts"], -e["dur"]))
    out, stack, thread = {}, [], None
    for e in spans:
        if (e["pid"], e["tid"]) != thread:
            thread, stack = (e["pid"], e["tid"]), []
        while stack and stack[-1][0] <= e["ts"]:
            stack.pop()
        row = out.setdefault(e["name"], [0.0, 0])
        row[0] += e["dur"]
        row[1] += 1
        if stack:
            out[stack[-1][1]][0] -= e["dur"]
        stack.append((e["ts"] + e["dur"], e["name"]))
    return out


def _correlation(e) -> Optional[int]:
    return e.get("args", {}).get("correlation")


def device_idle(events) -> tuple:
    """(busy microseconds, idle chains) of a chrome trace's device work.

    Busy is the union of the kernel and copy intervals, so overlapping work
    counts once.  Each idle stretch between two busy ones goes to the chain
    "outermost > innermost" of the program spans (``user_annotation``
    events) open on the host thread that launched the operation ending it,
    at the launch (the runtime call with the operation's correlation id);
    :data:`NO_SPAN` when none is open or the launch is not in the trace.
    The chains are ``[chain, idle microseconds, stretches]``, longest first."""
    device = sorted(((e["ts"], e["ts"] + e["dur"], _correlation(e))
                     for e in events if e.get("cat") in DEVICE_CATS and "dur" in e),
                    key=lambda d: d[:2])
    launch = {_correlation(e): (e["pid"], e["tid"], e["ts"]) for e in events
              if e.get("cat") in LAUNCH_CATS and _correlation(e) is not None}
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and "dur" in e:
            spans.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
    for v in spans.values():
        v.sort(key=lambda s: (s[0], -s[1]))

    busy, ends = [], []          # merged intervals; the operation starting each
    for a, b, corr in device:
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
            ends.append(corr)

    # the chain at each launch, by one sweep of each thread's spans
    at = {}
    for corr in ends[1:]:
        hit = launch.get(corr)
        if hit is not None:
            at.setdefault(hit[:2], []).append(hit[2])
    chain_at = {}
    for thread, times in at.items():
        stack, j, ss = [], 0, spans.get(thread, [])
        for t in sorted(times):
            while j < len(ss) and ss[j][0] <= t:
                while stack and stack[-1][1] < ss[j][0]:
                    stack.pop()
                stack.append(ss[j])
                j += 1
            live = [sp[2] for sp in stack if sp[1] >= t]
            chain_at[thread + (t,)] = (NO_SPAN if not live else live[0] if len(live) == 1
                                       else f"{live[0]} > {live[-1]}")

    idle = {}
    for (_, b0), (a1, _), corr in zip(busy, busy[1:], ends[1:]):
        hit = launch.get(corr)
        row = idle.setdefault(NO_SPAN if hit is None else chain_at[hit], [0.0, 0])
        row[0] += a1 - b0
        row[1] += 1
    chains = sorted(([k, v[0], v[1]] for k, v in idle.items()), key=lambda r: -r[1])
    return sum(b - a for a, b in busy), chains


def print_trace_summary(path: Path, wall_s: float) -> None:
    """From a trace file: the device's busy share of ``wall_s`` (the union
    of its kernels' and copies' intervals), its idle stretches by program
    span, and the host ops with the most self time."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    n_device = sum(e.get("cat") in DEVICE_CATS for e in events)
    wall_ms = wall_s * 1e3
    if n_device:
        busy_us, chains = device_idle(events)
        busy_ms = busy_us / 1e3
        print(f"traced rep: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
              f"({busy_ms / wall_ms:.1%}), {n_device} kernels and copies")
        print(f"top {TOP_IDLE} device idle stretches by program span:")
        for name, us, n in chains[:TOP_IDLE]:
            print(f"  {us / 1e3:9.1f} ms {us / 1e3 / wall_ms:6.1%}  x{n:<6d} {name[:80]}")
    else:
        print(f"traced rep: wall {wall_ms:.1f} ms, device busy: not measured "
              f"(no CUDA activity in the trace)")
    print(f"top {TOP_HOST_OPS} host ops by self CPU time:")
    top = sorted(host_self_times(events).items(), key=lambda kv: -kv[1][0])
    for name, (us, count) in top[:TOP_HOST_OPS]:
        print(f"  {us / 1e3:9.1f} ms {us / 1e3 / wall_ms:6.1%}  x{count:<6d} {name[:80]}")


def run_reps(cfg, inst, stamp: Stamps, default_reps: int, width: int,
             header: str = "") -> None:
    """The warm-up fit, then ``REPS`` timed fits of ``cfg`` on ``inst``,
    each recomputed (its cache removed after it is read); the last under
    ``tracing.trace(TRACE_DIR)`` when ``TRACE_DIR`` is set."""
    from ganspace_tpu_torch.decomposition import get_or_compute
    from ganspace_tpu_torch.utils import tracing

    reps = int(os.environ.get("REPS", default_reps))
    trace_dir = os.environ.get("TRACE_DIR")
    device = inst.model.device
    with tempfile.TemporaryDirectory() as tmp, environ(GANSPACE_OUTPUT_DIR=tmp):
        def fit() -> Path:
            path = get_or_compute(cfg, inst)
            tracing.device_sync(next(inst.model.parameters()))
            return path

        t0 = time.perf_counter()
        fit().unlink()
        print(f"warm run: {time.perf_counter() - t0:.2f}s", flush=True)

        for rep in range(reps):
            traced = trace_dir is not None and rep == reps - 1
            before = set(Path(trace_dir).glob("*.pt.trace.json")) if traced else set()
            ctx = (tracing.trace(trace_dir, device=device.type)
                   if traced else contextlib.nullcontext())
            stamp.marks.clear()
            with ctx:
                stamp("start")
                t0 = time.perf_counter()
                path = fit()
                stamp("end")
                total = time.perf_counter() - t0
            print(f"\n=== rep {rep}: total {total:.3f}s{header} ===")
            print("\n".join(stamp.lines(width)))
            print(f"  npz size: {path.stat().st_size / 1e6:.1f} MB", flush=True)
            path.unlink()
            if traced:
                (written,) = set(Path(trace_dir).glob("*.pt.trace.json")) - before
                print(f"trace written: {written}")
                print_trace_summary(written, total)
