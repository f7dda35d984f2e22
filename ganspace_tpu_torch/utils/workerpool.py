"""Generic host-side worker pool for CPU-bound post-processing: a copy of
``ganspace_tpu/utils/workerpool.py``.

Python-level counterpart of the reference's fork-based pool
(``netdissect/workerpool.py:35-157``) used there for image saving and
report generation.  In this framework the hot image-encode path is the
native C++ pool (``ganspace_tpu_torch.native.ImageWriterPool``); this class covers
the *general* case — arbitrary picklable work items fanned out to worker
processes — with the same operational discipline as the reference:

* workers ignore SIGINT so Ctrl-C is handled once, by the parent;
* shutdown by poison pill (one ``None`` per worker);
* an ``atexit`` hook force-terminates leaked pools and complains loudly if
  ``join()`` was never called;
* ``process_count=0`` runs everything inline for debugging.

Keep pools for *host* work only (encoding, disk, reports).  Device work
stays in the parent — CUDA launches are already asynchronous, and forked
children must never touch the CUDA context.
"""

from __future__ import annotations

import atexit
import multiprocessing
import signal
import sys
import traceback
from typing import Optional


class WorkerBase:
    """Subclass and override ``work`` (and optionally ``setup``/``finish``)."""

    def __init__(self, i: int, process_count: int, queue, inline: bool):
        self.i = i
        self.process_count = process_count
        self._queue = queue
        self._inline = inline
        if inline:
            self.setup()

    def setup(self) -> None:
        """Runs once in the worker process before the first work item."""

    def work(self, *args, **kwargs):
        raise NotImplementedError

    def finish(self) -> None:
        """Runs once at shutdown, after the last work item."""

    # -- worker-process main loop ------------------------------------------
    def _run(self) -> None:
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        self.setup()
        while True:
            item = self._queue.get()
            if item is None:
                break
            args, kwargs = item
            try:
                self.work(*args, **kwargs)
            except Exception:
                traceback.print_exc(file=sys.stderr)
        self.finish()


class WorkerPool:
    """``WorkerPool(MyWorker, process_count=4)``; then ``.add(*args)`` per
    item and ``.join()`` once."""

    _live_pools: list = []

    def __init__(self, worker_cls, process_count: Optional[int] = None,
                 queue_max: int = 64, **worker_kwargs):
        if process_count is None:
            process_count = multiprocessing.cpu_count()
        self.process_count = process_count
        self._joined = False
        if process_count == 0:            # inline debug mode
            self._inline_worker = worker_cls(0, 0, None, inline=True,
                                             **worker_kwargs)
            self._procs = []
            self._queue = None
            return
        ctx = multiprocessing.get_context("fork")
        self._queue = ctx.Queue(maxsize=queue_max)
        self._procs = []
        for i in range(process_count):
            w = worker_cls(i, process_count, self._queue, inline=False,
                           **worker_kwargs)
            p = ctx.Process(target=w._run, daemon=True)
            p.start()
            self._procs.append(p)
        WorkerPool._live_pools.append(self)

    def add(self, *args, **kwargs) -> None:
        if self.process_count == 0:
            self._inline_worker.work(*args, **kwargs)
        else:
            self._queue.put((args, kwargs))

    def join(self) -> None:
        self._joined = True
        if self.process_count == 0:
            self._inline_worker.finish()
            return
        for _ in self._procs:
            self._queue.put(None)
        for p in self._procs:
            p.join()
        if self in WorkerPool._live_pools:
            WorkerPool._live_pools.remove(self)

    def __del__(self):
        if not self._joined and self._procs:
            print("WorkerPool deleted without join(); terminating workers",
                  file=sys.stderr)
            for p in self._procs:
                p.terminate()


@atexit.register
def _terminate_leaked_pools() -> None:
    for pool in list(WorkerPool._live_pools):
        if not pool._joined:
            print("WorkerPool leaked (join() never called); terminating",
                  file=sys.stderr)
            for p in pool._procs:
                p.terminate()
