"""File-based at-most-once job claiming for multi-host sweeps: a copy of
``ganspace_tpu/utils/jobs.py`` (host code; the port imports nothing of the
JAX package).

The framework's equivalent of the reference's pidfile discipline
(``netdissect/pidfile.py:8-22``): a sweep of decomposition / dissection jobs
can be split across many hosts with no coordinator — each host atomically
claims a job directory with a lockfile naming its host/pid, and marks
completion with a ``done.txt`` marker.  ``get_or_compute``-style caches make
re-running a finished job a no-op, so this layer only exists to keep
*concurrent* duplicates from burning devices.
"""

from __future__ import annotations

import atexit
import errno
import os
import socket
import sys
import time
from pathlib import Path
from typing import Optional


DONE_NAME = "done.txt"
LOCK_NAME = "lockfile.pid"


def job_done(directory) -> bool:
    """True if ``directory`` holds a completion marker."""
    return (Path(directory) / DONE_NAME).is_file()


def mark_job_done(directory, message: str = "done") -> None:
    """Write the ``done.txt`` marker and release this process's lock
    (reference ``pidfile.py`` mark_job_done)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / DONE_NAME).write_text(message + "\n")
    release_job(directory)


def claim_job(directory) -> bool:
    """Atomically claim ``directory``; True on success.

    Claim is an O_CREAT|O_EXCL lockfile containing ``host pid`` — the same
    at-most-once scheme as the reference, but with an atexit release so a
    crashed claimant does not wedge the sweep forever (stale locks from a
    *dead pid on the same host* are broken automatically).
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    if job_done(directory):
        return False
    lock = directory / LOCK_NAME
    ident = f"{socket.gethostname()} {os.getpid()}"
    while True:
        try:
            fd = os.open(str(lock), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            with os.fdopen(fd, "w") as f:
                f.write(ident + "\n")
            atexit.register(release_job, directory)
            return True
        except OSError as e:
            if e.errno != errno.EEXIST:
                raise
            if not _lock_is_stale(lock):
                return False
            if not _break_stale_lock(lock):
                return False           # someone else is breaking/claiming


#: a breaker mutex older than this is considered orphaned (its critical
#: section is microseconds; the margin covers pathological scheduler pauses)
_BREAKER_TTL_S = 30.0


def _break_stale_lock(lock: Path) -> bool:
    """Remove a stale lock with at-most-once semantics; True if the caller
    may retry its claim.

    Plain check-then-unlink races: two claimants can both observe the stale
    lock, and the slower unlink then deletes the *fresh* lock the faster
    claimant just created — two winners.  Breaking therefore serializes
    through a second O_EXCL file (the breaker mutex): only its holder may
    re-verify staleness and unlink.  An orphaned breaker (holder died inside
    the tiny critical section) is expired by age.
    """
    breaker = lock.with_name(LOCK_NAME + ".breaker")
    try:
        if breaker.stat().st_mtime < time.time() - _BREAKER_TTL_S:
            breaker.unlink()           # orphaned breaker; missing_ok races OK
    except FileNotFoundError:
        pass
    try:
        bfd = os.open(str(breaker), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except OSError as e:
        if e.errno == errno.EEXIST:
            return False               # another breaker is at work
        raise
    try:
        if _lock_is_stale(lock):       # re-verify under the mutex
            try:
                lock.unlink()
            except FileNotFoundError:
                pass
        return True
    finally:
        os.close(bfd)
        try:
            breaker.unlink()
        except FileNotFoundError:
            pass


def _lock_is_stale(lock: Path) -> bool:
    """A lock is stale when it names a dead pid on *this* host."""
    try:
        host, pid = lock.read_text().split()
    except (OSError, ValueError):
        return False
    if host != socket.gethostname():
        return False
    try:
        os.kill(int(pid), 0)
        return False
    except ProcessLookupError:
        return True
    except (PermissionError, ValueError):
        return False


def release_job(directory) -> None:
    """Remove this process's lockfile if it still owns it."""
    lock = Path(directory) / LOCK_NAME
    try:
        host, pid = lock.read_text().split()
        if host == socket.gethostname() and int(pid) == os.getpid():
            lock.unlink()
    except (OSError, ValueError):
        pass


def exit_if_job_done(directory, verbose: bool = True) -> None:
    """Process-level guard used at the top of sweep scripts
    (reference ``pidfile.exit_if_job_done``)."""
    if job_done(directory):
        if verbose:
            print(f"{directory}: already done.", file=sys.stderr)
        sys.exit(0)
    if not claim_job(directory):
        if verbose:
            print(f"{directory}: being handled by another process.",
                  file=sys.stderr)
        sys.exit(0)


def pending_jobs(directories) -> list:
    """Filter a sweep list down to unclaimed, unfinished jobs."""
    out = []
    for d in directories:
        d = Path(d)
        if job_done(d):
            continue
        if (d / LOCK_NAME).exists() and not _lock_is_stale(d / LOCK_NAME):
            continue
        out.append(d)
    return out
