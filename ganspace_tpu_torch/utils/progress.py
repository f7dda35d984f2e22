"""Environment-aware progress reporting (reference ``netdissect/progress.py``):
a copy of ``ganspace_tpu/utils/progress.py``.

``verbose_progress(True)`` turns on tqdm-backed progress bars when tqdm is
importable (notebook-aware: picks ``tqdm.notebook`` under IPython kernels),
and plain timestamped prints otherwise.  ``default_progress()`` returns the
current wrapper so library code stays agnostic; ``post_progress``/``desc_
progress`` update the active bar's postfix/description like the reference.
"""

from __future__ import annotations

import sys
import time
from typing import Iterable, Optional

_verbose = False
_active_bar = None


def _in_notebook() -> bool:
    try:
        from IPython import get_ipython
        shell = get_ipython()
        return shell is not None and "IPKernelApp" in getattr(
            shell, "config", {})
    except Exception:
        return False


def verbose_progress(verbose: bool = True) -> None:
    global _verbose
    _verbose = verbose


def _tqdm():
    try:
        if _in_notebook():
            from tqdm.notebook import tqdm
        else:
            from tqdm import tqdm
        return tqdm
    except Exception:
        return None


class _PrintProgress:
    """Fallback: timestamped line per ~10% of the iterable."""

    def __init__(self, iterable=None, total=None, desc=None, **_):
        self.iterable = iterable
        self.total = total if total is not None else _safe_len(iterable)
        self.desc = desc or ""
        self._t0 = time.time()

    def __iter__(self):
        step = max(1, (self.total or 10) // 10)
        for i, x in enumerate(self.iterable):
            if i % step == 0:
                elapsed = time.time() - self._t0
                print(f"[{elapsed:8.1f}s] {self.desc} {i}/{self.total}",
                      file=sys.stderr)
            yield x

    def set_postfix(self, **kw):
        print(f"{self.desc} {kw}", file=sys.stderr)

    def set_description(self, d):
        self.desc = d

    def update(self, n=1):
        pass

    def close(self):
        pass


def _safe_len(x) -> Optional[int]:
    try:
        return len(x)
    except TypeError:
        return None


def default_progress():
    """Returns a callable ``progress(iterable, desc=...)``."""
    def run(iterable: Iterable = None, **kwargs):
        global _active_bar
        if not _verbose:
            return iterable if iterable is not None else _Null()
        tq = _tqdm()
        bar = (tq or _PrintProgress)(iterable, **kwargs)
        _active_bar = bar
        return bar
    return run


class _Null:
    def set_postfix(self, **kw): pass
    def set_description(self, d): pass
    def update(self, n=1): pass
    def close(self): pass


def post_progress(**kwargs) -> None:
    """Update the postfix of the most recent progress bar."""
    if _active_bar is not None:
        try:
            _active_bar.set_postfix(**kwargs)
        except Exception:
            pass


def desc_progress(desc: str) -> None:
    if _active_bar is not None:
        try:
            _active_bar.set_description(desc)
        except Exception:
            pass


def print_progress(msg: str) -> None:
    if _verbose:
        print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr)
