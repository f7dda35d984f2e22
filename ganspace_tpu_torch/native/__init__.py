"""Native host components (C++, ctypes-bound): a copy of
``ganspace_tpu/native/__init__.py``'s image writer pool.

``ImageWriterPool`` stands in for the reference's fork-based image-saving
``WorkerPool`` (``netdissect/workerpool.py:35-157``): a std::thread pool
with an in-process zlib PNG encoder (``src/fastio.cpp``), so frame encoding
and disk writes run off the GIL with no per-worker process images or
pickling.

The shared library compiles on first use (g++ -O2) into
``build/ganspace_tpu_torch/`` at the root of the checkout, keyed by a hash
of the source, never next to the source; if g++ or zlib is missing, the
pool prints a notice and writes synchronously through PIL, so the pipeline
never hard-fails.  :attr:`ImageWriterPool.native` says which writer runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ganspace_tpu_torch.ops._build import BUILD_DIR

_SRC = Path(__file__).parent / "src" / "fastio.cpp"
_CMD = ("g++", "-O2", "-shared", "-fPIC", "-std=c++17")
_LIBS = ("-lz", "-lpthread")
_lock = threading.Lock()
_lib_handle: Optional[ctypes.CDLL] = None
_build_failed = False


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(_CMD + _LIBS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libfastio_{h.hexdigest()[:16]}.so"


def _build() -> Optional[ctypes.CDLL]:
    global _lib_handle, _build_failed
    with _lock:
        if _lib_handle is not None:
            return _lib_handle
        if _build_failed:
            return None
        lib_path = _lib_path()
        if not lib_path.is_file():
            # a per-process name, then an atomic rename: processes that
            # build at the same time each write their own file
            tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
            try:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                subprocess.run([*_CMD, str(_SRC), "-o", str(tmp), *_LIBS],
                               check=True, capture_output=True)
                os.replace(tmp, lib_path)
            except (subprocess.CalledProcessError, OSError) as e:
                print(f"fastio: native build failed ({e}); using PIL fallback")
                _build_failed = True
                return None
        lib = ctypes.CDLL(str(lib_path))
        lib.fastio_pool_create.restype = ctypes.c_void_p
        lib.fastio_pool_create.argtypes = [ctypes.c_int]
        lib.fastio_submit_png.restype = ctypes.c_int
        lib.fastio_submit_png.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.fastio_submit_raw.restype = ctypes.c_int
        lib.fastio_submit_raw.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long]
        lib.fastio_pool_wait.restype = None
        lib.fastio_pool_wait.argtypes = [ctypes.c_void_p]
        lib.fastio_pool_errors.restype = ctypes.c_long
        lib.fastio_pool_errors.argtypes = [ctypes.c_void_p]
        lib.fastio_pool_destroy.restype = None
        lib.fastio_pool_destroy.argtypes = [ctypes.c_void_p]
        _lib_handle = lib
        return lib


class ImageWriterPool:
    """Async PNG/raw writer.  Usage:

        with ImageWriterPool(4) as pool:
            pool.save_png(path, uint8_hwc)
        # context exit waits for the queue to drain
    """

    def __init__(self, n_threads: int = 4):
        self._lib = _build()
        self._pool = (self._lib.fastio_pool_create(n_threads)
                      if self._lib is not None else None)
        self._sync_errors = 0

    @property
    def native(self) -> bool:
        """True when the C++ pool writes; False for the synchronous PIL one."""
        return self._pool is not None

    def save_png(self, path, img: np.ndarray) -> None:
        img = np.ascontiguousarray(img)
        if img.dtype != np.uint8:
            raise ValueError("save_png expects uint8")
        if img.ndim == 2:
            img = img[:, :, None]
        h, w, c = img.shape
        if self._pool is not None:
            rc = self._lib.fastio_submit_png(
                self._pool, str(path).encode(),
                img.ctypes.data_as(ctypes.c_char_p), h, w, c)
            if rc != 0:
                raise RuntimeError("fastio_submit_png failed")
        else:
            try:
                from PIL import Image
                Image.fromarray(img.squeeze()).save(str(path))
            except (OSError, ValueError, TypeError):
                self._sync_errors += 1

    def save_raw(self, path, data: bytes) -> None:
        if self._pool is not None:
            buf = np.frombuffer(data, dtype=np.uint8)
            rc = self._lib.fastio_submit_raw(
                self._pool, str(path).encode(),
                buf.ctypes.data_as(ctypes.c_char_p), len(data))
            if rc != 0:
                raise RuntimeError("fastio_submit_raw failed")
        else:
            Path(path).write_bytes(data)

    def wait(self) -> None:
        if self._pool is not None:
            self._lib.fastio_pool_wait(self._pool)

    def errors(self) -> int:
        """Failed writes so far (the native pool's count, or PIL's)."""
        if self._pool is not None:
            return int(self._lib.fastio_pool_errors(self._pool))
        return self._sync_errors

    def close(self) -> None:
        if self._pool is not None:
            self._lib.fastio_pool_wait(self._pool)
            self._lib.fastio_pool_destroy(self._pool)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_pool", None) is not None:
            self.close()
