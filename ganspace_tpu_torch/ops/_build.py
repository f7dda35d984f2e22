"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``), all of them
at once, and the objects are linked into one shared library with a plain C
interface, which is loaded through ``ctypes``.  The library lands in
``build/ganspace_tpu_torch/`` at the root of the checkout and is keyed by a
hash of the sources, headers and flags, so an edit to any kernel rebuilds
it and an unchanged tree reuses it.  Nothing here
runs at import time: the first call of a kernel wrapper on a CUDA tensor
builds and loads the library.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
A raw launch goes to the calling thread's current device, so
:func:`stream_handle` refuses a tensor on another device than the current
one.  Processes that build at the same time (the ranks of a mesh on a clean
checkout) take turns on a lock file in the build directory: the first
compiles, the others load its library.
"""

from __future__ import annotations

import ctypes
import contextlib
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ganspace_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream are c_void_p, sizes are c_int.
_SIGNATURES = {
    "ganspace_centered_gram": [_P, _P, _P, _I, _I, _P],
    "ganspace_modconv3x3": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "ganspace_upsample_conv": [_P] * 6 + [_I] * 8 + [_P],
    "ganspace_tf32x3_tile": [_P, _P, _P, _P],
    "ganspace_wgmma_tile": [_P, _P, _P, _P, _I, _P],
    "ganspace_wgmma_tile_bf16": [_P, _P, _P, _I, _P],
    "ganspace_sketch_update": [_P] * 11 + [_I] * 5 + [_P],
    "ganspace_sketch_omega_image": [_P, _P, _I, _I, _P],
}


class KernelLibrary:
    """The loaded library plus what its build cost."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float,
                 ptxas_log: str):
        self.lib = lib
        self.path = path
        #: 0.0 when the library was already built for these sources
        self.build_seconds = build_seconds
        #: nvcc's -Xptxas -v report (registers, shared memory, spills)
        self.ptxas_log = ptxas_log
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self.lib, name)


_lock = threading.Lock()
_loaded: KernelLibrary | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels of ganspace_tpu_torch need the CUDA toolkit")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds) -> str:
    """Run the commands side by side; raise on the first that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    logs, failed = [], None
    for cmd, proc in procs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}"
    if failed:
        raise RuntimeError(failed)
    return "".join(logs)


def _compile_and_link(sources, lib_path: Path) -> str:
    """One nvcc per source, all started together, then one link."""
    tag = f"{lib_path.stem}.{os.getpid()}"
    objs = [lib_path.with_name(f"{tag}.{src.stem}.o") for src in sources]
    log = _run([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)])
    tmp = lib_path.with_name(f"{tag}.tmp.so")
    _run([[_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib_path)
    return log


@contextlib.contextmanager
def build_lock(name: str):
    """Hold ``build/ganspace_tpu_torch/<name>.lock`` exclusively: one
    process at a time compiles and links into the build directory."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def load_kernels() -> KernelLibrary:
    """Build the library if needed and load it (once per process)."""
    global _loaded
    if _loaded is not None:
        return _loaded
    with _lock, build_lock("kernels"):
        if _loaded is not None:
            return _loaded
        sources = sorted(CSRC.glob("*.cu"))
        digest = _digest(sorted(CSRC.glob("*.cu*")))
        lib_path = BUILD_DIR / f"libganspace_kernels_{digest}.so"
        log_path = lib_path.with_suffix(".log")
        seconds = 0.0
        if not lib_path.is_file():
            t0 = time.perf_counter()
            log = _compile_and_link(sources, lib_path)
            seconds = time.perf_counter() - t0
            log_path.write_text(log)
        log = log_path.read_text() if log_path.is_file() else ""
        _loaded = KernelLibrary(ctypes.CDLL(str(lib_path)), lib_path, seconds,
                                log)
        return _loaded


def check(code: int, name: str) -> None:
    """Raise when a kernel's launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def stream_handle(tensor) -> int:
    """The raw handle of the current CUDA stream on ``tensor``'s device,
    which must be the current device: a ``ctypes`` launch runs there."""
    import torch
    if tensor.device.index != torch.cuda.current_device():
        raise RuntimeError(f"kernel launch on {tensor.device} while the current device is "
                           f"cuda:{torch.cuda.current_device()}; call "
                           f"torch.cuda.set_device({tensor.device.index}) first")
    return torch.cuda.current_stream(tensor.device).cuda_stream
