"""Build and load the package's CUDA kernels.

Each kernel source under `csrc/` has a plain `extern "C"` interface. At
first use it is compiled with `nvcc` for Hopper (`sm_90a`) into a shared
library under `<repo>/build/torch_kernels/`, named by a hash of the source
and the flags, and loaded with `ctypes`. Nothing is compiled at import time:
machines without `nvcc` (the CPU test lane) import the package freely and
never reach this code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["load_kernel_library", "BuiltLibrary", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclass(frozen=True)
class BuiltLibrary:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was reused
    ptxas_log: str  # nvcc's -Xptxas -v report (registers, shared memory, spills)


_loaded: dict[str, BuiltLibrary] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA kernels "
        "of arcadia_microscopy_tools_tpu_torch are built from source at first use"
    )


def _build(name: str) -> BuiltLibrary:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"{name}-{digest}.so"
    log = BUILD_DIR / f"{name}-{digest}.ptxas.txt"
    seconds = 0.0
    if not so.exists():
        t0 = time.perf_counter()
        # build under a temporary name and rename into place, so concurrent
        # processes never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True,
                text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
            log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        seconds = time.perf_counter() - t0
    ptxas = log.read_text() if log.exists() else ""
    return BuiltLibrary(ctypes.CDLL(str(so)), so, seconds, ptxas)


def load_kernel_library(name: str) -> BuiltLibrary:
    """Build (if needed) and load `csrc/<name>.cu`; cached per process."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = _build(name)
        return _loaded[name]
