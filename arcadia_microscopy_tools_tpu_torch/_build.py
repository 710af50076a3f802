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

__all__ = [
    "BuiltLibrary",
    "NVCC_FLAGS",
    "check_launch",
    "cuda_stream",
    "load_kernel_libraries",
    "load_kernel_library",
]

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


def _paths(name: str) -> tuple[Path, Path, Path]:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so", BUILD_DIR / f"{name}-{digest}.ptxas.txt"


def _build(names: list[str]) -> None:
    """Load every library of `names`, first compiling the missing ones with
    one nvcc process each, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    t0 = time.perf_counter()
    try:
        for name in names:
            src, so, log = _paths(name)
            if so.exists():
                continue
            # build under a temporary name and rename into place, so concurrent
            # processes never load a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            jobs.append((name, src, so, log, tmp, proc))
        failed = []
        for name, src, so, log, tmp, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {src}:\n{out}")
                continue
            log.write_text(out)
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for *_, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    seconds = time.perf_counter() - t0
    built = {job[0] for job in jobs}
    for name in names:
        _, so, log = _paths(name)
        ptxas = log.read_text() if log.exists() else ""
        _loaded[name] = BuiltLibrary(
            ctypes.CDLL(str(so)), so, seconds if name in built else 0.0, ptxas
        )


def load_kernel_libraries(names: list[str]) -> dict[str, BuiltLibrary]:
    """Build (if needed, in parallel) and load `csrc/<name>.cu` for each name;
    cached per process."""
    with _lock:
        missing = [n for n in names if n not in _loaded]
        if missing:
            _build(missing)
        return {n: _loaded[n] for n in names}


def load_kernel_library(name: str) -> BuiltLibrary:
    """Build (if needed) and load `csrc/<name>.cu`; cached per process."""
    return load_kernel_libraries([name])[name]


def cuda_stream(t) -> ctypes.c_void_p:
    """PyTorch's current stream on the device of tensor `t`, for a launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_launch(err: int, what: str) -> None:
    """Raise if a kernel library's launch function returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with cudaError {err}")
