"""ctypes bindings for the native host kernels (native/amt_host.cpp).

Counterpart of `arcadia_microscopy_tools_tpu/_native/__init__.py`, with
its own copy of the library: `build()` (or `make native`) compiles the
repository's `native/amt_host.cpp` with g++ into `build/libamt_host.so`
beside this file, a directory git ignores. Loaded lazily; every caller has
a pure-Python fallback, so a missing or unbuildable library never breaks
the package. This is host code: the planarize of ND2 frames and the
geometry of label outlines and hulls.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "amt_host.cpp"
LIBRARY = Path(__file__).resolve().parent / "build" / "libamt_host.so"

_LIB = None
_TRIED = False


def build() -> bool:
    """Compile `native/amt_host.cpp` into `LIBRARY` with g++ -O3 (skipped
    when the library exists). Returns whether the library is there
    afterwards; False when g++ or the source is missing. Safe when several
    processes build at once: each writes its own file and renames it into
    place."""
    global _TRIED, _LIB
    if LIBRARY.exists():
        return True
    compiler = shutil.which("g++")
    if compiler is None or not SOURCE.exists():
        return False
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIBRARY.parent)
    os.close(fd)
    try:
        subprocess.run([compiler, "-O3", "-shared", "-fPIC", "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _TRIED, _LIB = False, None  # load the new library on the next call
    return True


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = LIBRARY
    if not so.exists():
        return None
    try:
        lib = ctypes.CDLL(str(so))
        lib.trace_outlines.restype = ctypes.c_int
        lib.trace_outlines.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.convex_areas.restype = ctypes.c_int
        lib.convex_areas.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double),
        ]
        try:
            lib.deinterleave_u16.restype = None
            lib.deinterleave_u16.argtypes = [
                ctypes.POINTER(ctypes.c_uint16),
                ctypes.c_int64,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint16),
            ]
        except AttributeError:
            pass  # older .so without the decode kernel
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def trace_outlines(label_image: np.ndarray) -> list[np.ndarray] | None:
    """Boundary traces per label ((y, x) int coords) or None if the native
    library is unavailable / capacity exceeded."""
    lib = _load()
    if lib is None:
        return None
    lbl = np.ascontiguousarray(label_image, dtype=np.int32)
    h, w = lbl.shape
    n = int(lbl.max())
    if n == 0:
        return []
    cap = int(lbl.size * 2 + 16 * n)
    coords = np.empty((cap, 2), dtype=np.int32)
    offsets = np.empty(n + 1, dtype=np.int64)
    rc = lib.trace_outlines(
        lbl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        h,
        w,
        n,
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cap,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    out = []
    for k in range(n):
        seg = coords[offsets[k] : offsets[k + 1]]
        out.append(seg.astype(np.float64))
    return out


def deinterleave_u16(src: np.ndarray, n_px: int, c: int, dst: np.ndarray) -> bool:
    """Planarize an interleaved uint16 frame ((Y*X, C) -> (C, Y*X)) in C++.

    `src` must be a contiguous uint16 buffer of n_px*c values; `dst` a
    contiguous uint16 buffer of c*n_px values (written in place). Returns
    False when the native library (or this kernel) is unavailable.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "deinterleave_u16"):
        return False
    lib.deinterleave_u16(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        n_px,
        c,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
    )
    return True


def convex_areas(label_image: np.ndarray) -> np.ndarray | None:
    """Per-label convex hull pixel counts or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    lbl = np.ascontiguousarray(label_image, dtype=np.int32)
    h, w = lbl.shape
    n = int(lbl.max())
    if n == 0:
        return np.zeros(0)
    areas = np.zeros(n, dtype=np.float64)
    rc = lib.convex_areas(
        lbl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        h,
        w,
        n,
        areas.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        return None
    return areas
