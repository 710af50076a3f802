"""Percentile stretch of segmentation input: the CUDA kernel and its plain version.

`percentile_stretch(images, hp, wp)` prepares a chunk of images for the
U-Net as `SegmentationModel._prepare_image` does when no zoom is needed:
each (C, h, w) image (C of 1-3; float64, float32 or uint16, cast to float32
as numpy casts) is stretched per channel by its 1st and 99th percentiles,

    clip((x - p1) / max(p99 - p1, 1e-6), 0, 1)      in float32,

its last channel replicated up to 3, edge-padded to (hp, wp) and laid out
as one (N, hp, wp, 3) float32 batch. The percentiles are np.percentile's
(linear method) of the float32 plane, as numpy 2 computes them: the values
at two sorted positions, interpolated in float32 (`percentile_plan`); a
plane holding a NaN gives NaN. The result equals `_prepare_image`'s bit for
bit, up to the sign of zero, since numpy's selection may return -0 or +0.

For CUDA tensors it launches the kernel of `csrc/percentile_stretch.cu` (an
exact radix select of the four sorted positions, then the fused stretch and
pack); for CPU tensors it runs the plain PyTorch version, a sort of the same
order-preserving keys and the same float32 arithmetic, which the tests and
`chip_smoke.py` hold the kernel against bit for bit. There is no fallback: a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from collections.abc import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .._build import check_launch, cuda_stream

__all__ = [
    "launch_counts",
    "percentile_plan",
    "percentile_stretch",
    "percentile_stretch_plain",
    "reset_launch_counts",
]

# kernel launches (one call of the library: three histogram passes, their
# steps and the stretch); only a launch of the CUDA kernel counts
launch_counts = {"percentile_stretch": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


_PERCENTILES = (1, 99)
_DTYPES = {torch.float64: 0, torch.float32: 1, torch.uint16: 2}  # the kernel's dtype codes
_THREADS = 256
_BINS = 2048
_RANKS = 4
_EPS = 1e-6


@functools.lru_cache(maxsize=1024)
def percentile_plan(n: int) -> tuple[tuple[int, ...], tuple[np.float32, ...]]:
    """What np.percentile(x, (1, 99)) of n float32 values interpolates:
    the four sorted positions (floor and floor + 1 of each percentile's
    virtual index, clipped to n - 1) and, per percentile, (t, 1 - t) in
    float32. The arithmetic is numpy's own (numpy >= 2: q / 100 and the
    virtual index in the array's float32), on numpy scalars."""
    positions, weights = [], []
    for q in _PERCENTILES:
        vi = (n - 1) * np.asanyarray(np.true_divide(q, np.float32(100)))
        prev = np.asanyarray(np.floor(vi))
        lo = prev.astype(np.intp)
        hi = np.asanyarray(prev + 1).astype(np.intp)
        if vi >= n - 1:
            lo, hi = np.asanyarray(-1).astype(np.intp), np.asanyarray(-1).astype(np.intp)
        t = np.asanyarray(np.asanyarray(vi - lo), dtype=np.asanyarray(vi).dtype).reshape(1)
        positions += [int(lo) % n, int(hi) % n]
        weights += [t[0], (1 - t)[0]]
    return tuple(positions), tuple(weights)


def _keys(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 keys of float32 values (NaN the largest)."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    k = torch.where(u >= 2**31, u ^ 0xFFFFFFFF, u | 2**31)
    return torch.where(torch.isnan(x), 0xFFFFFFFF, k)


def _values(k: torch.Tensor) -> torch.Tensor:
    u = torch.where(k >= 2**31, k & 0x7FFFFFFF, k ^ 0xFFFFFFFF)
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(torch.float32)


def _lerp(a, b, t, omt):
    """numpy's `_lerp` in float32, each operation rounded alone."""
    diff = b - a
    return torch.where(t >= 0.5, b - diff * omt, a + diff * t)


def _stretch_plain(img: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    cs, h, w = img.shape
    x = img.to(torch.float32).reshape(cs, h * w)
    (lo1, hi1, lo99, hi99), (t1, omt1, t99, omt99) = percentile_plan(h * w)
    v = _values(torch.sort(_keys(x), dim=1).values[:, [lo1, hi1, lo99, hi99]])
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=x.device)
    p1 = _lerp(v[:, 0], v[:, 1], f32(t1), f32(omt1))
    p99 = _lerp(v[:, 2], v[:, 3], f32(t99), f32(omt99))
    nan = torch.isnan(x).any(1)
    p1 = torch.where(nan, f32(float("nan")), p1)
    p99 = torch.where(nan, f32(float("nan")), p99)
    span = p99 - p1
    den = torch.where((span >= f32(_EPS)) | torch.isnan(span), span, f32(_EPS))
    r = (x - p1[:, None]) / den[:, None]
    # np.clip(r, 0, 1) as numpy computes it: NaN stays NaN, -0 becomes +0
    r = torch.where(torch.isnan(r) | (r > 0), r, 0.0)
    r = torch.where(torch.isnan(r) | (r < 1), r, 1.0).reshape(cs, h, w)
    r = torch.cat([r] + [r[-1:]] * (3 - cs))
    r = F.pad(r[None], (0, wp - w, 0, hp - h), mode="replicate")[0]
    return r.permute(1, 2, 0)


def percentile_stretch_plain(images: Sequence[torch.Tensor], hp: int, wp: int) -> torch.Tensor:
    """Plain PyTorch version of `percentile_stretch`: an exact selection by
    sorting each plane's keys, then the same float32 arithmetic."""
    _check(images, hp, wp)
    return torch.stack([_stretch_plain(img, hp, wp) for img in images]).contiguous()


def _check(images: Sequence[torch.Tensor], hp: int, wp: int) -> None:
    if not images:
        raise ValueError("percentile_stretch needs at least one image")
    for img in images:
        if img.dim() != 3 or not 1 <= img.shape[0] <= 3:
            raise ValueError(f"expected (C, h, w) with C of 1-3, got shape {tuple(img.shape)}")
        if not (1 <= img.shape[1] <= hp and 1 <= img.shape[2] <= wp):
            raise ValueError(f"image {tuple(img.shape)} does not fit the batch's ({hp}, {wp})")
        if img.dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype {img.dtype}: float64, float32 or uint16")
        if img.device != images[0].device:
            raise ValueError("the images lie on different devices")


@functools.cache
def _library() -> ctypes.CDLL:
    from .._build import load_kernel_library

    lib = load_kernel_library("percentile_stretch").lib
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.amt_percentile_stretch.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.amt_percentile_stretch.restype = i
    return lib


def _bits(t: np.float32, omt: np.float32) -> int:
    """(t, 1 - t) as one int64: the float32 bits of t low, of 1 - t high."""
    return int(np.float32(t).view(np.uint32)) | int(np.float32(omt).view(np.uint32)) << 32


def percentile_stretch(images: Sequence[torch.Tensor], hp: int, wp: int) -> torch.Tensor:
    """(C, h, w) images on one device (C of 1-3; float64, float32 or uint16;
    h <= hp, w <= wp) -> the (N, hp, wp, 3) float32 batch of their 1-99
    percentile stretch, channels replicated to 3 and edges padded."""
    _check(images, hp, wp)
    dev = images[0].device
    if dev.type == "cpu":
        return percentile_stretch_plain(images, hp, wp)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(img.is_contiguous() for img in images):
        raise ValueError("the CUDA kernel takes contiguous images")
    # the kernel's tables (csrc/percentile_stretch.cu): per plane its pointer,
    # values, dtype, four positions and the two (t, 1 - t); per image its
    # pointer, dtype, channels, h, w and first plane
    planes, rows = [], []
    for img in images:
        cs, h, w = img.shape
        positions, (t1, omt1, t99, omt99) = percentile_plan(h * w)
        code = _DTYPES[img.dtype]
        rows.append([img.data_ptr(), code, cs, h, w, len(planes)])
        planes += [[img.data_ptr() + c * h * w * img.element_size(), h * w, code, *positions,
                    _bits(t1, omt1), _bits(t99, omt99)] for c in range(cs)]
    p, b = len(planes), len(images)
    if p > 65535 or b > 65535:
        raise ValueError(f"{b} images of {p} planes exceed the kernel grid")
    # from pinned memory, so the copy does not wait for the stream's earlier work
    table = torch.tensor([v for row in planes + rows for v in row], dtype=torch.int64)
    table = table.pin_memory().to(dev, non_blocking=True)
    hist = torch.zeros((3, p, _RANKS, _BINS), dtype=torch.int32, device=dev)
    state = torch.empty((p, _RANKS, 2), dtype=torch.int32, device=dev)
    params = torch.empty((p, 2), dtype=torch.float32, device=dev)
    out = torch.empty((b, hp, wp, 3), dtype=torch.float32, device=dev)
    # enough blocks for four per SM over all planes, none with under 16
    # values a thread
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    most = max(img.shape[1] * img.shape[2] for img in images)
    blocks = max(1, min(-(-most // (_THREADS * 16)), -(-4 * sms // p)))
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.amt_percentile_stretch(
            table.data_ptr(), table.data_ptr() + p * len(planes[0]) * table.element_size(),
            hist.data_ptr(), state.data_ptr(), params.data_ptr(), out.data_ptr(), p, b, hp, wp,
            blocks, cuda_stream(out))
    check_launch(err, "percentile_stretch")
    launch_counts["percentile_stretch"] += 1
    return out
