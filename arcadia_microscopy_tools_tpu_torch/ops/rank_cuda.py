"""Exact window rank selection: the CUDA kernel and its plain version.

Counterpart of `arcadia_microscopy_tools_tpu/ops/rank_pallas.py`. For each
pixel of a batch of float32 images and each of one or two ranks k, the k-th
smallest value of its (window x window) neighbourhood, the image padded by
a scipy boundary mode. Values are ordered by their int32 keys
(`float_to_key`), so -0.0 sorts below +0.0, as in the Pallas kernel; the
result is an element of the window, bit for bit.

For CUDA tensors `rank_select` launches the hand-written kernel of
`csrc/rank_select.cu`, whatever the window; for CPU tensors it runs the
plain PyTorch version, a strip-by-strip sort of the keys, which the tests
and `chip_smoke.py` hold the kernel against bit for bit. There is no
fallback: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._build import check_launch, cuda_stream
from .filters import _pad_last2

__all__ = [
    "float_to_key",
    "key_to_float",
    "rank_select",
    "rank_select_plain",
    "launch_counts",
    "reset_launch_counts",
]

# kernel launches per wrapper; only a launch of the CUDA kernel counts
launch_counts = {"rank_select": 0}

# elements of the stacked window views the plain version sorts at once
_PLAIN_CHUNK = 1 << 26


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def float_to_key(x: torch.Tensor) -> torch.Tensor:
    """Order-isomorphic int32 key of each float32 value (an involution on
    the raw bits: negative values have their magnitude bits flipped)."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def key_to_float(key: torch.Tensor) -> torch.Tensor:
    return torch.where(key < 0, key ^ 0x7FFFFFFF, key).view(torch.float32)


def _check(x: torch.Tensor, window: int, ranks: tuple[int, ...]) -> None:
    if x.dim() < 2:
        raise ValueError(f"expected (..., H, W) images, got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"images must be float32, got {x.dtype}")
    if window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if not 1 <= len(ranks) <= 2:
        raise ValueError(f"one or two ranks per call, got {len(ranks)}")
    for k in ranks:
        if not 0 <= k < window * window:
            raise ValueError(f"rank {k} outside [0, {window * window})")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _select_plain(padded: torch.Tensor, window: int, ranks: tuple[int, ...]) -> torch.Tensor:
    """Plain version on padded images (N, H + 2r, W + 2r): per image, strips
    of rows whose window^2 stacked keys are sorted at once."""
    r = window // 2
    n, hp, wp = padded.shape
    h, w = hp - 2 * r, wp - 2 * r
    keys = float_to_key(padded)
    out = torch.empty((len(ranks), n, h, w), dtype=torch.int32, device=padded.device)
    strip = max(1, min(h, _PLAIN_CHUNK // (window * window * max(w, 1))))
    for i in range(n):
        for y0 in range(0, h, strip):
            rows = min(strip, h - y0)
            seg = keys[i, y0 : y0 + rows + window - 1, : w + window - 1]
            views = seg.unfold(0, window, 1).unfold(1, window, 1).reshape(rows, w, -1)
            srt = torch.sort(views, dim=-1).values
            for j, k in enumerate(ranks):
                out[j, i, y0 : y0 + rows] = srt[..., k]
    return key_to_float(out)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (pointers and
    the stream as void*, sizes as int)."""
    from .._build import load_kernel_library

    lib = load_kernel_library("rank_select").lib
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.amt_rank_select.argtypes = [vp, vp, i, i, i, i, i, i, i, vp]
    lib.amt_rank_select.restype = i
    return lib


def _padded_batch(x: torch.Tensor, window: int, mode: str) -> torch.Tensor:
    h, w = x.shape[-2:]
    r = window // 2
    return _pad_last2(x.reshape(-1, h, w), r, r, mode).contiguous()


def rank_select_plain(
    x: torch.Tensor, window: int, ranks: tuple[int, ...], mode: str = "reflect"
) -> torch.Tensor:
    """Plain PyTorch version of `rank_select` (the same keys, the same
    padding), on any device."""
    ranks = tuple(int(k) for k in ranks)
    _check(x, window, ranks)
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    out = _select_plain(_padded_batch(x, window, mode), window, ranks)
    return out.reshape(len(ranks), *lead, h, w)


def rank_select(
    x: torch.Tensor, window: int, ranks: tuple[int, ...], mode: str = "reflect"
) -> torch.Tensor:
    """Exact k-th order statistics over each (window x window)
    neighbourhood of float32 images (..., H, W), padded by the scipy
    boundary `mode`.

    Returns (len(ranks), ..., H, W) float32. One launch serves the whole
    batch and both ranks of an even-window median.
    """
    ranks = tuple(int(k) for k in ranks)
    _check(x, window, ranks)
    if x.device.type == "cpu":
        return rank_select_plain(x, window, ranks, mode)
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    padded = _padded_batch(x, window, mode)
    n = padded.shape[0]
    if n > 65535:
        raise ValueError(f"batch of {n} images exceeds the kernel grid")
    out = torch.empty((len(ranks), n, h, w), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out.reshape(len(ranks), *lead, h, w)
    k1 = ranks[-1]
    with torch.cuda.device(x.device):
        err = _library().amt_rank_select(
            padded.data_ptr(), out.data_ptr(), n, h, w, window, len(ranks), ranks[0], k1,
            cuda_stream(padded),
        )
    check_launch(err, "rank_select")
    launch_counts["rank_select"] += 1
    return out.reshape(len(ranks), *lead, h, w)
