"""Binary morphology for mask cleanup.

Counterpart of `arcadia_microscopy_tools_tpu/ops/morphology.py`:
footprint-based erosion, dilation, opening and closing over the last two
axes (one shifted compare per footprint offset), and removal of small
objects and holes over the port's `label`, per image of a batch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .labeling import label

__all__ = [
    "disk",
    "square",
    "binary_erosion",
    "binary_dilation",
    "binary_opening",
    "binary_closing",
    "remove_small_objects",
    "remove_small_holes",
]


def disk(radius: int) -> np.ndarray:
    """Disk-shaped footprint (skimage.morphology.disk convention)."""
    y, x = np.ogrid[-radius : radius + 1, -radius : radius + 1]
    return (x * x + y * y <= radius * radius).astype(bool)


def square(width: int) -> np.ndarray:
    """Square footprint of the given side length."""
    return np.ones((width, width), dtype=bool)


def _footprint_offsets(footprint: np.ndarray) -> list[tuple[int, int]]:
    fp = np.asarray(footprint).astype(bool)
    cy, cx = fp.shape[0] // 2, fp.shape[1] // 2
    ys, xs = np.nonzero(fp)
    return [(int(y - cy), int(x - cx)) for y, x in zip(ys, xs)]


def _shift_fold(x: torch.Tensor, offsets, pad_value: bool, op) -> torch.Tensor:
    h, w = x.shape[-2:]
    max_dy = max((abs(dy) for dy, _ in offsets), default=0)
    max_dx = max((abs(dx) for _, dx in offsets), default=0)
    padded = F.pad(x, (max_dx, max_dx, max_dy, max_dy), value=pad_value)
    out = None
    for dy, dx in offsets:
        shifted = padded[..., max_dy + dy : max_dy + dy + h, max_dx + dx : max_dx + dx + w]
        out = shifted if out is None else op(out, shifted)
    return out


def binary_erosion(mask: torch.Tensor, footprint: np.ndarray | None = None) -> torch.Tensor:
    """A pixel survives only if the whole footprint fits; out-of-image
    neighbours count as foreground (skimage's border convention)."""
    fp = footprint if footprint is not None else disk(1)
    return _shift_fold(mask.to(torch.bool), _footprint_offsets(fp), True, torch.logical_and)


def binary_dilation(mask: torch.Tensor, footprint: np.ndarray | None = None) -> torch.Tensor:
    """A pixel turns on if any footprint neighbour is on; the footprint is
    mirrored (morphological convention) and out-of-image neighbours are
    background."""
    fp = footprint if footprint is not None else disk(1)
    offsets = [(-dy, -dx) for dy, dx in _footprint_offsets(fp)]
    return _shift_fold(mask.to(torch.bool), offsets, False, torch.logical_or)


def binary_opening(mask: torch.Tensor, footprint: np.ndarray | None = None) -> torch.Tensor:
    """Erosion then dilation: removes specks smaller than the footprint."""
    fp = footprint if footprint is not None else disk(1)
    return binary_dilation(binary_erosion(mask, fp), fp)


def binary_closing(mask: torch.Tensor, footprint: np.ndarray | None = None) -> torch.Tensor:
    """Dilation then erosion: fills gaps smaller than the footprint."""
    fp = footprint if footprint is not None else disk(1)
    return binary_erosion(binary_dilation(mask, fp), fp)


def _label_sizes(lbl: torch.Tensor) -> torch.Tensor:
    """Pixel count of each pixel's label, per image of (B, H, W) labels."""
    b = lbl.shape[0]
    flat = lbl.reshape(b, -1).to(torch.int64)
    n = flat.shape[1] + 1  # labels lie in [0, H * W]
    keyed = flat + torch.arange(b, device=lbl.device)[:, None] * n
    counts = torch.bincount(keyed.reshape(-1), minlength=b * n).reshape(b, n)
    return torch.gather(counts, 1, flat).reshape(lbl.shape)


def _batched(mask: torch.Tensor) -> tuple[torch.Tensor, bool]:
    single = mask.dim() == 2
    return (mask[None] if single else mask).to(torch.bool), single


def remove_small_objects(
    mask: torch.Tensor, min_size: int = 64, connectivity: int = 2
) -> torch.Tensor:
    """Remove connected components of fewer than `min_size` pixels from a
    (H, W) or (B, H, W) mask."""
    m, single = _batched(mask)
    lbl = label(m, connectivity)
    out = (lbl > 0) & (_label_sizes(lbl) >= min_size)
    return out[0] if single else out


def remove_small_holes(
    mask: torch.Tensor, area_threshold: int = 64, connectivity: int = 1
) -> torch.Tensor:
    """Fill background components of fewer than `area_threshold` pixels
    that do not touch the image border."""
    m, single = _batched(mask)
    bg = label(~m, connectivity)
    b = bg.shape[0]
    n = bg[0].numel() + 1
    border = torch.cat([bg[:, 0, :], bg[:, -1, :], bg[:, :, 0], bg[:, :, -1]], 1).to(torch.int64)
    outside = torch.zeros((b, n), dtype=torch.bool, device=m.device)
    outside.scatter_(1, border, True)
    touching = torch.gather(outside, 1, bg.reshape(b, -1).to(torch.int64)).reshape(bg.shape)
    out = m | (~m & ~touching & (_label_sizes(bg) < area_threshold))
    return out[0] if single else out
