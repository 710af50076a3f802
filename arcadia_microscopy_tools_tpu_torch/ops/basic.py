"""Core preprocessing operations: percentile contrast stretch,
difference-of-Gaussians background subtraction and centre crop.

Counterpart of `arcadia_microscopy_tools_tpu/ops/basic.py`. Percentiles are
global over the whole input, as in the reference; a `Pipeline` with
`parallel=True` applies them per frame.
"""

from __future__ import annotations

import torch

from .filters import difference_of_gaussians
from .stats import percentile as _percentile

__all__ = ["rescale_by_percentile", "subtract_background_dog", "crop_to_center"]


def rescale_by_percentile(
    intensities: torch.Tensor,
    percentile_range: tuple[float, float] = (0, 100),
    out_range: tuple[float, float] = (0, 1),
) -> torch.Tensor:
    """Map the intensities between two percentiles linearly onto
    `out_range`, clipping outside them; float32.

    Constant images map to out_range[0] and empty images give zeros. The
    constant check uses a relative epsilon (a span below 1e-7 of the data
    magnitude): filtered float images of a constant source carry rounding
    noise of ~1e-8, far beneath one uint16 count (1.5e-5 in [0, 1] units).
    """
    if not (0 <= percentile_range[0] < percentile_range[1] <= 100):
        raise ValueError(
            f"Invalid percentile range: {percentile_range}. "
            f"Values must be in ascending order between 0 and 100."
        )
    if intensities.numel() == 0:
        return torch.zeros(intensities.shape, dtype=torch.float32, device=intensities.device)
    xf = intensities.to(torch.float32)
    p = _percentile(xf, [float(percentile_range[0]), float(percentile_range[1])])
    p1, p2 = p[0], p[1]
    o1, o2 = float(out_range[0]), float(out_range[1])
    clipped = torch.minimum(torch.maximum(xf, p1), p2)
    scale = torch.where(p2 > p1, (o2 - o1) / (p2 - p1).clamp_min(1e-30), 0.0)
    rescaled = (clipped - p1) * scale + o1
    mn, mx = xf.amin(), xf.amax()
    tol = 1e-7 * torch.maximum(mn.abs(), mx.abs()).clamp_min(1.0)
    return torch.where((mx - mn) <= tol, o1, rescaled)


def subtract_background_dog(
    intensities: torch.Tensor,
    low_sigma: float = 0.6,
    high_sigma: float = 16.0,
    percentile: float = 0,
) -> torch.Tensor:
    """Difference-of-Gaussians band pass of the image converted to float
    (uint16 / 65535), minus its `percentile`-th percentile, negatives
    clipped to zero; float32."""
    if not (0 <= percentile <= 100):
        raise ValueError(f"Percentile must be between 0 and 100, got {percentile}")
    if low_sigma >= high_sigma:
        raise ValueError(
            f"low_sigma ({low_sigma}) must be smaller than high_sigma ({high_sigma})"
        )
    dog = difference_of_gaussians(intensities, low_sigma, high_sigma)
    return (dog - _percentile(dog, float(percentile))).clamp_min(0.0)


def crop_to_center(intensities, output_shape: tuple[int, int]):
    """Centre-crop the last two axes to `output_shape` (a view; any sliceable
    array)."""
    height, width = intensities.shape[-2:]
    crop_height = min(height, output_shape[0])
    crop_width = min(width, output_shape[1])
    top = (height - crop_height) // 2
    left = (width - crop_width) // 2
    return intensities[..., top : top + crop_height, left : left + crop_width]
