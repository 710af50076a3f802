"""Classical segmentation frontend: DoG -> percentile rescale -> threshold,
with the rescale and the threshold both served by one histogram.

Counterpart of `arcadia_microscopy_tools_tpu/ops/fused.py`, split in two so
that each half can be held against the reference on its own:

- `quantize_dog` computes the DoG and quantizes it to 65536 levels across
  each image's data range, returning (q0, mn, mx);
- `mask_from_q0` builds the integer histogram of q0, reads the two
  percentiles from its cumulative sum, pushes the histogram forward through
  the monotone rescale, thresholds it, and pulls the threshold back to one
  comparison against q0. It is split at its histogram
  (`q0_histograms`, then `cutoff_from_hist`) so that the row slabs of a
  spatially sharded image can add their counts before the decision
  (`parallel/plate.py`).

All functions take a batch of images (B, H, W).
"""

from __future__ import annotations

import math

import torch

from .filters import difference_of_gaussians
from .stats import histogram_int
from .threshold import (
    isodata_from_hist,
    mean_from_hist,
    minimum_from_hist,
    otsu_from_hist,
    triangle_from_hist,
    yen_from_hist,
)

__all__ = [
    "fused_classical_mask",
    "quantize_dog",
    "quantize",
    "q0_histograms",
    "cutoff_from_hist",
    "mask_from_q0",
    "HIST_THRESHOLD_METHODS",
]

_BINS = 65536

HIST_THRESHOLD_METHODS = {
    "otsu": otsu_from_hist,
    "isodata": isodata_from_hist,
    "yen": yen_from_hist,
    "triangle": triangle_from_hist,
    "minimum": minimum_from_hist,
    "mean": mean_from_hist,
}


def _check_method(method: str) -> None:
    if method not in HIST_THRESHOLD_METHODS:
        supported = ", ".join(HIST_THRESHOLD_METHODS)
        raise ValueError(
            f"fused_classical_mask supports histogram thresholds ({supported}); "
            f"got {method!r}"
        )


def _order_statistic(cum: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Value of the k-th (0-indexed) order statistic from a cumulative
    histogram over the last axis: the smallest bin whose cumulative count
    exceeds k."""
    return (cum < k[..., None] + 1.0).to(torch.float32).sum(-1)


def _percentile_from_cum(cum: torch.Tensor, q: float, n: int) -> torch.Tensor:
    """np.percentile('linear') for integer-binned data, from the cumsum.

    The position is computed in Python float64 (in float32, 0.5% of 4M
    would round and pick the wrong order statistic); the interpolation is
    float32, as in the reference.
    """
    pos = q / 100.0 * (n - 1)
    k_i = math.floor(pos)
    frac = torch.tensor(pos - k_i, dtype=torch.float32)
    lead = cum.shape[:-1]
    k0 = torch.full(lead, float(k_i), dtype=torch.float32, device=cum.device)
    k1 = torch.full(lead, float(min(k_i + 1, n - 1)), dtype=torch.float32, device=cum.device)
    v0 = _order_statistic(cum, k0)
    v1 = _order_statistic(cum, k1)
    return v0 + frac.to(cum.device) * (v1 - v0)


def quantize_dog(
    intensities: torch.Tensor, low_sigma: float = 1.0, high_sigma: float = 16.0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DoG of each image quantized to 65536 levels over its own range.

    Returns:
        (q0 int32 (B, H, W) in [0, 65535], mn (B,), mx (B,)) - the DoG's
        per-image float32 minimum and maximum.
    """
    dog = difference_of_gaussians(intensities, low_sigma, high_sigma)
    flat = dog.reshape(dog.shape[0], -1)
    mn = flat.amin(-1)
    mx = flat.amax(-1)
    return quantize(dog, mn, mx), mn, mx


def quantize(dog: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """(B, H, W) DoG values -> int32 levels in [0, 65535] over each image's
    [mn, mx] (the image's range, which a row slab takes from all slabs)."""
    step = (mx - mn).clamp_min(1e-30) / 65535.0
    q0 = torch.floor((dog - mn[:, None, None]) / step[:, None, None])
    return q0.clamp(0.0, 65535.0).to(torch.int32)


def q0_histograms(q0: torch.Tensor) -> torch.Tensor:
    """(B, 65536) int64 counts of each image's levels."""
    return torch.stack([histogram_int(q, _BINS)[0] for q in q0])


def cutoff_from_hist(
    counts: torch.Tensor,
    n: int,
    mn: torch.Tensor,
    mx: torch.Tensor,
    percentile_range: tuple[float, float] = (0.5, 99.9),
    method: str = "otsu",
) -> torch.Tensor:
    """The level c0 (B,) such that `q0 > c0` is the foreground, from the
    (B, 65536) level counts of images of `n` pixels.

    The percentile rescale is a monotone clip, so the rescaled histogram is
    the pushforward of q0's histogram and the mask `rescaled > t` is one
    comparison of q0 against the largest original bin that maps at or below
    t. Constant images (a DoG range below a relative 1e-7: a constant source
    can carry ~1e-8 of filter rounding rather than an exactly equal field)
    give 65535, an all-False mask.
    """
    _check_method(method)
    b = counts.shape[0]
    dev = counts.device
    cum = torch.cumsum(counts, -1).to(torch.float32)  # exact: n < 2^24

    p1 = _percentile_from_cum(cum, float(percentile_range[0]), n)
    p2 = _percentile_from_cum(cum, float(percentile_range[1]), n)
    scale = torch.where(p2 > p1, 65535.0 / (p2 - p1).clamp_min(1e-30), 0.0)

    # pushforward: rescaled-quantized value of each original bin
    i = torch.arange(_BINS, dtype=torch.float32, device=dev)
    j = torch.floor(((i - p1[:, None]) * scale[:, None]).clamp(0.0, 65535.0))
    hist2 = torch.zeros((b, _BINS), dtype=torch.int64, device=dev)
    hist2.scatter_add_(1, j.to(torch.int64), counts)

    t2 = HIST_THRESHOLD_METHODS[method](hist2, i)

    # pull the threshold back: largest original bin whose image is <= t2
    c0 = (j <= t2[:, None]).sum(-1) - 1
    tol = 1e-7 * torch.maximum(mn.abs(), mx.abs()).clamp_min(1.0)
    return torch.where((mx - mn) > tol, c0, _BINS - 1)


def mask_from_q0(
    q0: torch.Tensor,
    mn: torch.Tensor,
    mx: torch.Tensor,
    percentile_range: tuple[float, float] = (0.5, 99.9),
    method: str = "otsu",
) -> torch.Tensor:
    """Foreground mask (B, H, W) from quantized DoG images: `q0 > c0` with
    c0 from `cutoff_from_hist` on the images' own level counts. Constant
    images give an all-False mask."""
    _, h, w = q0.shape
    c0 = cutoff_from_hist(q0_histograms(q0), h * w, mn, mx, percentile_range, method)
    return q0 > c0[:, None, None]


def fused_classical_mask(
    intensities: torch.Tensor,
    low_sigma: float = 1.0,
    high_sigma: float = 16.0,
    percentile_range: tuple[float, float] = (0.5, 99.9),
    method: str = "otsu",
) -> torch.Tensor:
    """Boolean foreground mask via DoG -> percentile rescale -> threshold.

    Args:
        intensities: (H, W) or (B, H, W) image(s), uint16 or float.
        low_sigma / high_sigma: DoG band-pass sigmas.
        percentile_range: rescale percentiles.
        method: any of HIST_THRESHOLD_METHODS.

    Returns:
        Boolean mask of the input's shape.
    """
    _check_method(method)
    single = intensities.dim() == 2
    batch = intensities[None] if single else intensities
    q0, mn, mx = quantize_dog(batch, low_sigma, high_sigma)
    mask = mask_from_q0(q0, mn, mx, percentile_range, method)
    return mask[0] if single else mask
