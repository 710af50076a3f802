"""Gaussian and difference-of-Gaussians filters.

Counterpart of `gaussian_filter` / `difference_of_gaussians` in
`arcadia_microscopy_tools_tpu/ops/filters.py`. The reference expresses each
separable pass as a dense banded-Toeplitz matmul to fill the TPU's matrix
unit; here each pass is a float32 1-D convolution over edge-replicated
("nearest") padding. Only the "nearest" boundary mode is ported so far.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["to_float", "gaussian_filter", "difference_of_gaussians"]


def to_float(x: torch.Tensor) -> torch.Tensor:
    """float32 image following skimage's `img_as_float` contract: unsigned
    integers scale to [0, 1] by the dtype max, signed integers by the dtype
    range, floats and bools pass through as float32."""
    if x.dtype.is_floating_point or x.dtype == torch.bool:
        return x.to(torch.float32)
    info = torch.iinfo(x.dtype)
    if info.min == 0:
        return x.to(torch.float32) / float(info.max)
    return x.to(torch.float32) / float(info.max + 1)


def _gaussian_kernel_1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Sampled, normalized 1-D Gaussian (matches scipy.ndimage.gaussian_filter1d)."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    kernel = np.exp(-0.5 * (x / float(sigma)) ** 2)
    kernel /= kernel.sum()
    return kernel.astype(np.float32)


def gaussian_filter(
    x: torch.Tensor, sigma: float, mode: str = "nearest", truncate: float = 4.0
) -> torch.Tensor:
    """2-D Gaussian blur over the last two axes, batched over the rest.

    Matches `scipy.ndimage.gaussian_filter` in float32 for mode "nearest".
    """
    if mode != "nearest":
        raise NotImplementedError(
            f"gaussian_filter mode {mode!r}: only 'nearest' is ported (see ROADMAP.md)"
        )
    x = x.to(torch.float32)
    if sigma <= 0:
        return x
    kernel = torch.from_numpy(_gaussian_kernel_1d(sigma, truncate)).to(x.device)
    radius = (kernel.numel() - 1) // 2
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    y = x.reshape(-1, 1, h, w)
    y = F.pad(y, (radius, radius, radius, radius), mode="replicate")
    # cuDNN runs float32 convolutions in TF32 by default (about three
    # decimal digits); the scoped flag keeps both passes in full float32.
    cudnn = torch.backends.cudnn
    with cudnn.flags(
        enabled=cudnn.enabled,
        benchmark=cudnn.benchmark,
        deterministic=cudnn.deterministic,
        allow_tf32=False,
    ):
        y = F.conv2d(y, kernel.view(1, 1, -1, 1))
        y = F.conv2d(y, kernel.view(1, 1, 1, -1))
    return y.reshape(*lead, h, w)


def difference_of_gaussians(
    x: torch.Tensor,
    low_sigma: float,
    high_sigma: float,
    mode: str = "nearest",
    truncate: float = 4.0,
) -> torch.Tensor:
    """Band-pass difference of Gaussians over the last two axes
    (`skimage.filters.difference_of_gaussians` semantics).

    Each image is first centred on its midrange: both kernels are
    normalized, so the centring leaves the DoG unchanged in real arithmetic,
    and min/max are exact, so a constant image centres to exactly zero and
    its DoG is exactly zero.
    """
    img = to_float(x)
    flat = img.reshape(*img.shape[:-2], -1)
    mid = (flat.amin(-1) + flat.amax(-1)) * 0.5
    img = img - mid[..., None, None]
    low = gaussian_filter(img, low_sigma, mode=mode, truncate=truncate)
    high = gaussian_filter(img, high_sigma, mode=mode, truncate=truncate)
    return low - high
