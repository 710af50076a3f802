"""Image operations facade (the JAX package's `operations.py`).

    from arcadia_microscopy_tools_tpu_torch.operations import (
        rescale_by_percentile, subtract_background_dog,
        crop_to_center, apply_threshold,
    )

Tensors in -> tensors out on their own device. NumPy in -> NumPy out, with
floating results widened to float64 (the reference's output dtype); NumPy
input runs on `device=`, the CUDA card unless the caller names another.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .ops import basic as _basic
from .ops import threshold as _threshold
from .utils import resolve_device

__all__ = [
    "apply_threshold",
    "crop_to_center",
    "rescale_by_percentile",
    "subtract_background_dog",
]


def _host_boundary(fn):
    """NumPy in -> NumPy out (float64 for floating results) through a copy
    on the device; tensors pass through untouched."""

    @functools.wraps(fn)
    def wrapper(intensities, *args, device=None, **kwargs):
        if not isinstance(intensities, np.ndarray):
            return fn(intensities, *args, **kwargs)
        x = torch.tensor(intensities, device=resolve_device(device))
        host = fn(x, *args, **kwargs).cpu().numpy()
        if np.issubdtype(host.dtype, np.floating):
            host = host.astype(np.float64)
        return host

    return wrapper


rescale_by_percentile = _host_boundary(_basic.rescale_by_percentile)
subtract_background_dog = _host_boundary(_basic.subtract_background_dog)
crop_to_center = _basic.crop_to_center
apply_threshold = _host_boundary(_threshold.apply_threshold)
