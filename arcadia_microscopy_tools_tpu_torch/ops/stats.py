"""Order statistics and histograms.

Counterpart of `arcadia_microscopy_tools_tpu/ops/stats.py`. The reference
builds its 65536-bin histogram as a one-hot bf16 matmul to keep the TPU's
matrix unit busy; here `torch.bincount` computes the same exact counts.
Percentiles and the float histogram sort the flattened input, as the
reference does.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "counts_from_sorted",
    "histogram_float",
    "histogram_int",
    "integer_bin_count",
    "percentile",
]


def percentile(x: torch.Tensor, q) -> torch.Tensor:
    """Percentile(s) `q` of all elements with linear interpolation
    (np.percentile's default), in float32, rounded as the reference's
    compiled `jnp.percentile` rounds: XLA folds q / 100 * (n - 1) into
    q * float32(float32(0.01) * float32(n - 1)) and contracts the
    interpolation into fma(high, frac, low * (1 - frac)). Within an ulp of
    np.percentile; any NaN gives NaN."""
    flat = x.reshape(-1).to(torch.float32)
    s = torch.sort(flat).values
    n = flat.numel()
    scale = np.float32(0.01) * (np.float32(n) - np.float32(1))
    pos = torch.as_tensor(q, dtype=torch.float32, device=x.device) * float(scale)
    low, high = torch.floor(pos), torch.ceil(pos)
    hi_w = pos - low
    lo_w = 1 - hi_w
    low_v = s[low.clamp(0, n - 1).long()]
    high_v = s[high.clamp(0, n - 1).long()]
    # the fused multiply-add in float64: the product is exact there
    out = (high_v.double() * hi_w.double() + (low_v * lo_w).double()).to(torch.float32)
    return torch.where(torch.isnan(s[-1]), torch.nan, out)


def counts_from_sorted(flat_sorted: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Histogram counts from a sorted flat tensor and bin edges: bin i
    counts values in [edges[i], edges[i+1]), the last bin closed on the
    right (np.histogram's convention)."""
    idx = torch.searchsorted(flat_sorted, edges)
    counts = torch.diff(idx)
    n_at_top = flat_sorted.numel() - torch.searchsorted(flat_sorted, edges[-1:])
    counts[-1:] += n_at_top
    return counts


def histogram_float(x: torch.Tensor, nbins: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """nbins uniform bins over [min, max] of all elements (skimage's float
    histogram). Returns (counts float32, bin centres float32)."""
    flat = torch.sort(x.reshape(-1).to(torch.float32)).values
    lo, hi = flat[0], flat[-1]
    span = torch.where(hi > lo, hi - lo, 1.0)
    edges = lo + span * torch.arange(nbins + 1, dtype=torch.float32, device=x.device) / nbins
    counts = counts_from_sorted(flat, edges)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return counts.to(torch.float32), centers


def histogram_int(x: torch.Tensor, n_values: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact per-integer-value histogram over [0, n_values).

    All elements of `x` count into one histogram; values outside the range
    are dropped.

    Returns:
        (counts[n_values] int64, centers[n_values] float32) - centers are the
        integer values themselves.
    """
    flat = x.reshape(-1).to(torch.int64)
    # out-of-range values land in one extra bin that is cut off (no host sync)
    flat = torch.where((flat >= 0) & (flat < n_values), flat, n_values)
    counts = torch.bincount(flat, minlength=n_values + 1)[:n_values]
    centers = torch.arange(n_values, dtype=torch.float32, device=x.device)
    return counts, centers


_TORCH_TO_NUMPY = {
    torch.bool: np.bool_,
    torch.uint8: np.uint8,
    torch.int8: np.int8,
    torch.uint16: np.uint16,
    torch.int16: np.int16,
    torch.int32: np.int32,
    torch.int64: np.int64,
}


def integer_bin_count(dtype) -> int | None:
    """Number of per-integer histogram bins for a numpy or torch dtype
    (None for floats and wide integers)."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH_TO_NUMPY:
            return None
        dtype = _TORCH_TO_NUMPY[dtype]
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return 2
    if dt.kind in "ui":
        # signed images are non-negative in practice; wide types take the
        # float path
        return int(np.iinfo(dt).max) + 1 if np.iinfo(dt).bits <= 16 else None
    return None
