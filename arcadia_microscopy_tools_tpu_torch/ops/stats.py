"""Exact integer histograms.

Counterpart of `arcadia_microscopy_tools_tpu/ops/stats.py`. The reference
builds its 65536-bin histogram as a one-hot bf16 matmul to keep the TPU's
matrix unit busy; here `torch.bincount` computes the same exact counts.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["histogram_int", "integer_bin_count"]


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


def integer_bin_count(dtype) -> int | None:
    """Number of per-integer histogram bins for a dtype (None for floats)."""
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return 2
    if dt.kind in "ui":
        # signed images are non-negative in practice; wide types take the
        # float path
        return int(np.iinfo(dt).max) + 1 if np.iinfo(dt).bits <= 16 else None
    return None
