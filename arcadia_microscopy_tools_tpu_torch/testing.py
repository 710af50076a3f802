"""Synthetic plate data for tests and the on-card smoke run."""

from __future__ import annotations

import numpy as np

__all__ = ["serpentine", "synthetic_wells"]


def synthetic_wells(
    n_wells: int, n_channels: int, h: int, w: int, blobs_per_well: int, seed: int = 0
) -> np.ndarray:
    """(n_wells, n_channels, h, w) uint16 wells of Gaussian cell-like blobs
    on a noisy background, made from `seed` with numpy.

    The recipe of the repository's 2048^2 4-channel plate benchmark: noise
    N(150, 15), 48x48 blobs of peak 2800 at random centres, channel 0 at
    full brightness and the others scaled by U(0.2, 1) per blob.
    """
    rng = np.random.default_rng(seed)
    base = rng.normal(150, 15, (n_wells, n_channels, h, w)).clip(0, None)
    yy, xx = np.mgrid[0:48, 0:48]
    blob = 2800 * np.exp(-((yy - 24) ** 2 + (xx - 24) ** 2) / 40.0)
    for b in range(n_wells):
        for _ in range(blobs_per_well):
            cy, cx = rng.integers(24, h - 24), rng.integers(24, w - 24)
            base[b, 0, cy - 24 : cy + 24, cx - 24 : cx + 24] += blob
            for ch in range(1, n_channels):
                base[b, ch, cy - 24 : cy + 24, cx - 24 : cx + 24] += blob * rng.uniform(0.2, 1)
    return base.astype(np.uint16)


def serpentine(fill: np.ndarray) -> np.ndarray:
    """A copy of the (H, W) bool mask `fill` (H, W >= 128) whose tile (0, 0)
    holds one snaking component: every other row of the tile, joined at
    alternating ends - a path of ~8K pixels, far beyond the 256 sweeps a
    tile of the connected-components kernels may take."""
    m = fill.copy()
    m[:128, :128] = False
    m[0:128:2, :128] = True
    for k, r in enumerate(range(1, 127, 2)):
        m[r, 127 if k % 2 == 0 else 0] = True
    return m
