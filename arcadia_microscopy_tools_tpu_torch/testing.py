"""Synthetic plate, tile and timelapse data for tests and the on-card smoke
run."""

from __future__ import annotations

import numpy as np

__all__ = ["noise_tiles", "serpentine", "synthetic_timelapse", "synthetic_wells"]


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


def noise_tiles(n: int, h: int, seed: int = 0) -> np.ndarray:
    """(n, h, h) uint16 tiles of uniform noise in [0, 4000): the input of
    the repository's preprocessing benchmark (`bench.py`, BASELINE config
    2), made from `seed` with numpy."""
    rng = np.random.default_rng(seed)
    return (rng.random((n, h, h)) * 4000).astype(np.uint16)


def synthetic_timelapse(n_frames: int, h: int, blobs_per_frame: int = 120, seed: int = 0) -> np.ndarray:
    """(n_frames, h, h) uint16 frames of the repository's timelapse
    benchmark (`bench.py`, BASELINE config 3): noise N(400, 40) and 32x32
    blobs of peak 2500 at random centres, made from `seed` with numpy."""
    rng = np.random.default_rng(seed)
    base = rng.normal(400, 40, (n_frames, h, h)).clip(0, None)
    yy, xx = np.mgrid[0:32, 0:32]
    blob = 2500 * np.exp(-((yy - 16) ** 2 + (xx - 16) ** 2) / 24.0)
    for f in range(n_frames):
        for _ in range(blobs_per_frame):
            cy, cx = rng.integers(16, h - 16), rng.integers(16, h - 16)
            base[f, cy - 16 : cy + 16, cx - 16 : cx + 16] += blob
    return base.astype(np.uint16)
