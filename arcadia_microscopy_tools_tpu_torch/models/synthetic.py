"""Synthetic cell-image generation for training and testing.

A copy of the JAX package's `models/synthetic.py` (numpy and scipy only),
with its own copy of `fixture_stats.json`.

Generates random-ellipse "cells" with realistic intensity structure (bright
rims / graded interiors, background noise, illumination gradients) plus their
ground-truth label images - the same style of analytic fixture the reference
uses for mask tests (test_masks.py:14-30), extended to training data for the
flow-predicting U-Net.
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthesize_cells", "synthesize_cells_like", "load_fixture_stats"]


def load_fixture_stats() -> dict:
    """Acquisition statistics harvested from the five real golden ND2
    fixtures (tools/harvest_fixture_stats.py -> fixture_stats.json):
    background level, robust noise sigma, illumination gradient amplitude,
    signed cell contrast, radius distribution, and an autocorrelation-based
    PSF proxy, each measured on the same normalized frame the segmentation
    paths consume (foreground from the adjudicated U-Net golden masks)."""
    import json
    from pathlib import Path

    return json.loads(
        (Path(__file__).parent / "fixture_stats.json").read_text()
    )


def synthesize_cells_like(
    rng: np.random.Generator,
    stats: dict,
    shape: tuple[int, int] = (256, 256),
    jitter: float = 0.25,
) -> tuple[np.ndarray, np.ndarray]:
    """`synthesize_cells` with parameters matched to one harvested fixture
    record (see `load_fixture_stats`), so training batches reproduce real
    acquisition physics - the low-contrast brightfield/DIC regime
    (|contrast| 0.03-0.06 of full scale on the real fixtures, vs 1.0 in the
    default synthetic regime) is exactly where a synthetically-trained net
    otherwise never sees a realistic sample. `jitter` scales multiplicative
    spread applied to each harvested statistic so one fixture seeds a
    distribution, not a point."""

    def j(v, lo=None, hi=None):
        out = float(v) * float(rng.uniform(1 - jitter, 1 + jitter))
        if lo is not None:
            out = max(lo, out)
        if hi is not None:
            out = min(hi, out)
        return out

    r_mean = max(3.0, float(stats["cell_radius_mean"]))
    r_std = float(stats.get("cell_radius_std", 0.0))
    r_lo = max(2.5, r_mean - max(r_std, 0.15 * r_mean))
    r_hi = r_mean + max(r_std, 0.15 * r_mean)
    area = shape[0] * shape[1]
    n_cells = max(
        1,
        int(round(j(stats["fg_fraction"], 0.005, 0.5) * area / (np.pi * r_mean**2))),
    )
    # the PSF proxy bundles optics + cell softness; half of it as Gaussian
    # sigma reproduces the measured autocorrelation lobe width closely
    blur = max(0.0, j(stats["acorr_hwhm_px"]) * 0.5 - 0.5)
    return synthesize_cells(
        rng,
        shape=shape,
        n_cells=n_cells,
        radius_range=(r_lo, r_hi),
        noise=j(stats["noise"], 0.002, 0.2),
        gradient=j(stats["gradient"], 0.0, 0.4),
        cell_contrast=j(abs(stats["contrast"]), 0.015, 1.0),
        background_level=j(stats["background_level"], 0.0, 0.85),
        invert=bool(stats["inverted"]),
        blur_sigma=blur,
        shot_noise=0.02 if stats["background_level"] < 0.05 else 0.0,
        edge_cells=True,
    )


def _gaussian_blur(image: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur (host-side; training-data generation only)."""
    from scipy.ndimage import gaussian_filter1d

    out = gaussian_filter1d(image, sigma, axis=0, mode="nearest", truncate=3.0)
    return gaussian_filter1d(out, sigma, axis=1, mode="nearest", truncate=3.0)


def synthesize_cells(
    rng: np.random.Generator,
    shape: tuple[int, int] = (256, 256),
    n_cells: int = 24,
    radius_range: tuple[float, float] = (8.0, 18.0),
    eccentricity_max: float = 0.6,
    noise: float = 0.05,
    separation: float = 0.9,
    gradient: float = 0.1,
    cell_contrast: float = 1.0,
    background_level: float = 0.0,
    invert: bool = False,
    blur_sigma: float = 0.0,
    shot_noise: float = 0.0,
    membrane_only: float = 0.0,
    edge_cells: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Generate one synthetic image and its label mask.

    Args:
        separation: Minimum center distance as a fraction of the radius sum.
            0.9 (default) keeps cells mostly apart; ~0.6 produces heavily
            touching clusters (the hard case for instance segmentation).
        gradient: Total illumination-gradient amplitude across the frame.
        cell_contrast: Multiplier on the cell intensity profile relative to
            background; small values (0.1-0.3) emulate faint fluorescence.
        background_level: Constant background offset (real cameras never
            read zero).
        invert: Dark cells on a bright field (brightfield/phase contrast
            polarity) instead of bright-on-dark fluorescence.
        blur_sigma: Gaussian PSF blur in pixels applied to the clean image
            before noise (optical defocus / diffraction).
        shot_noise: Poisson shot-noise strength; 0 disables. Emulates photon
            statistics at an effective full-well of ~(1/shot_noise)^2 counts.
        edge_cells: Allow cell centers near (even slightly beyond) the frame
            border, producing partially-clipped cells - real fields of view
            always cut cells at the edge; training only on fully-interior
            cells makes the net ignore them.
        membrane_only: 0 (default) = filled cells; 1 = pure membrane stain -
            only the cell BOUNDARY is bright and interiors sit at background
            (confluent epithelium labeled at the membrane, e.g. the
            example-zstack.nd2 golden fixture). Intermediate values blend.
            Intensity-thresholding such images segments the membrane
            skeleton, not the cells; the flow path must learn to fill the
            enclosed regions.

    Returns:
        (image float32 (H, W) in [0, 1], labels int32 (H, W)).
    """
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    labels = np.zeros(shape, dtype=np.int32)
    image = np.zeros(shape, dtype=np.float64)

    placed = 0
    attempts = 0
    centers: list[tuple[float, float, float]] = []
    while placed < n_cells and attempts < n_cells * 30:
        attempts += 1
        r = rng.uniform(*radius_range)
        if edge_cells:
            cy = rng.uniform(-0.3 * r, h + 0.3 * r)
            cx = rng.uniform(-0.3 * r, w + 0.3 * r)
        else:
            cy = rng.uniform(r + 2, h - r - 2)
            cx = rng.uniform(r + 2, w - r - 2)
        if any(
            (cy - oy) ** 2 + (cx - ox) ** 2 < (separation * (r + orr)) ** 2
            for oy, ox, orr in centers
        ):
            continue
        centers.append((cy, cx, r))
        ecc = rng.uniform(0, eccentricity_max)
        b = r * np.sqrt(1 - ecc**2)
        theta = rng.uniform(0, np.pi)
        ct, st = np.cos(theta), np.sin(theta)
        yr = (yy - cy) * ct - (xx - cx) * st
        xr = (yy - cy) * st + (xx - cx) * ct
        d = (yr / r) ** 2 + (xr / b) ** 2
        inside = d <= 1.0
        new = inside & (labels == 0)
        placed += 1
        labels[new] = placed
        # graded interior + bright rim; membrane_only fades the interior
        # out and boosts the rim (pure membrane stain at 1.0)
        interior = 0.55 + 0.25 * np.exp(-3 * d)
        rim = 0.3 * np.exp(-((1 - d) * 4) ** 2)
        shade = (1.0 - membrane_only) * interior + rim * (1.0 + 1.5 * membrane_only)
        profile = np.where(inside, shade, 0.0)
        image = np.where(new, profile, image)

    if invert:
        # bright field with darker cells: field level sits above the cells by
        # the requested contrast
        field = background_level + cell_contrast
        image = field - cell_contrast * image
    else:
        image = background_level + cell_contrast * image

    if blur_sigma > 0:
        image = _gaussian_blur(image, blur_sigma)

    # illumination gradient + sensor noise (shot noise scales with signal)
    gx, gy = rng.uniform(0.3, 0.7), rng.uniform(0.3, 0.7)
    ramp = gradient * (gx * (xx / w) + gy * (yy / h))
    image = image + ramp
    if shot_noise > 0:
        image = image + rng.normal(0, 1, shape) * shot_noise * np.sqrt(
            np.clip(image, 0, None)
        )
    image = image + rng.normal(0, noise, shape)
    image = np.clip(image, 0, 1).astype(np.float32)

    # compact labels (cells fully overwritten by later ones would leave gaps)
    unique = np.unique(labels)
    unique = unique[unique > 0]
    remap = np.zeros(labels.max() + 1, dtype=np.int32)
    remap[unique] = np.arange(1, len(unique) + 1)
    return image, remap[labels]
