"""Image filters over the last two axes: Gaussian and difference of
Gaussians, windowed means, median and rank filters, grey morphology and the
rolling-ball background.

Counterpart of `arcadia_microscopy_tools_tpu/ops/filters.py`. The reference
expresses each Gaussian pass as a dense banded-Toeplitz matmul to fill the
TPU's matrix unit; here each pass is a float32 1-D convolution over padding
built by `_pad_last2`. Rank filters with windows over 9 select through the
hand-written CUDA kernel of `ops/rank_cuda.py` on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "to_float",
    "centre_on_midrange",
    "gaussian_filter",
    "gaussian_radius",
    "gaussian_valid",
    "difference_of_gaussians",
    "box_filter",
    "window_mean_std",
    "median_filter",
    "rank_filter",
    "grey_erosion",
    "grey_dilation",
    "grey_opening",
    "rolling_ball_background",
    "subtract_background_rolling_ball",
]

# scipy boundary modes (the reference maps them onto jnp.pad modes)
PAD_MODES = ("nearest", "reflect", "mirror", "constant", "wrap")


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


def _pad_index(n: int, pad: int, mode: str, device) -> torch.Tensor:
    """Source index of each of the n + 2 * pad padded positions along one
    axis, for any pad width: reflections repeat with their period, as
    `jnp.pad` / `np.pad` do (`F.pad(mode="reflect")` is numpy's mirror, has
    no symmetric mode and refuses pads wider than the axis)."""
    i = torch.arange(-pad, n + pad, device=device)
    if mode == "nearest":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    if mode == "reflect":  # the edge sample repeats: period 2n
        p = i % (2 * n)
        return torch.where(p < n, p, 2 * n - 1 - p)
    # "mirror": the edge sample does not repeat: period 2n - 2
    if n == 1:
        return torch.zeros_like(i)
    p = i % (2 * n - 2)
    return torch.where(p < n, p, 2 * n - 2 - p)


def _pad_last2(
    x: torch.Tensor, pad_h: int, pad_w: int, mode: str, cval: float = 0.0
) -> torch.Tensor:
    """Pad the last two axes by scipy boundary `mode` (an index map for the
    reflective modes, a fill for "constant")."""
    if mode not in PAD_MODES:
        raise ValueError(f"unknown boundary mode {mode!r}; expected one of {PAD_MODES}")
    if mode == "constant":
        return F.pad(x, (pad_w, pad_w, pad_h, pad_h), value=cval)
    h, w = x.shape[-2:]
    rows = _pad_index(h, pad_h, mode, x.device)
    cols = _pad_index(w, pad_w, mode, x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


def _gaussian_kernel_1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Sampled, normalized 1-D Gaussian (matches scipy.ndimage.gaussian_filter1d)."""
    radius = gaussian_radius(sigma, truncate)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    kernel = np.exp(-0.5 * (x / float(sigma)) ** 2)
    kernel /= kernel.sum()
    return kernel.astype(np.float32)


def gaussian_filter(
    x: torch.Tensor,
    sigma: float,
    mode: str = "nearest",
    truncate: float = 4.0,
    cval: float = 0.0,
) -> torch.Tensor:
    """2-D Gaussian blur over the last two axes, batched over the rest.

    Matches `scipy.ndimage.gaussian_filter` in float32 for the five scipy
    boundary modes.
    """
    x = x.to(torch.float32)
    if sigma <= 0:
        return x
    radius = gaussian_radius(sigma, truncate)
    return gaussian_valid(_pad_last2(x, radius, radius, mode, cval), sigma, truncate)


def gaussian_radius(sigma: float, truncate: float = 4.0) -> int:
    """Half-width of the sampled Gaussian kernel (scipy's radius)."""
    return int(truncate * float(sigma) + 0.5)


def gaussian_valid(padded: torch.Tensor, sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """The Gaussian over the last two axes of float32 `padded`, already
    padded by `gaussian_radius` on each side, cropped to the pixels whose
    window lies inside it: (..., H - 2r, W - 2r). A row slab padded with its
    neighbours' rows gives the same bits as those rows of the whole image's
    result (the spatially sharded plate program relies on it)."""
    kernel = torch.from_numpy(_gaussian_kernel_1d(sigma, truncate)).to(padded.device)
    radius = (kernel.numel() - 1) // 2
    lead = padded.shape[:-2]
    hp, wp = padded.shape[-2:]
    y = padded.reshape(-1, 1, hp, wp)
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
    return y.reshape(*lead, hp - 2 * radius, wp - 2 * radius)


def difference_of_gaussians(
    x: torch.Tensor,
    low_sigma: float,
    high_sigma: float,
    mode: str = "nearest",
    truncate: float = 4.0,
) -> torch.Tensor:
    """Band-pass difference of Gaussians over the last two axes
    (`skimage.filters.difference_of_gaussians` semantics).

    Each image is first centred on its midrange when the mode preserves
    constants (all but "constant"): both kernels are normalized, so the
    centring leaves the DoG unchanged in real arithmetic, and min/max are
    exact, so a constant image centres to exactly zero and its DoG is
    exactly zero.
    """
    img = to_float(x)
    if mode != "constant":
        flat = img.reshape(*img.shape[:-2], -1)
        img = centre_on_midrange(img, flat.amin(-1), flat.amax(-1))
    low = gaussian_filter(img, low_sigma, mode=mode, truncate=truncate)
    high = gaussian_filter(img, high_sigma, mode=mode, truncate=truncate)
    return low - high


def centre_on_midrange(img: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """`img` minus the midrange of each image, from its minimum and maximum
    over the last two axes (the DoG's first step)."""
    return img - ((lo + hi) * 0.5)[..., None, None]


# -- windowed statistics -------------------------------------------------------------


def _box_sum_last2(x: torch.Tensor, window: int, mode: str = "reflect") -> torch.Tensor:
    """Windowed sum over a (window x window) neighbourhood by per-axis
    sliding cumsum differences; `window` must be odd.

    Not one 2-D summed-area table: a full table of x^2 at 2048^2 reaches
    ~1e12, where float32's spacing is ~65536, and the 4-corner difference
    then loses up to ~19% of a window variance. Differencing after each
    axis keeps every intermediate at row magnitude.
    """
    if window % 2 != 1:
        raise ValueError(f"window must be odd, got {window}")
    r = window // 2
    padded = _pad_last2(x.to(torch.float32), r + 1, r + 1, mode)
    h, w = x.shape[-2:]
    c1 = torch.cumsum(padded, -1)
    rows = c1[..., window : window + w] - c1[..., :w]
    c2 = torch.cumsum(rows, -2)
    return c2[..., window : window + h, :] - c2[..., :h, :]


def box_filter(x: torch.Tensor, window: int, mode: str = "reflect") -> torch.Tensor:
    """Windowed mean over a (window x window) neighbourhood."""
    return _box_sum_last2(x, window, mode) / float(window * window)


def window_mean_std(
    x: torch.Tensor, window: int, mode: str = "mirror"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Windowed mean and population standard deviation, float32 (skimage's
    `_mean_std`, whose np.pad(mode="reflect") is scipy's "mirror")."""
    x = x.to(torch.float32)
    n = float(window * window)
    mean = _box_sum_last2(x, window, mode) / n
    var = (_box_sum_last2(x * x, window, mode) / n - mean * mean).clamp_min(0.0)
    return mean, torch.sqrt(var)


# -- rank filters ----------------------------------------------------------------------

# Largest window served by the sort over all window^2 stacked views; beyond
# it those views dominate memory (window 33 at 2048^2 would hold 1089
# full-image copies) and the selection kernel takes over.
_SMALL_WINDOW_LIMIT = 9


def _window_stack(x: torch.Tensor, window: int, mode: str = "reflect") -> torch.Tensor:
    """All window^2 shifted views stacked on a new leading axis, in
    row-major offset order."""
    r = window // 2
    padded = _pad_last2(x, r, r, mode)
    h, w = x.shape[-2:]
    return torch.stack(
        [padded[..., dy : dy + h, dx : dx + w] for dy in range(window) for dx in range(window)]
    )


def _small_window_sorted(x: torch.Tensor, window: int, mode: str) -> torch.Tensor:
    # stable, so equal values (-0.0 and +0.0 among them) keep their view
    # order, as the reference's jnp.sort does
    stack = _window_stack(x.to(torch.float32), window, mode)
    return torch.sort(stack, dim=0, stable=True).values


def _rank_select_large(
    x: torch.Tensor, ranks: tuple[int, ...], window: int, mode: str
) -> torch.Tensor:
    """Exact order statistics for windows over 9: the CUDA kernel on the
    card, its plain version on the CPU. Returns (len(ranks), ..., H, W)."""
    from .rank_cuda import rank_select

    return rank_select(x.to(torch.float32), window, ranks, mode)


def median_filter(x: torch.Tensor, window: int = 3, mode: str = "reflect") -> torch.Tensor:
    """Median over a (window x window) neighbourhood, float32; an even
    window averages its two middle values.

    Windows up to 9 sort the stacked window views; larger windows select
    exactly, in the order of the values' int32 keys (-0.0 below +0.0), as
    the reference's Pallas kernel does.
    """
    k = window * window
    if window <= _SMALL_WINDOW_LIMIT:
        srt = _small_window_sorted(x, window, mode)
        if k % 2 == 1:
            return srt[k // 2]
        return 0.5 * (srt[k // 2 - 1] + srt[k // 2])
    ranks = (k // 2,) if k % 2 == 1 else (k // 2 - 1, k // 2)
    sel = _rank_select_large(x, ranks, window, mode)
    if k % 2 == 1:
        return sel[0]
    return 0.5 * (sel[0] + sel[1])


def rank_filter(x: torch.Tensor, rank: int, window: int = 3, mode: str = "reflect") -> torch.Tensor:
    """Rank filter (rank 0 = minimum, window^2 - 1 = maximum), any window."""
    if window <= _SMALL_WINDOW_LIMIT:
        return _small_window_sorted(x, window, mode)[rank]
    return _rank_select_large(x, (rank,), window, mode)[0]


# -- grey morphology and background estimation ---------------------------------------------


def _window_reduce(x: torch.Tensor, window: int, largest: bool) -> torch.Tensor:
    """Windowed min or max over edge-replicated padding of window // 2 on
    each side (scipy's grey morphology with mode "nearest"), as two 1-D
    passes. As in the reference's VALID reduce-window, an even window gives
    one row and one column more than the image."""
    r = window // 2
    padded = _pad_last2(x, r, r, "nearest")
    rows = padded.unfold(-2, window, 1)
    rows = rows.amax(-1) if largest else rows.amin(-1)
    cols = rows.unfold(-1, window, 1)
    return cols.amax(-1) if largest else cols.amin(-1)


def grey_erosion(x: torch.Tensor, window: int) -> torch.Tensor:
    """Flat grey erosion (windowed min) with edge replication."""
    return _window_reduce(x.to(torch.float32), window, largest=False)


def grey_dilation(x: torch.Tensor, window: int) -> torch.Tensor:
    """Flat grey dilation (windowed max) with edge replication."""
    return _window_reduce(x.to(torch.float32), window, largest=True)


def grey_opening(x: torch.Tensor, window: int) -> torch.Tensor:
    """Flat grey opening: erosion then dilation."""
    return grey_dilation(grey_erosion(x, window), window)


def _parabola_erode_1d(x: torch.Tensor, radius: int, curvature: float, axis: int) -> torch.Tensor:
    """min over k in [-radius, radius] of x[i + k] + curvature * k^2 along
    `axis` (-2 or -1), edges replicated."""
    n = x.shape[axis]
    pads = (radius, 0) if axis == -2 else (0, radius)
    padded = _pad_last2(x, *pads, "nearest")
    out = x
    for k in range(-radius, radius + 1):
        if k == 0:
            continue
        shifted = padded.narrow(axis, radius + k, n) + np.float32(curvature * (k * k))
        out = torch.minimum(out, shifted)
    return out


def _parabola_dilate_1d(x: torch.Tensor, radius: int, curvature: float, axis: int) -> torch.Tensor:
    return -_parabola_erode_1d(-x, radius, curvature, axis)


def _sphere_offsets(radius: int) -> tuple[np.ndarray, np.ndarray]:
    """(offsets, heights) of the spherical structuring element: (n, 2)
    top-left-relative slice starts into a radius-padded image, and the ball
    profile sqrt(r^2 - d^2) at each tap with d <= r."""
    yy, xx = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    d2 = yy * yy + xx * xx
    inside = (d2 <= radius * radius).ravel()
    heights = np.sqrt(np.clip(radius * radius - d2, 0, None)).astype(np.float32)
    offsets = np.stack(
        [(yy.ravel() + radius)[inside], (xx.ravel() + radius)[inside]], axis=1
    ).astype(np.int32)
    return offsets, heights.ravel()[inside]


def _sphere_opening(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Grey opening with the exact spherical element over the last two
    axes: e(q) = min_s (img(q+s) - K(s)), then b(p) = max_s (e(p+s) + K(s)),
    K(s) = sqrt(r^2 - |s|^2), edges replicated; one pass per tap."""
    offsets, heights = _sphere_offsets(radius)
    h, w = img.shape[-2:]

    def pass_(src, combine, sign):
        padded = _pad_last2(src, radius, radius, "nearest")
        out = None
        for (oy, ox), kv in zip(offsets.tolist(), heights.tolist()):
            win = padded[..., oy : oy + h, ox : ox + w] + np.float32(sign * kv)
            out = win if out is None else combine(out, win)
        return out

    return pass_(pass_(img, torch.minimum, -1.0), torch.maximum, 1.0)


def rolling_ball_background(
    x: torch.Tensor, radius: int = 50, kernel: str = "paraboloid"
) -> torch.Tensor:
    """Smooth background by a rolling-ball opening (everywhere <= the
    image).

    - "paraboloid": the ball replaced by a paraboloid of revolution of apex
      curvature 1 / (2 * radius), separable into four 1-D parabolic passes;
    - "sphere": the exact spherical profile sqrt(r^2 - d^2), one pass per
      tap of the ball's support.
    """
    if kernel not in ("paraboloid", "sphere"):
        raise ValueError(
            f"Unknown rolling-ball kernel: {kernel!r}. "
            "Supported kernels: 'paraboloid', 'sphere'."
        )
    img = x.to(torch.float32)
    if kernel == "sphere":
        return _sphere_opening(img, radius)
    curvature = 1.0 / (2.0 * float(radius))
    er = _parabola_erode_1d(img, radius, curvature, axis=-2)
    er = _parabola_erode_1d(er, radius, curvature, axis=-1)
    di = _parabola_dilate_1d(er, radius, curvature, axis=-2)
    return _parabola_dilate_1d(di, radius, curvature, axis=-1)


def subtract_background_rolling_ball(
    x: torch.Tensor, radius: int = 50, kernel: str = "paraboloid"
) -> torch.Tensor:
    """The image minus its rolling-ball background, clipped at zero."""
    img = x.to(torch.float32)
    return (img - rolling_ball_background(img, radius, kernel)).clamp_min(0.0)
