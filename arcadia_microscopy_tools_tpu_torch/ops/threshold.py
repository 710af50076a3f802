"""Thresholds: histogram methods, image-level global thresholds, local
threshold images and `apply_threshold`.

Counterpart of `arcadia_microscopy_tools_tpu/ops/threshold.py` plus the
histogram mean of `ops/fused.py`. Every `*_from_hist` method takes exact
counts and bin centers over the last axis - leading axes are a batch - and
returns one threshold per histogram. The arithmetic runs in float64: counts
times centers stay exact integers up to 2^53, so the cumulative sums are
exact and ties between bins are exact ties (the first bin wins, as in the
reference). The image-level `threshold_*` functions take one threshold over
all elements of their input, as the reference's do.
"""

from __future__ import annotations

import torch

from .filters import box_filter, gaussian_filter, median_filter, window_mean_std
from .stats import histogram_float, histogram_int, integer_bin_count

__all__ = [
    "otsu_from_hist",
    "isodata_from_hist",
    "yen_from_hist",
    "triangle_from_hist",
    "minimum_from_hist",
    "mean_from_hist",
    "GLOBAL_METHODS",
    "LOCAL_METHODS",
    "apply_threshold",
    "threshold_otsu",
    "threshold_isodata",
    "threshold_yen",
    "threshold_li",
    "threshold_mean",
    "threshold_minimum",
    "threshold_triangle",
    "threshold_local",
    "threshold_niblack",
    "threshold_sauvola",
]

_NEG_INF = float("-inf")


def _rcumsum(x: torch.Tensor) -> torch.Tensor:
    """Reversed cumulative sum over the last axis (sum over bins j >= i)."""
    return torch.flip(torch.cumsum(torch.flip(x, (-1,)), -1), (-1,))


def _first_true(x: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when there is none)."""
    return torch.argmax(x.to(torch.uint8), dim=-1)


def _pick(centers: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """centers[..., idx] for a batch of indices."""
    expanded = centers.expand(idx.shape + centers.shape[-1:])
    return torch.gather(expanded, -1, idx[..., None])[..., 0]


def _as_f64(counts: torch.Tensor, centers: torch.Tensor):
    return counts.to(torch.float64), centers.to(torch.float64)


def _occupied_range_masks(counts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Masks of the bins at-or-after the first nonzero count and at-or-before
    the last nonzero count (skimage trims its histogram to the data range)."""
    nonzero = (counts > 0).to(torch.int64)
    after_first = torch.cumsum(nonzero, -1) > 0
    before_last = _rcumsum(nonzero) > 0
    return after_first, before_last


def otsu_from_hist(counts: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Otsu's method: the split maximising the between-class variance.

    m2[i] is the mean over bins j >= i (a reversed cumulative sum), as in
    the reference."""
    c, x = _as_f64(counts, centers)
    w1 = torch.cumsum(c, -1)
    w2 = _rcumsum(c)
    csum = torch.cumsum(c * x, -1)
    csum2 = _rcumsum(c * x)
    m1 = torch.where(w1 > 0, csum / w1.clamp_min(1e-30), 0.0)
    m2 = torch.where(w2 > 0, csum2 / w2.clamp_min(1e-30), 0.0)
    var12 = w1[..., :-1] * w2[..., 1:] * (m1[..., :-1] - m2[..., 1:]) ** 2
    valid = (w1[..., :-1] > 0) & (w2[..., 1:] > 0)
    var12 = torch.where(valid, var12, _NEG_INF)
    return _pick(centers, torch.argmax(var12, dim=-1))


def isodata_from_hist(counts: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """ISODATA (Ridler-Calvard): the first bin midway between the means of
    the two classes it induces."""
    c, x = _as_f64(counts, centers)
    csuml = torch.cumsum(c, -1)
    csumh = csuml[..., -1:] - csuml
    csum_i = torch.cumsum(c * x, -1)
    total_i = csum_i[..., -1:]
    nan = float("nan")
    lower = torch.where(
        csuml[..., :-1] > 0, csum_i[..., :-1] / csuml[..., :-1].clamp_min(1e-30), nan
    )
    higher = torch.where(
        csumh[..., :-1] > 0,
        (total_i - csum_i[..., :-1]) / csumh[..., :-1].clamp_min(1e-30),
        nan,
    )
    all_mean = (lower + higher) / 2.0
    bin_width = x[..., 1:2] - x[..., 0:1]
    distances = all_mean - x[..., :-1]
    ok = (distances >= 0) & (distances < bin_width)
    return _pick(centers, _first_true(ok))


def yen_from_hist(counts: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Yen's maximum correlation criterion."""
    c, _ = _as_f64(counts, centers)
    pmf = c / c.sum(-1, keepdim=True).clamp_min(1.0)
    p1 = torch.cumsum(pmf, -1)
    p1_sq = torch.cumsum(pmf * pmf, -1)
    p2_sq = _rcumsum(pmf * pmf)
    a = p1_sq[..., :-1]
    b = p2_sq[..., 1:]
    cc = p1[..., :-1] * (1.0 - p1[..., :-1])
    valid = (a > 0) & (b > 0)
    ratio = (cc * cc).clamp_min(1e-38) / (a * b).clamp_min(1e-38)
    crit = torch.where(valid, torch.log(ratio), _NEG_INF)
    return _pick(centers, torch.argmax(crit, dim=-1))


def triangle_from_hist(counts: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Triangle algorithm (Zack et al.): the bin farthest from the line
    between the histogram peak and the far end of the occupied range."""
    c, _ = _as_f64(counts, centers)
    nbins = c.shape[-1]
    idxs = torch.arange(nbins, dtype=torch.float64, device=c.device)
    after_first, before_last = _occupied_range_masks(counts)
    arg_low = _first_true(after_first)
    arg_high = nbins - 1 - _first_true(torch.flip(before_last, (-1,)))
    arg_peak = torch.argmax(c, dim=-1)
    peak_height = torch.gather(c, -1, arg_peak[..., None])[..., 0]

    # flip so the long tail is always on the left of the peak
    flip = (arg_peak - arg_low) < (arg_high - arg_peak)
    f_counts = torch.where(flip[..., None], torch.flip(c, (-1,)), c)
    f_low = torch.where(flip, nbins - 1 - arg_high, arg_low)
    f_peak = torch.where(flip, nbins - 1 - arg_peak, arg_peak)

    width = (f_peak - f_low).to(torch.float64).clamp_min(1.0)
    norm = torch.sqrt(peak_height**2 + width**2)
    ph = (peak_height / norm)[..., None]
    wd = (width / norm)[..., None]
    x1 = idxs - f_low[..., None].to(torch.float64)
    mask = (idxs >= f_low[..., None]) & (idxs < f_peak[..., None])
    length = torch.where(mask, ph * x1 - wd * f_counts, _NEG_INF)
    arg_level = torch.argmax(length, dim=-1)
    arg_level = torch.where(flip, nbins - 1 - arg_level, arg_level)
    return _pick(centers, arg_level)


def _count_maxima(hist: torch.Tensor) -> torch.Tensor:
    """skimage's up/down walk for histogram maxima over the last axis: a
    maximum is a downward step whose last nonzero slope before it was
    upward (the walk starts upward)."""
    s = torch.sign(torch.diff(hist, dim=-1))
    pos = torch.arange(s.shape[-1], device=s.device)
    last_nz = torch.cummax(torch.where(s != 0, pos, -1), dim=-1).values
    carried = torch.where(last_nz >= 0, torch.gather(s, -1, last_nz.clamp_min(0)), 0.0)
    prev_dir = torch.cat([torch.ones_like(carried[..., :1]), carried[..., :-1]], -1)
    prev_dir = torch.where(prev_dir == 0, 1.0, prev_dir)
    return (s < 0) & (prev_dir > 0)


_MIN_MAX_ITERS = 10000
_MIN_CHUNK = 64  # smoothing steps evaluated per host check


def _minimum_one(counts: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    hist = counts.to(torch.float64)
    it = 0
    # smooth with a length-3 running mean (edge-padded) until at most two
    # maxima remain; chunks of steps are evaluated together and the first
    # qualifying step is kept, so the result equals a step-by-step loop
    while True:
        steps = [hist]
        for _ in range(min(_MIN_CHUNK, _MIN_MAX_ITERS - it)):
            h = steps[-1]
            padded = torch.cat([h[:1], h, h[-1:]])
            steps.append((padded[:-2] + padded[1:-1] + padded[2:]) / 3.0)
        stack = torch.stack(steps)
        done = _count_maxima(stack).sum(-1) <= 2
        done[-1] = True
        first = int(_first_true(done))
        if first < len(steps) - 1 or it + first >= _MIN_MAX_ITERS:
            hist = stack[first]
            break
        hist = stack[-1]
        it += len(steps) - 1

    maxima = _count_maxima(hist)
    idxs = torch.arange(hist.shape[-1] - 1, device=hist.device)
    first_max = _first_true(maxima)
    second_max = _first_true(maxima & (idxs > first_max))
    between = (idxs >= first_max) & (idxs <= second_max)
    masked = torch.where(between, hist[:-1], float("inf"))
    return centers[torch.argmin(masked)]


def minimum_from_hist(counts: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Minimum method: smooth until the histogram has two maxima, then take
    the lowest bin between them."""
    lead = counts.shape[:-1]
    flat = counts.reshape(-1, counts.shape[-1])
    out = [_minimum_one(row, centers) for row in flat]
    return torch.stack(out).reshape(lead) if out else centers.new_zeros(lead)


def mean_from_hist(counts: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Mean of the histogrammed values."""
    c, x = _as_f64(counts, centers)
    return (c * x).sum(-1) / c.sum(-1).clamp_min(1.0)


# -- image-level global thresholds ----------------------------------------------------


def _histogram_for(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One per-integer histogram for integer images, 256 bins over
    [min, max] for float images."""
    n = integer_bin_count(x.dtype)
    if n is not None:
        return histogram_int(x, n)
    return histogram_float(x, 256)


def threshold_otsu(x: torch.Tensor) -> torch.Tensor:
    return otsu_from_hist(*_histogram_for(x))


def threshold_isodata(x: torch.Tensor) -> torch.Tensor:
    return isodata_from_hist(*_histogram_for(x))


def threshold_yen(x: torch.Tensor) -> torch.Tensor:
    return yen_from_hist(*_histogram_for(x))


def threshold_triangle(x: torch.Tensor) -> torch.Tensor:
    return triangle_from_hist(*_histogram_for(x))


def threshold_minimum(x: torch.Tensor) -> torch.Tensor:
    return minimum_from_hist(*_histogram_for(x))


def threshold_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of all pixel values (skimage.filters.threshold_mean), float32."""
    return x.to(torch.float32).mean()


def threshold_li(x: torch.Tensor, tolerance_hint: float | None = None) -> torch.Tensor:
    """Li's minimum cross-entropy threshold, skimage's fixed-point
    iteration: from the image mean, split at t and recompute
    t = (m_b - m_f) / (ln m_b - ln m_f) until the update is at most the
    tolerance (half the smallest gap between distinct values, 0.5 when all
    values are equal). float32 like the reference; the class sums are
    accumulated in float64. One host read per iteration."""
    vals = x.reshape(-1).to(torch.float32)
    offset = vals.min()
    vals = vals - offset  # non-negative, as skimage makes them
    if tolerance_hint is not None:
        tol = torch.tensor(tolerance_hint, dtype=torch.float32, device=x.device)
    else:
        d = torch.diff(torch.sort(vals).values)
        min_gap = torch.where(d > 0, d, torch.inf).min() if d.numel() else vals.new_tensor(torch.inf)
        tol = torch.where(torch.isfinite(min_gap), min_gap / 2.0, 0.5)
    total = vals.to(torch.float64).sum()
    n = vals.numel()

    def step(t_curr: torch.Tensor) -> torch.Tensor:
        fg = vals > t_curr
        n_fg = fg.sum()
        sum_fg = torch.where(fg, vals, 0.0).to(torch.float64).sum()
        mean_fg = (sum_fg / n_fg.clamp_min(1)).to(torch.float32)
        mean_bg = ((total - sum_fg) / (n - n_fg).clamp_min(1)).to(torch.float32)
        denom = torch.log(mean_bg.clamp_min(1e-30)) - torch.log(mean_fg.clamp_min(1e-30))
        return torch.where(denom.abs() > 1e-30, (mean_bg - mean_fg) / denom, t_curr)

    t_curr = (total / n).to(torch.float32)
    t_next = step(t_curr)
    while bool((t_next - t_curr).abs() > tol):
        t_curr, t_next = t_next, step(t_next)
    return t_next + offset


# -- local threshold images ------------------------------------------------------------


def threshold_local(
    x: torch.Tensor,
    block_size: int = 3,
    method: str = "gaussian",
    offset: float = 0.0,
    param=None,
) -> torch.Tensor:
    """Adaptive threshold image (skimage.filters.threshold_local): the
    image filtered over a block_size window by "gaussian" (sigma =
    (block_size - 1) / 6 unless `param`), "mean" or "median", minus
    `offset`; boundary mode "reflect"."""
    if block_size % 2 != 1:
        raise ValueError(f"block_size must be odd, got {block_size}")
    img = x.to(torch.float32)
    if method == "gaussian":
        sigma = param if param is not None else (block_size - 1) / 6.0
        filtered = gaussian_filter(img, float(sigma), mode="reflect")
    elif method == "mean":
        filtered = box_filter(img, block_size, mode="reflect")
    elif method == "median":
        filtered = median_filter(img, block_size, mode="reflect")
    else:
        raise ValueError(f"Unsupported local threshold method: {method!r}")
    return filtered - offset


def threshold_niblack(x: torch.Tensor, window_size: int = 15, k: float = 0.2) -> torch.Tensor:
    """Niblack threshold image: mean - k * std over the window."""
    mean, std = window_mean_std(x.to(torch.float32), window_size)
    return mean - k * std


def _sauvola_r(dtype: torch.dtype) -> float:
    """Dynamic range of the standard deviation: half the integer dtype's
    range, 1 for floats (skimage's dtype limits (-1, 1))."""
    if dtype.is_floating_point or dtype == torch.bool:
        return 1.0
    info = torch.iinfo(dtype)
    return 0.5 * (info.max - info.min)


def threshold_sauvola(
    x: torch.Tensor, window_size: int = 15, k: float = 0.2, r: float | None = None
) -> torch.Tensor:
    """Sauvola threshold image: mean * (1 + k * (std / r - 1))."""
    if r is None:
        r = _sauvola_r(x.dtype)
    mean, std = window_mean_std(x.to(torch.float32), window_size)
    return mean * (1.0 + k * ((std / r) - 1.0))


GLOBAL_METHODS = {
    "otsu": threshold_otsu,
    "li": threshold_li,
    "yen": threshold_yen,
    "isodata": threshold_isodata,
    "mean": threshold_mean,
    "minimum": threshold_minimum,
    "triangle": threshold_triangle,
}

LOCAL_METHODS = {
    "local": threshold_local,
    "niblack": threshold_niblack,
    "sauvola": threshold_sauvola,
}


def apply_threshold(x: torch.Tensor, method: str = "otsu", **kwargs) -> torch.Tensor:
    """Binarize an image with the named method: `x > threshold`, where a
    global method gives one threshold and a local method a threshold image.
    Empty and constant images give an all-False mask."""
    if x.numel() == 0:
        return torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    method_lower = method.lower()
    if method_lower in GLOBAL_METHODS:
        thresh = GLOBAL_METHODS[method_lower](x, **kwargs)
    elif method_lower in LOCAL_METHODS:
        thresh = LOCAL_METHODS[method_lower](x, **kwargs)
    else:
        supported = ", ".join(list(GLOBAL_METHODS) + list(LOCAL_METHODS))
        raise ValueError(
            f"Unsupported thresholding method: '{method}'. Supported methods: {supported}"
        )
    mask = x.to(torch.float32) > torch.as_tensor(thresh, device=x.device).to(torch.float32)
    # constant images -> all False; float64 holds every uint16/float32 value
    # exactly, and CUDA reduces few ops on uint16
    xd = x.to(torch.float64)
    return mask & (xd.amin() != xd.amax())
