"""Global histogram thresholds.

Counterpart of the histogram methods in
`arcadia_microscopy_tools_tpu/ops/threshold.py` (otsu, isodata, yen,
triangle, minimum) plus the histogram mean of `ops/fused.py`. Every method
takes exact counts and bin centers over the last axis - leading axes are a
batch - and returns one threshold per histogram. The arithmetic runs in
float64: counts times centers stay exact integers up to 2^53, so the
cumulative sums are exact and ties between bins are exact ties (the first
bin wins, as in the reference).
"""

from __future__ import annotations

import torch

__all__ = [
    "otsu_from_hist",
    "isodata_from_hist",
    "yen_from_hist",
    "triangle_from_hist",
    "minimum_from_hist",
    "mean_from_hist",
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
