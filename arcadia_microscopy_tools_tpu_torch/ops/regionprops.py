"""Per-cell measurements of a label image or a foreground-compacted pixel
set.

Counterpart of `measure_labels`, `measure_intensity`,
`measure_intensity_stack` and `measure_compacted` in
`arcadia_microscopy_tools_tpu/ops/regionprops.py`; `measure_compacted` is
batched over images, the other three take one (H, W) label image.
Conventions follow skimage: centroids are coordinate means (row = y,
col = x); axis lengths, eccentricity and orientation come from the central
second moments; perimeter uses skimage's weighted border-pixel categories
evaluated per label; intensity statistics are per-channel mean, max, min
and population std.

The reference accumulates its segment sums through bf16 hi/lo splits on
the TPU's matrix unit. Here the sums are `index_add_` in float64 and every
float result is cast to float32 at the end; minima and maxima are
`scatter_reduce` on the exact float32 values.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .segment_reduce import segment_max, segment_min, segment_sums, table_lookup

__all__ = ["measure_compacted", "measure_intensity", "measure_intensity_stack", "measure_labels"]

_BIG = torch.finfo(torch.float32).max


def _neighbor(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """x shifted so that [.., y, x] holds the (dy, dx) neighbour."""
    h, w = x.shape[-2:]
    padded = F.pad(x, (1, 1, 1, 1), value=fill)
    return padded[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


def _border_map(lbl: torch.Tensor) -> torch.Tensor:
    """Pixels of any label missing at least one same-label 4-neighbour
    (image borders count as background)."""
    fg = lbl > 0
    interior = fg
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        interior = interior & (_neighbor(lbl, dy, dx, -1) == lbl)
    return fg & ~interior


def _perimeter_weight_table(device) -> torch.Tensor:
    """skimage's perimeter weight per border category
    1 + 2 * (same-label border 4-neighbours) + 10 * (diagonal ones)."""
    sqrt2 = math.sqrt(2.0)
    table = torch.zeros(49, dtype=torch.float64)
    table[[5, 7, 15, 17, 25, 27]] = 1.0
    table[[21, 33]] = sqrt2
    table[[13, 23]] = (1.0 + sqrt2) / 2.0
    return table.to(device)


def _perimeter_contribution(lbl: torch.Tensor) -> torch.Tensor:
    """Per-pixel skimage perimeter weight (float64) for (B, H, W) labels
    with background 0; non-border pixels contribute zero."""
    border = _border_map(lbl)

    def neighbor_border_same(dy, dx):
        return (_neighbor(lbl, dy, dx, -1) == lbl) & _neighbor(border, dy, dx, False)

    def count(offsets):
        return sum(neighbor_border_same(dy, dx).to(torch.int64) for dy, dx in offsets)

    n4 = count(((-1, 0), (1, 0), (0, -1), (0, 1)))
    nd = count(((-1, -1), (-1, 1), (1, -1), (1, 1)))
    category = torch.where(border, 1 + 2 * n4 + 10 * nd, 0)
    return _perimeter_weight_table(lbl.device)[category]


def _shape_props(n, s_yy, s_xx, s_xy):
    """Eccentricity / axis lengths / orientation from centred second-moment
    sums (skimage's inertia-tensor conventions)."""
    mu20 = s_yy / n
    mu02 = s_xx / n
    mu11 = s_xy / n
    common = torch.sqrt((4.0 * mu11 * mu11 + (mu20 - mu02) ** 2).clamp_min(0.0))
    lam1 = (mu20 + mu02 + common) / 2.0
    lam2 = ((mu20 + mu02 - common) / 2.0).clamp_min(0.0)
    axis_major = 4.0 * torch.sqrt(lam1.clamp_min(0.0))
    axis_minor = 4.0 * torch.sqrt(lam2)
    eccentricity = torch.where(
        lam1 > 0, torch.sqrt((1.0 - lam2 / lam1.clamp_min(1e-30)).clamp_min(0.0)), 0.0
    )
    a, b, c = mu02, -mu11, mu20
    orientation = torch.where(
        a - c == 0,
        torch.where(b < 0, -math.pi / 4.0, math.pi / 4.0),
        0.5 * torch.atan2(-2.0 * b, c - a),
    )
    return eccentricity, axis_major, axis_minor, orientation


def measure_compacted(
    seg: torch.Tensor,
    idx: torch.Tensor,
    roots_image: torch.Tensor,
    intensity_stack: torch.Tensor,
    max_cells: int,
    width: int,
) -> tuple[dict[str, torch.Tensor], dict[int, dict[str, torch.Tensor]]]:
    """All per-cell properties from a foreground-compacted pixel set.

    Args:
        seg: (B, cap) segment ids from `compaction.compact_by_root`
            (1..N in scan order, 0 = padding); ids above `max_cells` share
            the last slot.
        idx: (B, cap) linear pixel indices, sorted within each segment.
        roots_image: (B, H, W) int32 root image (sentinel H*W on
            background), used for the perimeter categories.
        intensity_stack: (B, C, H, W) intensity channels.
        max_cells: cell slots per image.
        width: image width, to decode idx -> (y, x).

    Unbatched inputs ((cap,), (H, W), (C, H, W)) give unbatched outputs.

    Returns:
        (props, intensity): `props` maps each property name to (B, max_cells)
        values; `intensity` maps channel -> stat -> (B, max_cells).
    """
    single = seg.dim() == 1
    if single:
        seg, idx, roots_image, intensity_stack = (
            seg[None], idx[None], roots_image[None], intensity_stack[None]
        )
    b, cap = seg.shape
    n = roots_image.shape[-2] * roots_image.shape[-1]
    c = intensity_stack.shape[1]
    nseg = max_cells + 1
    dev = seg.device
    f64 = torch.float64

    seg_ids = seg.clamp(0, max_cells).to(torch.int64)
    valid_px = seg > 0
    idx_l = idx.to(torch.int64)

    rl = torch.where(roots_image < n, roots_image + 1, 0)
    perim_w = torch.gather(_perimeter_contribution(rl).reshape(b, n), 1, idx_l)
    chans32 = torch.gather(
        intensity_stack.reshape(b, c, n).to(torch.float32), 2, idx_l[:, None].expand(b, c, cap)
    )
    chans32 = torch.where(valid_px[:, None], chans32, 0.0)
    chans = chans32.to(f64)
    perim_w = torch.where(valid_px, perim_w, 0.0)
    yv = torch.where(valid_px, (idx_l // width).to(f64), 0.0)
    xv = torch.where(valid_px, (idx_l % width).to(f64), 0.0)
    ones = valid_px.to(f64)

    flat_ids = (seg_ids + torch.arange(b, device=dev)[:, None] * nseg).reshape(-1)

    def segment_sum(q: torch.Tensor) -> torch.Tensor:  # (B, Q, cap) -> (B, Q, nseg)
        nq = q.shape[1]
        out = torch.zeros((b * nseg, nq), dtype=q.dtype, device=dev)
        out.index_add_(0, flat_ids, q.permute(0, 2, 1).reshape(-1, nq))
        return out.reshape(b, nseg, nq).permute(0, 2, 1)

    def segment_reduce(q: torch.Tensor, how: str, init: float) -> torch.Tensor:
        nq = q.shape[1]
        out = torch.full((b * nseg, nq), init, dtype=q.dtype, device=dev)
        index = flat_ids[:, None].expand(-1, nq)
        out.scatter_reduce_(0, index, q.permute(0, 2, 1).reshape(-1, nq), how)
        return out.reshape(b, nseg, nq).permute(0, 2, 1)

    # pass 1: zeroth and first moments, per-channel sums
    sums = segment_sum(torch.cat([torch.stack([ones, yv, xv], 1), chans], 1))
    area, sum_y, sum_x = sums[:, 0], sums[:, 1], sums[:, 2]
    nn = area.clamp_min(1.0)
    cy = sum_y / nn
    cx = sum_x / nn
    chan_mean = sums[:, 3:] / nn[:, None]

    # segments are contiguous and sorted by linear index, so each segment's
    # first and last slots carry its min and max row
    prev_seg = F.pad(seg_ids[:, :-1], (1, 0), value=0)
    next_seg = F.pad(seg_ids[:, 1:], (0, 1), value=0)
    isfirst = ((seg_ids != prev_seg) & valid_px).to(f64)
    islast = ((seg_ids != next_seg) & valid_px).to(f64)

    # pass 2: centred second moments, perimeter, bbox rows, squared deviations
    dy = yv - torch.gather(cy, 1, seg_ids)
    dx = xv - torch.gather(cx, 1, seg_ids)
    dev_c = chans - torch.gather(chan_mean, 2, seg_ids[:, None].expand(b, c, cap))
    second = segment_sum(
        torch.cat(
            [
                torch.stack(
                    [dy * dy, dx * dx, dy * dx, perim_w, isfirst * (yv + 1.0), islast * (yv + 1.0)],
                    1,
                ),
                dev_c * dev_c,
            ],
            1,
        )
    )
    s_yy, s_xx, s_xy, perimeter = second[:, 0], second[:, 1], second[:, 2], second[:, 3]
    has = area > 0
    minr = torch.where(has, second[:, 4] - 1.0, 0.0)
    maxr = torch.where(has, second[:, 5], 0.0)  # exclusive (= row + 1)
    var_sums = second[:, 6:]

    eccentricity, axis_major, axis_minor, orientation = _shape_props(nn, s_yy, s_xx, s_xy)

    # min/max of the exact float32 values: bbox columns and channel extrema
    mm_vals = torch.cat([xv.to(torch.float32)[:, None], chans32], 1)
    mins = segment_reduce(mm_vals, "amin", _BIG)
    maxs = segment_reduce(mm_vals, "amax", -_BIG)
    minc = torch.where(has, mins[:, 0].to(f64), 0.0)
    maxc = torch.where(has, maxs[:, 0].to(f64) + 1.0, 0.0)
    bbox_area = ((maxr - minr) * (maxc - minc)).clamp_min(1.0)

    def cell(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        out = x[..., 1:].to(dtype)  # drop the background slot
        return out[0] if single else out

    labels = torch.arange(1, max_cells + 1, dtype=torch.int32, device=dev).expand(b, -1)
    props = {
        "label": labels[0] if single else labels.contiguous(),
        "valid": cell(has, torch.bool),
        "area": cell(area),
        "centroid_y": cell(cy),
        "centroid_x": cell(cx),
        "perimeter": cell(perimeter),
        "eccentricity": cell(eccentricity),
        "axis_major_length": cell(axis_major),
        "axis_minor_length": cell(axis_minor),
        "orientation": cell(orientation),
        "bbox_min_row": cell(minr, torch.int32),
        "bbox_min_col": cell(minc, torch.int32),
        "bbox_max_row": cell(maxr, torch.int32),
        "bbox_max_col": cell(maxc, torch.int32),
        "extent": cell(area / bbox_area),
    }

    var = (var_sums / nn[:, None]).clamp_min(0.0)
    vmin = torch.where(has[:, None], mins[:, 1:], float("inf"))
    vmax = torch.where(has[:, None], maxs[:, 1:], float("-inf"))
    intensity = {
        ci: {
            "intensity_mean": cell(chan_mean[:, ci]),
            "intensity_max": cell(vmax[:, ci]),
            "intensity_min": cell(vmin[:, ci]),
            "intensity_std": cell(torch.sqrt(var[:, ci])),
        }
        for ci in range(c)
    }
    return props, intensity


def _label_segments(label_image: torch.Tensor, max_cells: int):
    """(1, H*W) segment ids of an (H, W) label image clipped into
    [0, max_cells] (labels above share the last slot) and the foreground
    mask that leaves the background out of every reduction."""
    seg = label_image.reshape(1, -1).to(torch.int64).clamp(0, max_cells)
    return seg, seg > 0


def measure_labels(label_image: torch.Tensor, max_cells: int) -> dict[str, torch.Tensor]:
    """Morphological properties for labels 1..max_cells of an (H, W) label
    image (background 0), on the image's device.

    Measurements for label k land at index k - 1. Labels above max_cells
    are clipped into the last slot, whose `valid` entry is then False (its
    statistics would merge unrelated cells).

    Returns:
        Dict of (max_cells,) tensors: label, valid, area, centroid_y/x,
        perimeter, eccentricity, axis_major_length, axis_minor_length,
        orientation, bbox_min_row/col, bbox_max_row/col (exclusive) and
        extent; integer columns int32, `valid` bool, the rest float32.
    """
    h, w = label_image.shape
    nseg = max_cells + 1
    dev = label_image.device
    seg, fg = _label_segments(label_image, max_cells)
    rows = torch.arange(h, device=dev).repeat_interleave(w)[None]
    cols = torch.arange(w, device=dev).repeat(h)[None]
    yf, xf = rows.to(torch.float64), cols.to(torch.float64)

    # pass 1: zeroth and first moments
    area, sum_y, sum_x = segment_sums(torch.stack([fg.double(), yf, xf], 1), seg, nseg, fg)[0]
    n = area.clamp_min(1.0)
    cy, cx = sum_y / n, sum_x / n

    # pass 2: centred second moments and the perimeter weights
    dy = yf - table_lookup(cy[None], seg)
    dx = xf - table_lookup(cx[None], seg)
    perim_w = _perimeter_contribution(label_image[None]).reshape(1, -1)
    s_yy, s_xx, s_xy, perimeter = segment_sums(
        torch.stack([dy * dy, dx * dx, dy * dx, perim_w], 1), seg, nseg, fg
    )[0]
    eccentricity, axis_major, axis_minor, orientation = _shape_props(n, s_yy, s_xx, s_xy)

    has = area > 0
    big = max(h, w)
    minr = torch.where(has, segment_min(rows, seg, nseg, big, fg)[0], 0)
    minc = torch.where(has, segment_min(cols, seg, nseg, big, fg)[0], 0)
    maxr = torch.where(has, segment_max(rows, seg, nseg, -1, fg)[0] + 1, 0)
    maxc = torch.where(has, segment_max(cols, seg, nseg, -1, fg)[0] + 1, 0)
    extent = area / ((maxr - minr) * (maxc - minc)).clamp_min(1)

    # the clipped slot absorbs every label above max_cells: mark it invalid
    # when that happened rather than expose merged statistics as one cell
    overflowed = label_image.max() > max_cells
    valid = has & ~(overflowed & (torch.arange(nseg, device=dev) == max_cells))

    def cell(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        return x[1:].to(dtype)  # drop the background slot

    return {
        "label": torch.arange(1, max_cells + 1, dtype=torch.int32, device=dev),
        "valid": valid[1:],
        "area": cell(area),
        "centroid_y": cell(cy),
        "centroid_x": cell(cx),
        "perimeter": cell(perimeter),
        "eccentricity": cell(eccentricity),
        "axis_major_length": cell(axis_major),
        "axis_minor_length": cell(axis_minor),
        "orientation": cell(orientation),
        "bbox_min_row": cell(minr, torch.int32),
        "bbox_min_col": cell(minc, torch.int32),
        "bbox_max_row": cell(maxr, torch.int32),
        "bbox_max_col": cell(maxc, torch.int32),
        "extent": cell(extent),
    }


def measure_intensity_stack(
    label_image: torch.Tensor, intensity_stack: torch.Tensor, max_cells: int
) -> dict[int, dict[str, torch.Tensor]]:
    """Per-label intensity statistics of a (C, H, W) channel stack under an
    (H, W) label image: {channel index: {stat: (max_cells,) float32}} with
    intensity_mean, intensity_max, intensity_min and intensity_std (the
    population standard deviation, from deviations around each label's
    mean). Empty slots read inf as their minimum and -inf as their maximum.
    Labels above max_cells share the last slot, as in `measure_labels`."""
    c = intensity_stack.shape[0]
    nseg = max_cells + 1
    seg, fg = _label_segments(label_image, max_cells)
    vals = intensity_stack.reshape(1, c, -1).to(torch.float32)

    sums = segment_sums(torch.cat([fg.double()[:, None], vals], 1), seg, nseg, fg)[0]
    n = sums[0].clamp_min(1.0)
    mean = sums[1:] / n  # (C, S)
    seg_c = seg.expand(c, -1)
    dev_c = vals[0].double() - table_lookup(mean, seg_c)
    var = (segment_sums((dev_c * dev_c)[None], seg, nseg, fg)[0] / n).clamp_min(0.0)
    vmin = segment_min(vals[0], seg_c, nseg, float("inf"), fg.expand(c, -1))
    vmax = segment_max(vals[0], seg_c, nseg, float("-inf"), fg.expand(c, -1))
    return {
        ci: {
            "intensity_mean": mean[ci, 1:].to(torch.float32),
            "intensity_max": vmax[ci, 1:],
            "intensity_min": vmin[ci, 1:],
            "intensity_std": torch.sqrt(var[ci, 1:]).to(torch.float32),
        }
        for ci in range(c)
    }


def measure_intensity(
    label_image: torch.Tensor, intensity_image: torch.Tensor, max_cells: int
) -> dict[str, torch.Tensor]:
    """`measure_intensity_stack` for one (H, W) channel."""
    return measure_intensity_stack(label_image, intensity_image[None], max_cells)[0]
