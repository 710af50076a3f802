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
the TPU's matrix unit. Here every quantity that is an integer is summed
exactly in int64 (`segment_reduce.segment_sums`): areas, the raw
coordinate moments, integer channel values and their squares, and the
pixel count of each of the perimeter's three weight classes. The centred
second moments, the channel variances and the perimeter are then derived
from those sums in float64, and every float result is cast to float32 at
the end. Exact sums give the same bits on every run whatever order the
card's atomics take, and partial sums over row slabs of an image add up to
the whole image's: `measure_segments` takes a `reduce` that combines the
partials of several shards (`parallel/plate.py`). Float channel values
(not integer) are summed in float64 in a fixed order, their variance in a
second pass around the means. Minima and maxima are `scatter_reduce`.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from .segment_reduce import segment_max, segment_min, segment_sums, table_lookup

__all__ = [
    "measure_compacted",
    "measure_intensity",
    "measure_intensity_stack",
    "measure_labels",
    "measure_segments",
    "perimeter_classes",
]

# combines per-shard partial results: reduce(tensor, "sum" | "min" | "max")
Reduce = Callable[[torch.Tensor, str], torch.Tensor]

# skimage's perimeter weight of each of the three classes of border pixels
PERIMETER_WEIGHTS = (1.0, math.sqrt(2.0), (1.0 + math.sqrt(2.0)) / 2.0)


def _local(t: torch.Tensor, op: str) -> torch.Tensor:
    return t


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


def _class_table(device) -> torch.Tensor:
    """skimage's border category 1 + 2 * (same-label border 4-neighbours)
    + 10 * (diagonal ones) -> weight class 1, 2 or 3 (PERIMETER_WEIGHTS),
    0 for the categories that weigh nothing."""
    table = torch.zeros(49, dtype=torch.int64)
    table[[5, 7, 15, 17, 25, 27]] = 1
    table[[21, 33]] = 2
    table[[13, 23]] = 3
    return table.to(device)


def perimeter_classes(lbl: torch.Tensor) -> torch.Tensor:
    """Per-pixel perimeter weight class (int64, 0-3) of (B, H, W) labels
    with background 0. A pixel's class depends on labels up to two rows
    away."""
    border = _border_map(lbl)

    def neighbor_border_same(dy, dx):
        return (_neighbor(lbl, dy, dx, -1) == lbl) & _neighbor(border, dy, dx, False)

    def count(offsets):
        return sum(neighbor_border_same(dy, dx).to(torch.int64) for dy, dx in offsets)

    n4 = count(((-1, 0), (1, 0), (0, -1), (0, 1)))
    nd = count(((-1, -1), (-1, 1), (1, -1), (1, 1)))
    category = torch.where(border, 1 + 2 * n4 + 10 * nd, 0)
    return _class_table(lbl.device)[category]


def _centred_sum(n, sa, sb, sab) -> torch.Tensor:
    """sum((a - mean a) * (b - mean b)) per segment, float64, from exact
    int64 sums: n, sum(a), sum(b) and sum(a * b). Around the integer
    r = floor(mean) the sums stay exact in int64; one float64 step
    (n * S - ea * eb) / n finishes, so equal integer moments give equal
    results."""
    nn = n.clamp_min(1)
    ra = torch.div(sa, nn, rounding_mode="floor")
    rb = torch.div(sb, nn, rounding_mode="floor")
    s = sab - ra * sb - rb * sa + nn * ra * rb
    ea, eb = sa - nn * ra, sb - nn * rb
    nf = nn.double()
    return (nf * s.double() - ea.double() * eb.double()) / nf


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


def _morphology(seg, keep, y, x, pclass, nseg: int, root, reduce: Reduce) -> dict:
    """Morphological columns of every segment (B, nseg), float64 / int64."""
    ints = torch.stack(
        [keep.long(), y, x, y * y, x * x, y * x]
        + [(pclass == k).long() for k in (1, 2, 3)],
        1,
    )
    sums = reduce(segment_sums(ints, seg, nseg, keep), "sum")
    n, sy, sx, syy, sxx, sxy, c1, c2, c3 = sums.unbind(1)
    big = torch.iinfo(torch.int64).max
    minr = reduce(segment_min(y, seg, nseg, big, keep), "min")
    minc = reduce(segment_min(x, seg, nseg, big, keep), "min")
    maxc = reduce(segment_max(x, seg, nseg, -1, keep), "max")
    if root is None:
        maxr = reduce(segment_max(y, seg, nseg, -1, keep), "max")
    else:
        # the last row of the segment's last component in (root, index)
        # order, as the reference reads it off the segment's last slot: the
        # segment's largest row unless it merges several components
        last_root = reduce(segment_max(root, seg, nseg, -1, keep), "max")
        last = keep & (root == table_lookup(last_root, seg))
        maxr = reduce(segment_max(y, seg, nseg, -1, last), "max")
    has = n > 0
    nf = n.clamp_min(1).double()
    s_yy = _centred_sum(n, sy, sy, syy)
    s_xx = _centred_sum(n, sx, sx, sxx)
    s_xy = _centred_sum(n, sy, sx, sxy)
    eccentricity, axis_major, axis_minor, orientation = _shape_props(nf, s_yy, s_xx, s_xy)
    w1, w2, w3 = PERIMETER_WEIGHTS
    minr, minc = torch.where(has, minr, 0), torch.where(has, minc, 0)
    maxr, maxc = torch.where(has, maxr + 1, 0), torch.where(has, maxc + 1, 0)  # exclusive
    return {
        "area": n,
        "centroid_y": sy.double() / nf,
        "centroid_x": sx.double() / nf,
        "perimeter": c1.double() * w1 + c2.double() * w2 + c3.double() * w3,
        "eccentricity": eccentricity,
        "axis_major_length": axis_major,
        "axis_minor_length": axis_minor,
        "orientation": orientation,
        "bbox_min_row": minr,
        "bbox_min_col": minc,
        "bbox_max_row": maxr,
        "bbox_max_col": maxc,
        "extent": n.double() / ((maxr - minr) * (maxc - minc)).clamp_min(1).double(),
    }


def _intensity(seg, keep, chans, nseg: int, reduce: Reduce) -> dict:
    """Per-channel intensity statistics of every segment: (B, C, nseg)
    float64 mean and std, extrema in the channels' dtype (+-inf, or the
    dtype's limits, on empty segments)."""
    b, c, p = chans.shape
    seg_c = seg[:, None].expand(b, c, p).reshape(b * c, p)
    keep_c = keep[:, None].expand(b, c, p).reshape(b * c, p)
    flat = chans.reshape(b * c, p)
    if chans.dtype.is_floating_point:
        lo, hi = float("inf"), float("-inf")
    else:
        lo, hi = torch.iinfo(torch.int64).max, torch.iinfo(torch.int64).min
        flat = flat.long()
    vmin = reduce(segment_min(flat, seg_c, nseg, lo, keep_c), "min").reshape(b, c, nseg)
    vmax = reduce(segment_max(flat, seg_c, nseg, hi, keep_c), "max").reshape(b, c, nseg)
    n = reduce(segment_sums(keep[:, None].long(), seg, nseg, keep), "sum")[:, 0]
    nf = n.clamp_min(1).double()[:, None]
    if chans.dtype.is_floating_point:
        sums = reduce(segment_sums(chans, seg, nseg, keep), "sum")
        mean = sums / nf
        dev = chans.double() - torch.gather(mean, 2, seg[:, None].expand(b, c, p))
        var = reduce(segment_sums(dev * dev, seg, nseg, keep), "sum") / nf
    else:
        cl = chans.long()
        sums = reduce(segment_sums(torch.cat([cl, cl * cl], 1), seg, nseg, keep), "sum")
        s1, s2 = sums[:, :c], sums[:, c:]
        mean = s1.double() / nf
        var = _centred_sum(n[:, None], s1, s1, s2) / nf
    return {"n": n, "mean": mean, "std": torch.sqrt(var.clamp_min(0.0)), "min": vmin, "max": vmax}


def measure_segments(
    seg: torch.Tensor,
    keep: torch.Tensor,
    y: torch.Tensor,
    x: torch.Tensor,
    pclass: torch.Tensor,
    stack: torch.Tensor | None,
    max_cells: int,
    root: torch.Tensor | None = None,
    reduce: Reduce | None = None,
) -> tuple[dict[str, torch.Tensor], dict[int, dict[str, torch.Tensor]]]:
    """Per-cell columns of listed pixels, the core of `measure_compacted`.

    Args:
        seg: (B, P) int64 cell slot of each pixel in [0, max_cells] (0 = not
            measured).
        keep: (B, P) bool, the pixels that count.
        y, x: (B, P) int64 image coordinates.
        pclass: (B, P) int64 perimeter class (`perimeter_classes`).
        stack: (B, C, P) channel values, or None for morphology alone.
        max_cells: cell slots per image.
        root: (B, P) int64 component root per pixel, or None. With it a slot
            that merges several components takes its bbox_max_row from the
            last of them, as the reference does; without it the slot's
            largest row.
        reduce: combines each partial result across the shards of an image
            (None: one shard).

    Returns:
        (props, intensity) as `measure_compacted` returns them, batched.
    """
    reduce = reduce or _local
    nseg = max_cells + 1
    keep = keep & (seg > 0)
    morph = _morphology(seg, keep, y, x, pclass, nseg, root, reduce)

    def cell(t: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        return t[..., 1:].to(dtype)  # drop the background slot

    b = seg.shape[0]
    labels = torch.arange(1, nseg, dtype=torch.int32, device=seg.device).expand(b, -1)
    props = {"label": labels.contiguous(), "valid": cell(morph["area"] > 0, torch.bool)}
    for name, t in morph.items():
        props[name] = cell(t, torch.int32 if name.startswith("bbox") else torch.float32)
    intensity = {}
    if stack is not None:
        st = _intensity(seg, keep, stack, nseg, reduce)
        has = st["n"][:, None] > 0
        vmin = torch.where(has, st["min"].to(torch.float32), float("inf"))
        vmax = torch.where(has, st["max"].to(torch.float32), float("-inf"))
        for ci in range(stack.shape[1]):
            intensity[ci] = {
                "intensity_mean": cell(st["mean"][:, ci]),
                "intensity_max": cell(vmax[:, ci]),
                "intensity_min": cell(vmin[:, ci]),
                "intensity_std": cell(st["std"][:, ci]),
            }
    return props, intensity


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
        idx: (B, cap) linear pixel indices.
        roots_image: (B, H, W) int32 root image (sentinel H*W on
            background), used for the perimeter categories.
        intensity_stack: (B, C, H, W) intensity channels; integer channels
            (uint16 wells) are summed exactly.
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
    idx_l = idx.to(torch.int64)
    roots = roots_image.reshape(b, n).to(torch.int64)
    rl = torch.where(roots_image < n, roots_image + 1, 0)
    pclass = torch.gather(perimeter_classes(rl).reshape(b, n), 1, idx_l)
    stack = intensity_stack.reshape(b, c, n)
    if not stack.dtype.is_floating_point:
        stack = stack.to(torch.int64)  # the card indexes few integer types
    chans = torch.gather(stack, 2, idx_l[:, None].expand(b, c, cap))
    props, intensity = measure_segments(
        seg.to(torch.int64).clamp(0, max_cells), seg > 0, idx_l // width, idx_l % width,
        pclass, chans, max_cells, root=torch.gather(roots, 1, idx_l),
    )
    if single:
        props = {k: v[0] for k, v in props.items()}
        intensity = {ci: {k: v[0] for k, v in d.items()} for ci, d in intensity.items()}
    return props, intensity


def _label_segments(label_image: torch.Tensor, max_cells: int):
    """(1, H*W) segment ids of an (H, W) label image clipped into
    [0, max_cells] (labels above share the last slot), the foreground mask
    that leaves the background out of every reduction, and each pixel's
    (1, H*W) int64 row and column."""
    h, w = label_image.shape
    dev = label_image.device
    seg = label_image.reshape(1, -1).to(torch.int64).clamp(0, max_cells)
    rows = torch.arange(h, device=dev).repeat_interleave(w)[None]
    cols = torch.arange(w, device=dev).repeat(h)[None]
    return seg, seg > 0, rows, cols


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
    seg, fg, rows, cols = _label_segments(label_image, max_cells)
    pclass = perimeter_classes(label_image[None]).reshape(1, -1)
    props, _ = measure_segments(seg, fg, rows, cols, pclass, None, max_cells)
    props = {k: v[0] for k, v in props.items()}
    # the clipped slot absorbs every label above max_cells: mark it invalid
    # when that happened rather than expose merged statistics as one cell
    overflowed = label_image.max() > max_cells
    last = torch.arange(max_cells, device=label_image.device) == max_cells - 1
    props["valid"] = props["valid"] & ~(overflowed & last)
    return props


def measure_intensity_stack(
    label_image: torch.Tensor, intensity_stack: torch.Tensor, max_cells: int
) -> dict[int, dict[str, torch.Tensor]]:
    """Per-label intensity statistics of a (C, H, W) channel stack under an
    (H, W) label image: {channel index: {stat: (max_cells,) float32}} with
    intensity_mean, intensity_max, intensity_min and intensity_std (the
    population standard deviation). Integer channels are summed exactly;
    float channels in float64, the variance around each label's mean.
    Empty slots read inf as their minimum and -inf as their maximum.
    Labels above max_cells share the last slot, as in `measure_labels`."""
    c = intensity_stack.shape[0]
    seg, fg, _, _ = _label_segments(label_image, max_cells)
    stack = intensity_stack.reshape(1, c, -1)
    if not stack.dtype.is_floating_point:
        stack = stack.to(torch.int64)
    else:
        stack = stack.to(torch.float32)
    st = _intensity(seg, fg & (seg > 0), stack, max_cells + 1, _local)
    has = st["n"][0] > 0
    return {
        ci: {
            "intensity_mean": st["mean"][0, ci, 1:].to(torch.float32),
            "intensity_max": torch.where(has, st["max"][0, ci].to(torch.float32), float("-inf"))[1:],
            "intensity_min": torch.where(has, st["min"][0, ci].to(torch.float32), float("inf"))[1:],
            "intensity_std": st["std"][0, ci, 1:].to(torch.float32),
        }
        for ci in range(c)
    }


def measure_intensity(
    label_image: torch.Tensor, intensity_image: torch.Tensor, max_cells: int
) -> dict[str, torch.Tensor]:
    """`measure_intensity_stack` for one (H, W) channel."""
    return measure_intensity_stack(label_image, intensity_image[None], max_cells)[0]
