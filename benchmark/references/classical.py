"""Plain reference of the classical plate: per-cell tables of uint16 wells.

The semantics the plate states (the reference library's DoG -> percentile
rescale -> global threshold -> connected components -> regionprops, as the
port documents them), written out straight in PyTorch with no kernel, no
compaction and no batching:

1. the segmentation channel as [0, 1] floats (x / 65535), centred on its
   midrange, minus its Gaussians of sigma `low_sigma` and `high_sigma`
   (scipy's sampled kernel, radius int(4 sigma + 0.5), "nearest" edges);
2. the DoG quantized to 65536 levels over its own range; those levels
   rescaled between their 0.5th and 99.9th percentiles (numpy's linear
   percentile) onto 65536 levels; Otsu's threshold of that histogram; the
   mask is the levels above it;
3. 8-connected components, numbered in raster order of their first pixel;
4. per component: area, centroid, skimage's perimeter (weighted border
   pixel categories), the inertia-tensor shape columns, extent over the
   bounding box, and per channel the mean, max, min and population std;
   cells of fewer than `min_size` pixels dropped; circularity and volume
   as the runner's table derives them.

The reference computes every floating value in float64. A control steps
one stage one precision below the float32 that the configuration states,
and leaves the other stage as the reference computes it. `LOWERED` names
the two, and both are `CONTROLS`, which the comparison has to fail: `mask`
(steps 1-2) stores every floating value in bfloat16 and accumulates in
float32, as bfloat16 hardware does; `measure` (step 4) stores each
per-cell value in bfloat16, rounded once from the reference's: the least
that a bfloat16 measurement departs, so that a limit it fails is failed by
any. The area and the centroid stay exact, so that the cells remain pairs
of the same pixels and `value_gap` reads the measurement alone. Integers
(levels, counts, labels) stay exact in all.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import tables

PRECISIONS = {"reference": (torch.float64, torch.float64), "control": (torch.bfloat16, torch.float32)}
# each stage stepped down alone: the stages computed at "control" precision,
# the rest at "reference"; CONTROLS, those the comparison has to fail
LOWERED = {"mask": {"mask": "control"}, "measure": {"measure": "control"}}
CONTROLS = ["mask", "measure"]
BINS = 65536
PERIMETER_WEIGHTS = {1: 1.0, 2: math.sqrt(2.0), 3: (1.0 + math.sqrt(2.0)) / 2.0}
_CLASS_OF_CATEGORY = {5: 1, 7: 1, 15: 1, 17: 1, 25: 1, 27: 1, 21: 2, 33: 2, 13: 3, 23: 3}


class _Arith:
    def __init__(self, precision: str):
        self.store, self.acc = PRECISIONS[precision]

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """A value as stored: rounded to the storage precision, carried in
        the accumulation precision."""
        return t.to(self.store).to(self.acc)


def _gaussian(img: torch.Tensor, sigma: float, ar: _Arith) -> torch.Tensor:
    radius = int(4.0 * sigma + 0.5)
    x = torch.arange(-radius, radius + 1, dtype=torch.float64)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).to(img.device, ar.store)
    y = F.pad(img[None, None].to(ar.store), (radius,) * 4, mode="replicate")
    y = F.conv2d(y, k.view(1, 1, -1, 1))
    y = F.conv2d(y, k.view(1, 1, 1, -1))
    return y[0, 0].to(ar.acc)


def _percentile(sorted_vals: torch.Tensor, q: float, ar: _Arith) -> torch.Tensor:
    n = sorted_vals.numel()
    pos = q / 100.0 * (n - 1)
    k = math.floor(pos)
    v0 = sorted_vals[k].to(ar.acc)
    v1 = sorted_vals[min(k + 1, n - 1)].to(ar.acc)
    return ar.q(v0 + ar.q(torch.tensor(pos - k, dtype=ar.acc, device=v0.device)) * (v1 - v0))


def _otsu(counts: torch.Tensor, ar: _Arith) -> torch.Tensor:
    """The bin value t maximising the between-class variance of the split
    (bins <= t | bins > t), the first such bin on ties."""
    c = counts.to(ar.acc)
    x = ar.q(torch.arange(BINS, dtype=ar.acc, device=counts.device))
    w1 = torch.cumsum(c, 0)
    w2 = torch.flip(torch.cumsum(torch.flip(c, [0]), 0), [0])
    s1 = torch.cumsum(ar.q(c * x), 0)
    s2 = torch.flip(torch.cumsum(torch.flip(ar.q(c * x), [0]), 0), [0])
    m1 = torch.where(w1 > 0, s1 / w1.clamp_min(1), 0)
    m2 = torch.where(w2 > 0, s2 / w2.clamp_min(1), 0)
    var = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    var = torch.where((w1[:-1] > 0) & (w2[1:] > 0), var, -1.0)
    return x[torch.argmax(var)]


def foreground(seg: torch.Tensor, cfg: dict, ar: _Arith) -> torch.Tensor:
    """The (H, W) bool mask of one uint16 segmentation channel."""
    img = ar.q(seg.to(ar.acc) / 65535.0)
    img = ar.q(img - ar.q((img.min() + img.max()) * 0.5))
    dog = ar.q(_gaussian(img, cfg["low_sigma"], ar) - _gaussian(img, cfg["high_sigma"], ar))
    mn, mx = dog.min(), dog.max()
    step = ar.q((mx - mn).clamp_min(1e-30) / 65535.0)
    q0 = torch.floor(ar.q((dog - mn) / step)).clamp(0, BINS - 1)
    s = torch.sort(q0.flatten()).values
    lo, hi = cfg["percentile_range"]
    p1, p2 = _percentile(s, lo, ar), _percentile(s, hi, ar)
    scale = ar.q(torch.where(p2 > p1, 65535.0 / (p2 - p1).clamp_min(1e-30), 0.0))
    r = torch.floor(ar.q(ar.q(q0 - p1) * scale).clamp(0, BINS - 1))
    t = _otsu(torch.bincount(r.long().flatten(), minlength=BINS), ar)
    return r > t


def components(mask: torch.Tensor) -> torch.Tensor:
    """8-connected labels (int64, 0 = background, 1..N in raster order of
    each component's first pixel): every pixel takes the least pixel index
    of its 3 x 3 neighbourhood, then jumps to the label of that pixel, until
    nothing changes."""
    h, w = mask.shape
    big = float(h * w)
    idx = torch.arange(h * w, device=mask.device, dtype=torch.float64).view(h, w)
    lab = torch.where(mask, idx, big)
    while True:
        m = -F.max_pool2d(-lab[None, None], 3, 1, 1)[0, 0]
        m = torch.where(mask, m, big)
        flat = torch.cat([m.flatten(), m.new_full((1,), big)])
        m = torch.where(mask, flat[m.long()].view(h, w), big)
        if torch.equal(m, lab):
            break
        lab = m
    roots = torch.unique(lab[mask])  # sorted: raster order of first pixels
    out = torch.zeros((h, w), dtype=torch.int64, device=mask.device)
    out[mask] = torch.searchsorted(roots, lab[mask]) + 1
    return out


def _perimeter_class(lab: torch.Tensor) -> torch.Tensor:
    h, w = lab.shape
    p = F.pad(lab, (1, 1, 1, 1), value=0)

    def nb(dy, dx, t):
        return t[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    fg = lab > 0
    four = ((-1, 0), (1, 0), (0, -1), (0, 1))
    diag = ((-1, -1), (-1, 1), (1, -1), (1, 1))
    border = fg & ~torch.stack([nb(dy, dx, p) == lab for dy, dx in four]).all(0)
    pb = F.pad(border, (1, 1, 1, 1), value=False)

    def count(offsets):
        return sum(((nb(dy, dx, p) == lab) & nb(dy, dx, pb)).long() for dy, dx in offsets)

    category = torch.where(border, 1 + 2 * count(four) + 10 * count(diag), 0)
    table = torch.zeros(49, dtype=torch.int64, device=lab.device)
    for cat, cls in _CLASS_OF_CATEGORY.items():
        table[cat] = cls
    return table[category]


def cell_table(lab: torch.Tensor, channels: torch.Tensor, cfg: dict, ar: _Arith) -> dict:
    """Per-cell columns (numpy float64) of one label image and its (C, H, W)
    uint16 channels."""
    dev = lab.device
    fg = lab > 0
    ids = lab[fg] - 1
    n_cells = int(lab.max())
    ys, xs = torch.nonzero(fg, as_tuple=True)
    area = torch.bincount(ids, minlength=n_cells).to(ar.acc)

    def total(v):
        return torch.zeros(n_cells, dtype=ar.acc, device=dev).index_add_(0, ids, ar.q(v))

    def per_cell(v):
        return v[ids]

    y, x = ar.q(ys.to(ar.acc)), ar.q(xs.to(ar.acc))
    sy, sx = total(y), total(x)
    cy, cx = ar.q(sy / area), ar.q(sx / area)

    def central(s_ab, sa, sb):
        # (n * sum(ab) - sum(a) * sum(b)) / n^2: in float64 every term is an
        # exact integer below 2^53, so equal moments compare equal
        return ar.q(ar.q(area * s_ab - ar.q(sa * sb)) / (area * area))

    mu20, mu02, mu11 = central(total(y * y), sy, sy), central(total(x * x), sx, sx), central(
        total(y * x), sy, sx)
    common = torch.sqrt((4 * mu11 * mu11 + (mu20 - mu02) ** 2).clamp_min(0))
    l1 = ar.q((mu20 + mu02 + common) / 2)
    l2 = ar.q(((mu20 + mu02 - common) / 2).clamp_min(0))
    a, b, c = mu02, -mu11, mu20
    orientation = torch.where(a - c == 0, torch.where(b < 0, -math.pi / 4, math.pi / 4),
                              0.5 * torch.atan2(-2 * b, c - a))
    cls = _perimeter_class(lab)[fg]
    weight = torch.zeros(4, dtype=ar.acc, device=dev)
    for k, v in PERIMETER_WEIGHTS.items():
        weight[k] = v
    perimeter = total(weight[cls])

    def extreme(v, how):
        init = torch.full((n_cells,), float("inf") if how == "amin" else -float("inf"),
                          dtype=ar.acc, device=dev)
        return init.scatter_reduce(0, ids, ar.q(v), how)

    box = (extreme(y, "amax") + 1 - extreme(y, "amin")) * (extreme(x, "amax") + 1 - extreme(x, "amin"))
    cols = {
        "area": area,
        "centroid_y": cy,
        "centroid_x": cx,
        "perimeter": perimeter,
        "eccentricity": torch.where(l1 > 0, torch.sqrt((1 - l2 / l1.clamp_min(1e-30)).clamp_min(0)), 0),
        "axis_major_length": 4 * torch.sqrt(l1.clamp_min(0)),
        "axis_minor_length": 4 * torch.sqrt(l2),
        "orientation": orientation,
        "extent": area / box,
    }
    for ci in range(channels.shape[0]):
        v = ar.q(channels[ci][fg].to(ar.acc))
        mean = ar.q(total(v) / area)
        dev_ = ar.q(v - per_cell(mean))
        cols[f"intensity_mean_ch{ci}"] = mean
        cols[f"intensity_max_ch{ci}"] = extreme(v, "amax")
        cols[f"intensity_min_ch{ci}"] = extreme(v, "amin")
        cols[f"intensity_std_ch{ci}"] = torch.sqrt(ar.q(total(dev_ * dev_) / area))
    keep = area >= cfg["min_size"]
    out = {k: ar.q(v)[keep].double().cpu().numpy() for k, v in cols.items()}
    per, ax1, ax2 = out["perimeter"], out["axis_major_length"] / 2, out["axis_minor_length"] / 2
    with np.errstate(divide="ignore", invalid="ignore"):
        out["circularity"] = np.where(per > 0, 4 * np.pi * out["area"] / per**2, 0.0)
    out["volume"] = np.where((ax1 > 0) & (ax2 > 0), 4 / 3 * np.pi * ax1 * ax2 * ax2, 0.0)
    return out


def stored_bf16(table: dict) -> dict:
    """A table as bfloat16 would store it: every value rounded once to
    bfloat16 but the area and the centroid."""
    keep = ("area",) + tables.CENTROID
    return {k: v if k in keep else
            torch.from_numpy(v).to(torch.bfloat16).double().numpy() for k, v in table.items()}


def well_table(well: np.ndarray, config: dict, device, stages: dict | None = None) -> dict:
    """The per-cell table of one (C, H, W) uint16 well; `stages` maps a stage
    (`mask`, `measure`) to its precision, "reference" where it is left out."""
    cfg = config["plate"]
    stages = stages or {}
    params = {"low_sigma": cfg["low_sigma"], "high_sigma": cfg["high_sigma"],
              "percentile_range": config["percentile_range"], "min_size": cfg["min_size"]}
    chans = torch.from_numpy(well.astype(np.int32)).to(device)
    mask = foreground(chans[cfg["seg_channel_index"]], params,
                      _Arith(stages.get("mask", "reference")))
    table = cell_table(components(mask), chans, params, _Arith("reference"))
    return stored_bf16(table) if stages.get("measure") == "control" else table


def reference_outputs(pool: np.ndarray, config: dict, device, stages: dict | None = None):
    """One table per pool well."""
    return [well_table(w, config, device, stages) for w in pool]


def control_outputs(pool: np.ndarray, config: dict, device, name: str):
    """The tables of control `name`, in the program's place: (pool index, table)."""
    return list(enumerate(reference_outputs(pool, config, device, LOWERED[name])))


def compare(outputs, refs, pool: np.ndarray, config: dict, device) -> dict[str, float]:
    """The compared numbers of a run's (pool index, table) outputs against
    the reference's tables of the pool."""
    return tables.plate_gaps(outputs, refs)
