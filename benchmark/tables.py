"""Holds per-cell tables against the reference's.

Cells are paired by mutually nearest centroids within `MATCH_PX`. Three
numbers come out:

- `mask_gap`: (|area difference| summed over pairs + the area of every
  unpaired cell on either side) / the reference's cell area, both summed
  over every well compared. It covers the mask, the labels and the size
  cut: every pixel that one side gives a cell and the other does not, or
  gives another cell, counts.
- `centroid_gap`: the mean distance in pixels between the centroids of
  pairs of equal area, over every well compared. It covers where each
  cell is said to be.
- `value_gap`: over pairs of equal area whose centroids agree to `SAME_PX`
  (the same pixels), in every well, each pair's largest gap of any other
  column relative to max(|reference|, 1); the number is the `VALUE_QUANTILE`
  quantile of those over every pair compared. It covers the measurement of
  cells both sides see alike: moments, perimeter, bbox-based extent, every
  channel's statistics. A quantile and not the largest: a pair of equal
  area and centroid is now and then not the same pixels (a mask that moved
  one pixel symmetrically), and reads like a wrong measurement; such pairs
  are far fewer than one in a hundred. A column that is missing, or a NaN
  in any pair, reads inf.
"""

from __future__ import annotations

import numpy as np

MATCH_PX = 3.0
SAME_PX = 1e-3
VALUE_QUANTILE = 0.99
CENTROID = ("centroid_y", "centroid_x")


def _columns(table) -> dict[str, np.ndarray]:
    return {k: np.asarray(table[k], dtype=np.float64) for k in table.keys() if k != "label"}


def _pairs(py, px, ry, rx):
    """Index pairs (i, j) of mutually nearest centroids closer than MATCH_PX."""
    if len(py) == 0 or len(ry) == 0:
        return np.zeros(0, int), np.zeros(0, int)
    d2 = (py[:, None] - ry[None, :]) ** 2 + (px[:, None] - rx[None, :]) ** 2
    near_r = d2.argmin(1)
    near_p = d2.argmin(0)
    i = np.arange(len(py))
    ok = (near_p[near_r] == i) & (d2[i, near_r] < MATCH_PX**2)
    return i[ok], near_r[ok]


def well_gaps(program, reference) -> dict[str, float]:
    """One well's program table against the reference's (column -> values
    mappings; the program's may be a DataFrame): the sums the numbers are
    made of, and the widest value gap of each pair of the same pixels."""
    p, r = _columns(program), _columns(reference)
    i, j = _pairs(p["centroid_y"], p["centroid_x"], r["centroid_y"], r["centroid_x"])
    pa, ra = p["area"], r["area"]
    off = np.abs(pa[i] - ra[j]).sum() + pa.sum() - pa[i].sum() + ra.sum() - ra[j].sum()
    equal = pa[i] == ra[j]
    dist = np.hypot(p["centroid_y"][i] - r["centroid_y"][j], p["centroid_x"][i] - r["centroid_x"][j])
    same = equal & (dist < SAME_PX)
    if any(name not in p for name in r):
        pair_gap = np.array([np.inf])  # a column went missing
    else:
        pair_gap = np.zeros(int(same.sum()))
        for name, rv in r.items():
            if name in CENTROID:
                continue
            gap = np.abs(p[name][i][same] - rv[j][same]) / np.maximum(np.abs(rv[j][same]), 1.0)
            pair_gap = np.maximum(pair_gap, np.where(np.isnan(gap), np.inf, gap))  # NaN fails
    return {"off": float(off), "area": float(ra.sum()), "dist": float(dist[equal].sum()),
            "equal": int(equal.sum()), "pair_gap": pair_gap}


def plate_gaps(outputs, references) -> dict[str, float]:
    """The three numbers over every (pool index, table) of `outputs`; a
    table that is None (a well that never came back) is the harness's to
    count."""
    tot = {"off": 0.0, "area": 0.0, "dist": 0.0, "equal": 0}
    pair_gaps = []
    for k, table in outputs:
        if table is None:
            continue
        gaps = well_gaps(table, references[k])
        pair_gaps.append(gaps.pop("pair_gap"))
        for key, v in gaps.items():
            tot[key] += v
    pair_gap = np.concatenate(pair_gaps) if pair_gaps else np.zeros(0)
    if np.isinf(pair_gap).any():
        value_gap = float("inf")  # a missing column or a NaN fails whatever the quantile
    elif pair_gap.size:
        value_gap = float(np.quantile(pair_gap, VALUE_QUANTILE))
    else:
        value_gap = 0.0
    out = {"mask_gap": tot["off"] / max(tot["area"], 1.0),
           "centroid_gap": tot["dist"] / max(tot["equal"], 1),
           "value_gap": value_gap}
    return {k: v if np.isfinite(v) else float("inf") for k, v in out.items()}
