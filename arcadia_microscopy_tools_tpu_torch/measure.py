"""Host-side geometry helpers: outline extraction and convex hulls.

A copy of the JAX package's `measure.py` (numpy only) that calls the port's
own `_native` library; without OpenCV, the Feret diameter takes its
maximum over every contour point instead of the hull's (the same value).

Outline extraction is inherently sequential per contour, so - exactly like
the reference, where outlines are a lazy `cached_property` off the hot path
(masks.py:230-245) - it runs on host over per-cell bounding-box crops
(the reference's v0.3.1 memory optimization: O(bbox) not O(N*H*W)).

Two extractors mirror the reference's choices (masks.py:68-115):
- "cellpose": integer boundary-pixel traces via OpenCV's border following
  (the cellpose implementation is itself cv2.findContours), coordinates
  flipped to (y, x);
- "skimage": sub-pixel marching-squares contours at level 0.5 on a 1-px
  padded crop, largest contour per cell, (y, x) float coordinates.
"""

from __future__ import annotations

import numpy as np

from .typing import Float64Array, Int64Array

__all__ = ["extract_outlines", "convex_areas", "feret_diameters", "region_moments"]

# Marching-squares segment table: for each 4-bit cell configuration
# (tl, tr, br, bl), the (entry_edge -> exit_edge) transitions.
# Edges: 0=top, 1=right, 2=bottom, 3=left.


def _marching_squares(binary: np.ndarray, level: float = 0.5) -> list[np.ndarray]:
    """Closed sub-pixel contours of a binary image (skimage.find_contours
    conventions: (row, col) coordinates, linear interpolation at `level`)."""
    from collections import defaultdict

    h, w = binary.shape
    f = binary.astype(np.float64)
    segments: list[tuple[tuple[float, float], tuple[float, float]]] = []

    # Iterate over cells of 4 pixels; emit line segments where the level
    # crosses. Vectorized computation of the 16 cases.
    tl = f[:-1, :-1]
    tr = f[:-1, 1:]
    bl = f[1:, :-1]
    br = f[1:, 1:]
    case = (
        (tl > level).astype(np.uint8) * 8
        + (tr > level).astype(np.uint8) * 4
        + (br > level).astype(np.uint8) * 2
        + (bl > level).astype(np.uint8)
    )
    ys, xs = np.nonzero((case > 0) & (case < 15))

    def interp(v0, v1):
        # Edges with v0 == v1 carry no crossing; the value is never used for
        # those, but compute a safe placeholder to avoid divide-by-zero.
        d = v1 - v0
        return (level - v0) / d if d != 0 else 0.5

    for y, x in zip(ys.tolist(), xs.tolist()):
        c = case[y, x]
        v_tl, v_tr, v_bl, v_br = f[y, x], f[y, x + 1], f[y + 1, x], f[y + 1, x + 1]
        top = (y, x + interp(v_tl, v_tr))
        bottom = (y + 1, x + interp(v_bl, v_br))
        left = (y + interp(v_tl, v_bl), x)
        right = (y + interp(v_tr, v_br), x + 1)
        # Segment endpoints ordered so the interior (value > level) is left
        # of the travel direction (skimage convention: counterclockwise for
        # high regions).
        if c == 1:
            segments.append((left, bottom))
        elif c == 2:
            segments.append((bottom, right))
        elif c == 3:
            segments.append((left, right))
        elif c == 4:
            segments.append((right, top))
        elif c == 5:  # saddle
            segments.append((right, bottom))
            segments.append((left, top))
        elif c == 6:
            segments.append((bottom, top))
        elif c == 7:
            segments.append((left, top))
        elif c == 8:
            segments.append((top, left))
        elif c == 9:
            segments.append((top, bottom))
        elif c == 10:  # saddle
            segments.append((top, right))
            segments.append((bottom, left))
        elif c == 11:
            segments.append((top, right))
        elif c == 12:
            segments.append((right, left))
        elif c == 13:
            segments.append((right, bottom))
        elif c == 14:
            segments.append((bottom, left))

    if not segments:
        return []

    # Chain segments into closed contours.
    start_map: dict[tuple[float, float], list[int]] = defaultdict(list)
    for i, (a, _) in enumerate(segments):
        start_map[a].append(i)
    used = [False] * len(segments)
    contours = []
    for i in range(len(segments)):
        if used[i]:
            continue
        a, b = segments[i]
        used[i] = True
        chain = [a, b]
        while True:
            nxts = start_map.get(chain[-1], [])
            nxt = None
            for j in nxts:
                if not used[j]:
                    nxt = j
                    break
            if nxt is None:
                break
            used[nxt] = True
            chain.append(segments[nxt][1])
            if chain[-1] == chain[0]:
                break
        contours.append(np.array(chain, dtype=np.float64))
    return contours


def _trace_boundary_pixels(binary: np.ndarray) -> list[np.ndarray]:
    """Integer boundary traces via OpenCV border following (the same
    machinery cellpose's outlines_list uses), returned as (y, x)."""
    import cv2

    contours, _ = cv2.findContours(
        binary.astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE
    )
    out = []
    for c in contours:
        pts = c.reshape(-1, 2)  # (x, y)
        out.append(pts[:, ::-1].astype(np.float64))  # -> (y, x)
    return out


def _label_groups(lbl: np.ndarray, n: int):
    """Per-label foreground coordinates via ONE argsort.

    Yields (label, rows, cols) for labels 1..n with nonzero pixel counts.
    The per-label `mask == k` rescan pattern is O(num_labels x num_fg_pixels)
    - quadratic on dense plates; sorting the foreground once and slicing is
    O(N log N) total.
    """
    ys, xs = np.nonzero(lbl)
    order = lbl[ys, xs]
    perm = np.argsort(order, kind="stable")
    so = order[perm]
    sy, sx = ys[perm], xs[perm]
    bounds = np.searchsorted(so, np.arange(1, n + 2))
    for k in range(1, n + 1):
        a, b = bounds[k - 1], bounds[k]
        if a < b:
            yield k, sy[a:b], sx[a:b]


def extract_outlines(
    label_image: Int64Array, method: str = "cellpose"
) -> list[Float64Array]:
    """Extract one outline per cell, ordered by label (index 0 = label 1).

    Args:
        label_image: 2D integer label image (consecutive labels, bg=0).
        method: "cellpose" (integer boundary pixels) or "skimage" (sub-pixel
            marching squares).

    Returns:
        List of (N, 2) arrays of (y, x) coordinates; empty (0, 2) arrays keep
        alignment for cells with no detectable contour.
    """
    lbl = np.asarray(label_image)
    n = int(lbl.max())
    h, w = lbl.shape

    if method == "cellpose":
        # native boundary tracer when built (C++ Moore walk, one pass)
        from . import _native

        native = _native.trace_outlines(lbl)
        if native is not None:
            return [
                o if len(o) > 0 else np.array([]).reshape(0, 2) for o in native
            ]

    # per-cell bbox crops keep memory O(cell area), not O(N*H*W); one argsort
    # groups the foreground by label instead of an O(n*fg) rescan per cell
    outlines: list[Float64Array] = [np.array([]).reshape(0, 2) for _ in range(n)]
    for k, cy, cx in _label_groups(lbl, n):
        minr, maxr = cy.min(), cy.max()
        minc, maxc = cx.min(), cx.max()
        minr_p = max(minr - 1, 0)
        minc_p = max(minc - 1, 0)
        maxr_p = min(maxr + 2, h)
        maxc_p = min(maxc + 2, w)
        crop = (lbl[minr_p:maxr_p, minc_p:maxc_p] == k)
        if method == "cellpose":
            contours = _trace_boundary_pixels(crop)
        else:
            crop_padded = np.pad(crop.astype(np.uint8), 1)
            contours = _marching_squares(crop_padded)
            contours = [c - 1.0 for c in contours]  # undo the extra pad
        if contours:
            main = max(contours, key=len)
            outlines[k - 1] = main + np.array([minr_p, minc_p], dtype=np.float64)
    return outlines


def region_moments(label_image: Int64Array, order: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """Raw and central spatial moments per cell, skimage conventions.

    For each label k, M[p, q] = sum over the cell's pixels of r^p * c^q with
    (r, c) relative to the cell's bounding-box corner (skimage computes
    moments on the cropped region image), for all p, q <= order; central
    moments mu[p, q] use coordinates relative to the local centroid.

    One vectorized pass: per-cell bbox corners and centroids come from
    bincounts, then each (p, q) entry is one weighted bincount over the
    foreground pixels - no per-region Python loop.

    Returns:
        (M, mu): two (num_cells, order+1, order+1) float64 arrays, ordered
        by label (index 0 = label 1).
    """
    lbl = np.asarray(label_image)
    n = int(lbl.max())
    k = order + 1
    if n == 0:
        empty = np.zeros((0, k, k))
        return empty, empty

    ys, xs = np.nonzero(lbl)
    labels = lbl[ys, xs]

    minr = np.full(n + 1, np.iinfo(np.int64).max)
    minc = np.full(n + 1, np.iinfo(np.int64).max)
    np.minimum.at(minr, labels, ys)
    np.minimum.at(minc, labels, xs)

    # bbox-local coordinates, as skimage's cropped region images use
    ry = (ys - minr[labels]).astype(np.float64)
    cx = (xs - minc[labels]).astype(np.float64)

    count = np.bincount(labels, minlength=n + 1).astype(np.float64)
    count = np.maximum(count, 1.0)
    cy = np.bincount(labels, weights=ry, minlength=n + 1) / count
    ccx = np.bincount(labels, weights=cx, minlength=n + 1) / count

    ry_pows = np.stack([ry**p for p in range(k)])  # (k, N)
    cx_pows = np.stack([cx**q for q in range(k)])
    dy = ry - cy[labels]
    dx = cx - ccx[labels]
    dy_pows = np.stack([dy**p for p in range(k)])
    dx_pows = np.stack([dx**q for q in range(k)])

    raw = np.zeros((n + 1, k, k))
    central = np.zeros((n + 1, k, k))
    for p in range(k):
        for q in range(k):
            raw[:, p, q] = np.bincount(
                labels, weights=ry_pows[p] * cx_pows[q], minlength=n + 1
            )
            central[:, p, q] = np.bincount(
                labels, weights=dy_pows[p] * dx_pows[q], minlength=n + 1
            )
    return raw[1:], central[1:]


def feret_diameters(label_image: Int64Array) -> np.ndarray:
    """Maximum Feret diameter per cell, ordered by label.

    skimage's convention: the largest distance between points of the convex
    hull of the 0.5-level marching-squares contour around the (padded)
    region. Computed here as the max pairwise distance over each cell's
    sub-pixel contour points (the maximum is attained at hull vertices, so
    the hull step is unnecessary).
    """
    lbl = np.asarray(label_image)
    n = int(lbl.max())
    h, w = lbl.shape
    out = np.zeros(n, dtype=np.float64)
    for k, cy, cx in _label_groups(lbl, n):
        minr, minc = cy.min(), cx.min()
        crop = lbl[minr : cy.max() + 1, minc : cx.max() + 1] == k
        contours = _marching_squares(np.pad(crop.astype(np.uint8), 1))
        if not contours:
            continue
        pts = np.concatenate(contours, axis=0)
        # monotone reduction: hull via cv2 when many points, else brute force
        # (contour points are multiples of 0.5, exact in float32)
        if len(pts) > 400:
            try:
                import cv2
            except ImportError:
                out[k - 1] = _max_pairwise_distance(pts)
                continue
            hull = cv2.convexHull(pts.astype(np.float32)).reshape(-1, 2)
            pts = hull.astype(np.float64)
        out[k - 1] = _max_pairwise_distance(pts)
    return out


def _max_pairwise_distance(pts: np.ndarray, chunk: int = 1024) -> float:
    """Largest distance between two of the (N, 2) points, in row chunks so
    that memory stays O(chunk * N)."""
    best = 0.0
    for i in range(0, len(pts), chunk):
        diff = pts[i : i + chunk, None, :] - pts[None, :, :]
        best = max(best, float((diff**2).sum(-1).max()))
    return float(np.sqrt(best))


def convex_areas(label_image: Int64Array) -> np.ndarray:
    """Per-cell convex hull areas (pixel counts inside the rasterized hull),
    ordered by label. Uses the native C++ kernel (exact scanline lattice
    count over the monotone-chain hull) when built, falling back to OpenCV's
    hull rasterization; both match skimage's convex_image count within the
    boundary-pixel tolerance documented in tests."""
    from . import _native

    native = _native.convex_areas(np.asarray(label_image))
    if native is not None:
        return native

    import cv2

    lbl = np.asarray(label_image)
    n = int(lbl.max())
    areas = np.zeros(n, dtype=np.float64)
    for k, cy, cx in _label_groups(lbl, n):
        minr, minc = cy.min(), cx.min()
        hh = cy.max() - minr + 1
        ww = cx.max() - minc + 1
        pts = np.stack([cx - minc, cy - minr], axis=1).astype(np.int32)
        if len(pts) < 3:
            areas[k - 1] = len(pts)
            continue
        hull = cv2.convexHull(pts)
        canvas = np.zeros((hh, ww), dtype=np.uint8)
        cv2.fillConvexPoly(canvas, hull, 1)
        areas[k - 1] = float(canvas.sum())
    return areas
