"""Fixed-shape tile batching for device feed.

The reference has no batching abstraction at all - each image flows through
Python one at a time (SURVEY.md section 7 step 2 calls this out as the new
piece). `TileSource` turns a heterogeneous stream of wells/files into
fixed-shape (B, C, tile, tile) uint16 batches: static shapes keep XLA from
recompiling, and batches map 1:1 onto the plate mesh's `wells` axis.

Large images are cut into overlapping tiles (halo) so stencil ops near tile
borders see real data; `stitch` folds per-tile label images back into the
full frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

__all__ = ["TileSpec", "TileSource", "tile_image", "stitch_labels"]


@dataclass(frozen=True)
class TileSpec:
    """Static tiling geometry."""

    tile: int = 2048
    halo: int = 0
    batch: int = 8


def tile_image(img: np.ndarray, spec: TileSpec) -> tuple[np.ndarray, list[tuple[int, int]]]:
    """Cut (C, H, W) into (N, C, tile+2*halo, tile+2*halo) tiles and their
    (y0, x0) origins. Edges are reflect-padded to the fixed shape."""
    if img.ndim == 2:
        img = img[None]
    c, h, w = img.shape
    t, halo = spec.tile, spec.halo
    origins = [(y, x) for y in range(0, h, t) for x in range(0, w, t)]
    out = np.empty((len(origins), c, t + 2 * halo, t + 2 * halo), dtype=img.dtype)
    padded = np.pad(
        img, ((0, 0), (halo, halo + t), (halo, halo + t)), mode="reflect"
    )
    for i, (y, x) in enumerate(origins):
        out[i] = padded[:, y : y + t + 2 * halo, x : x + t + 2 * halo]
    return out, origins


def _union_seam_pairs(full: np.ndarray, seams_y: list[int], seams_x: list[int]) -> np.ndarray:
    """Union-find over 8-connected label pairs across tile seams.

    Returns the relabeled image: components split by tiling are merged and
    labels are compacted to consecutive 1..N in first-pixel scan order.
    """
    h, w = full.shape
    pairs = []
    for y0 in seams_y:
        if not 0 < y0 < h:
            continue
        a = full[y0 - 1, :]
        b = full[y0, :]
        for dx in (-1, 0, 1):
            bb = np.roll(b, -dx)
            if dx > 0:
                bb[-dx:] = 0
            elif dx < 0:
                bb[:-dx] = 0
            sel = (a > 0) & (bb > 0)
            if sel.any():
                pairs.append(np.stack([a[sel], bb[sel]], axis=1))
    for x0 in seams_x:
        if not 0 < x0 < w:
            continue
        a = full[:, x0 - 1]
        b = full[:, x0]
        for dy in (-1, 0, 1):
            bb = np.roll(b, -dy)
            if dy > 0:
                bb[-dy:] = 0
            elif dy < 0:
                bb[:-dy] = 0
            sel = (a > 0) & (bb > 0)
            if sel.any():
                pairs.append(np.stack([a[sel], bb[sel]], axis=1))

    n = int(full.max())
    parent = np.arange(n + 1, dtype=np.int64)

    def find(v: int) -> int:
        root = v
        while parent[root] != root:
            root = parent[root]
        while parent[v] != root:  # path compression
            parent[v], v = root, parent[v]
        return root

    if pairs:
        for a, b in np.unique(np.concatenate(pairs), axis=0):
            ra, rb = find(int(a)), find(int(b))
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)

    roots = np.array([find(v) for v in range(n + 1)], dtype=np.int64)
    merged = roots[full]

    # compact to consecutive labels in first-pixel scan order
    flat = merged.ravel()
    first_pos = np.full(n + 1, flat.size, dtype=np.int64)
    nz = np.nonzero(flat)[0]
    np.minimum.at(first_pos, flat[nz], nz)
    live = np.nonzero(first_pos < flat.size)[0]
    order = live[np.argsort(first_pos[live])]
    remap = np.zeros(n + 1, dtype=np.int64)
    remap[order] = np.arange(1, len(order) + 1)
    return remap[merged]


def stitch_labels(
    tiles: np.ndarray, origins: list[tuple[int, int]], shape: tuple[int, int], spec: TileSpec
) -> np.ndarray:
    """Reassemble per-tile label images into one full-frame labeling.

    Tile-local labels are first made globally unique by per-tile offsets,
    then components that straddle a tile seam are merged by a union-find
    over 8-connected label pairs along every seam, and labels are compacted
    to 1..N in scan order - so a cell crossing tile borders is ONE cell,
    matching an untiled labeling exactly (up to the labeler's own output).
    """
    h, w = shape
    t, halo = spec.tile, spec.halo
    full = np.zeros((h, w), dtype=np.int64)
    offset = 0
    for tile_lbl, (y, x) in zip(tiles, origins):
        core = np.asarray(tile_lbl)
        if halo:
            core = core[halo:-halo, halo:-halo]
        hh = min(t, h - y)
        ww = min(t, w - x)
        core = core[:hh, :ww].astype(np.int64)
        n = int(core.max())
        full[y : y + hh, x : x + ww] = np.where(core > 0, core + offset, 0)
        offset += n

    seams_y = sorted({y for (y, _) in origins if y > 0})
    seams_x = sorted({x for (_, x) in origins if x > 0})
    if not seams_y and not seams_x:
        return full
    return _union_seam_pairs(full, seams_y, seams_x)


class TileSource:
    """Iterate fixed-shape batches over a sequence of (key, image) pairs.

    Yields (keys, batch) where batch is (B, C, tile+2h, tile+2h) uint16; the
    final batch is padded by repeating its last tile (callers slice by
    len(keys)).
    """

    def __init__(self, spec: TileSpec | None = None):
        self.spec = spec or TileSpec()

    def batches(
        self, items: Iterator[tuple[str, np.ndarray]]
    ) -> Iterator[tuple[list[tuple[str, tuple[int, int], tuple[int, int]]], np.ndarray]]:
        spec = self.spec
        keys: list[tuple[str, tuple[int, int], tuple[int, int]]] = []
        tiles: list[np.ndarray] = []
        for key, img in items:
            img = np.asarray(img)
            if img.ndim == 2:
                img = img[None]
            tiled, origins = tile_image(img, spec)
            for tile_arr, origin in zip(tiled, origins):
                keys.append((key, origin, img.shape[-2:]))
                tiles.append(tile_arr)
                if len(tiles) == spec.batch:
                    yield keys, np.stack(tiles)
                    keys, tiles = [], []
        if tiles:
            real = list(keys)
            while len(tiles) < spec.batch:
                tiles.append(tiles[-1])
            yield real, np.stack(tiles)
