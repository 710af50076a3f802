"""Cellpose's tiling and taper blend, on the device for a whole chunk.

Cellpose runs its network on fixed square tiles (Cellpose-SAM: 256 x 256)
and blends the tiles' outputs back (cellpose/transforms.py `make_tiles`,
`average_tiles`, `_taper_mask`):

- per axis of length L > bsize, n = ceil((1 + 2 * overlap) * L / bsize)
  tiles (overlap clamped to [0.05, 0.5]; 0.1 gives 10 tiles at L = 2048)
  start at `np.linspace(0, L - bsize, n).astype(int)`; one tile starts at
  0 where L <= bsize;
- each tile's output is weighted by the taper mask, the outer product of
  1 / (1 + exp((|x - mean(x)| - (B / 2 - 20)) / sigma)) over x = 0..B-1,
  B = max(224, bsize), cropped to the tile's centre (sigma 7.5), and the
  weighted sum is divided by the summed weights.

`tile_starts` and `taper_mask` are those numbers, computed on the host as
Cellpose computes them (numpy, float64); `make_tiles` cuts every tile of a
(N, C, H, W) chunk in one gather, and `average_tiles` blends (N x tiles,
C, bsize, bsize) outputs back in float32 on the tensors' device, tile by
tile in Cellpose's order (rows of tiles, then columns). An image smaller
than bsize on an axis is padded with zeros to bsize on that axis, centred
(the half before rounded down), before tiling, and the blend is cropped
back: the segmentation entry does this (`pad_to_tile`, `crop_padding`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "average_tiles",
    "crop_padding",
    "make_tiles",
    "pad_to_tile",
    "taper_mask",
    "tile_count",
    "tile_starts",
]


@functools.lru_cache(maxsize=64)
def tile_starts(length: int, bsize: int, overlap: float = 0.1) -> tuple[int, ...]:
    """Cellpose's tile starts along an axis of `length` >= bsize pixels."""
    if length < bsize:
        raise ValueError(f"an axis of {length} pixels is shorter than the {bsize}-pixel tile; "
                         "pad it first (pad_to_tile)")
    overlap = min(0.5, max(0.05, overlap))
    n = 1 if length <= bsize else int(np.ceil((1.0 + 2 * overlap) * length / bsize))
    return tuple(int(s) for s in np.linspace(0, length - bsize, n).astype(int))


def tile_count(height: int, width: int, bsize: int, overlap: float = 0.1) -> int:
    """Tiles of one image of height x width (after padding to bsize)."""
    return (len(tile_starts(max(height, bsize), bsize, overlap))
            * len(tile_starts(max(width, bsize), bsize, overlap)))


@functools.lru_cache(maxsize=16)
def taper_mask(ly: int, lx: int, sigma: float = 7.5) -> np.ndarray:
    """Cellpose's `_taper_mask` (float64, (ly, lx))."""
    b = max(224, max(ly, lx))
    xm = np.arange(b)
    xm = np.abs(xm - xm.mean())
    mask = 1 / (1 + np.exp((xm - (b / 2 - 20)) / sigma))
    mask = mask * mask[:, np.newaxis]
    return mask[b // 2 - ly // 2 : b // 2 + ly // 2 + ly % 2,
                b // 2 - lx // 2 : b // 2 + lx // 2 + lx % 2]


def pad_to_tile(x: torch.Tensor, bsize: int) -> tuple[torch.Tensor, tuple[int, int]]:
    """(N, C, H, W) zero-padded to at least bsize on each axis, centred;
    returns it and the (top, left) offsets of the image in it."""
    h, w = x.shape[-2:]
    top, left = max(0, bsize - h) // 2, max(0, bsize - w) // 2
    if h >= bsize and w >= bsize:
        return x, (0, 0)
    pad = (left, max(0, bsize - w) - left, top, max(0, bsize - h) - top)
    return F.pad(x, pad), (top, left)


def crop_padding(y: torch.Tensor, offsets: tuple[int, int], hw: tuple[int, int]) -> torch.Tensor:
    """The image's (h, w) window of a padded (N, C, Hp, Wp) tensor."""
    top, left = offsets
    return y[..., top : top + hw[0], left : left + hw[1]]


def make_tiles(x: torch.Tensor, bsize: int, overlap: float = 0.1) -> torch.Tensor:
    """(N, C, H, W), H and W >= bsize -> (N * ny * nx, C, bsize, bsize)
    tiles, image by image, rows of tiles then columns."""
    n, c, h, w = x.shape
    ys = torch.tensor(tile_starts(h, bsize, overlap), device=x.device)
    xs = torch.tensor(tile_starts(w, bsize, overlap), device=x.device)
    r = torch.arange(bsize, device=x.device)
    rows = (ys[:, None] + r).reshape(-1)
    cols = (xs[:, None] + r).reshape(-1)
    t = x[:, :, rows][..., cols].reshape(n, c, len(ys), bsize, len(xs), bsize)
    return t.permute(0, 2, 4, 1, 3, 5).reshape(-1, c, bsize, bsize)


def average_tiles(y: torch.Tensor, n: int, h: int, w: int, overlap: float = 0.1,
                  sigma: float = 7.5) -> torch.Tensor:
    """(N * ny * nx, C, b, b) tile outputs -> (N, C, H, W) float32 blend."""
    _, c, b, _ = y.shape
    ys, xs = tile_starts(h, b, overlap), tile_starts(w, b, overlap)
    if y.shape[0] != n * len(ys) * len(xs):
        raise ValueError(f"{y.shape[0]} tiles, expected {n} x {len(ys)} x {len(xs)}")
    mask = torch.from_numpy(taper_mask(b, b, sigma).astype(np.float32)).to(y.device)
    weighted = (y.float() * mask).view(n, len(ys), len(xs), c, b, b)
    out = torch.zeros((n, c, h, w), dtype=torch.float32, device=y.device)
    for j, y0 in enumerate(ys):
        for i, x0 in enumerate(xs):
            out[..., y0 : y0 + b, x0 : x0 + b] += weighted[:, j, i]
    return out / _tile_weights(h, w, b, overlap, sigma, y.device)


@functools.lru_cache(maxsize=16)
def _tile_weights(h: int, w: int, b: int, overlap: float, sigma: float, device) -> torch.Tensor:
    """The summed taper weights of every pixel (Cellpose's `Navg`), float32."""
    navg = np.zeros((h, w))
    mask = taper_mask(b, b, sigma)
    for y0 in tile_starts(h, b, overlap):
        for x0 in tile_starts(w, b, overlap):
            navg[y0 : y0 + b, x0 : x0 + b] += mask
    return torch.from_numpy(navg.astype(np.float32)).to(device)
