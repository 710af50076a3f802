"""The yardstick's arithmetic for Cellpose-SAM: operations and bytes of one
tile and of one block's attention, and the tiles Cellpose cuts an image
into. Counted from the configuration's sizes and the image shape alone,
never from the program (its tile counter is not read), so that a change to
the program cannot move what it is measured against. The peaks are
`arithmetic.py`'s.

Per 256 x 256 tile at the published sizes (width 1024, 24 blocks, 16 heads
of 64, MLP 4096, patch 8, neck 256, 3 maps): 0.727e12 operations, of them
per block 25.77e9 in the projections and the MLP, 4.295e9 in Q K^T and
P V and 0.134e9 in the relative-position terms Q Rh^T and Q Rw^T.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.arithmetic import H100_BF16_FLOP_PER_S, H100_HBM_BYTES_PER_S


def _grid(cfg: dict) -> int:
    return cfg["tile"] // cfg["patch"]


def attention_flop(cfg: dict) -> float:
    """One block's attention on one tile: Q K^T and P V over the grid^2
    tokens of every head, and each query's two relative-position rows
    (grid offsets each of height and width) against its q."""
    n, d, heads = _grid(cfg) ** 2, cfg["width"] // cfg["heads"], cfg["heads"]
    return heads * (2.0 * 2 * n * n * d + 2.0 * 2 * n * _grid(cfg) * d)


def attention_bytes(cfg: dict) -> float:
    """One block's attention on one tile in bfloat16: q, k, v read and o
    written once, and the two resized tables."""
    n, width, d = _grid(cfg) ** 2, cfg["width"], cfg["width"] // cfg["heads"]
    return 2.0 * (4 * n * width + 2 * (2 * _grid(cfg) - 1) * d)


def attention_bound_s(cfg: dict) -> float:
    """Least time of one block's attention on one tile: the larger of its
    operations at the bf16 peak and its bytes at the memory rate."""
    return max(attention_flop(cfg) / H100_BF16_FLOP_PER_S,
               attention_bytes(cfg) / H100_HBM_BYTES_PER_S)


def tile_flop(cfg: dict) -> float:
    """Model operations of one tile: patch embedding, every block's
    projections, MLP and attention, the neck and the readout (2 per
    multiply-add; LayerNorm, GELU, softmax and the blend left out)."""
    n, width = _grid(cfg) ** 2, cfg["width"]
    patch = 2.0 * n * 3 * cfg["patch"] ** 2 * width
    dense = 2.0 * n * width * (3 * width + width + 2 * cfg["mlp"])
    neck = 2.0 * n * cfg["neck"] * (width + 9 * cfg["neck"])
    readout = 2.0 * n * cfg["neck"] * cfg["out_maps"] * cfg["patch"] ** 2
    return patch + cfg["depth"] * (dense + attention_flop(cfg)) + neck + readout


def tile_starts(length: int, bsize: int, overlap: float) -> np.ndarray:
    """Cellpose's `make_tiles` starts along one axis (after a pad to bsize)."""
    length = max(length, bsize)
    overlap = min(0.5, max(0.05, overlap))
    n = 1 if length <= bsize else int(math.ceil((1.0 + 2 * overlap) * length / bsize))
    return np.linspace(0, length - bsize, n).astype(int)


def tiles_per_image(height: int, width: int, cfg: dict) -> int:
    """Tiles Cellpose cuts one height x width image into."""
    return (len(tile_starts(height, cfg["tile"], cfg["tile_overlap"]))
            * len(tile_starts(width, cfg["tile"], cfg["tile_overlap"])))
