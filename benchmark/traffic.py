"""The benchmark's one traffic generator.

A traffic mix is a JSON file under `benchmark/workloads/`: the entry that
serves it, the plate (wells per plate, pool of distinct wells, where the
wells come from) and the recipe of each synthetic well. This module turns a
mix and a seed into inputs; nothing here is specific to one mix.

The well recipe is a frozen copy of the repository's synthetic plate
(noise N(mean, std) clipped at 0, Gaussian blobs of `blob_size` square and
`blob_peak` peak at uniform centres, channel 0 at full brightness and the
others scaled by U(lo, hi) per blob, truncated to uint16), drawn on the
device from a `torch.Generator` so that set-up stays short.
"""

from __future__ import annotations

import string

import numpy as np
import torch

__all__ = ["make_pool", "plate_well_ids", "pool_index"]


def plate_well_ids(rows: int, cols: int) -> list[str]:
    """The well ids of a rows x cols plate in row-major order: A01 ... H12."""
    return [f"{string.ascii_uppercase[r]}{c + 1:02d}" for r in range(rows) for c in range(cols)]


def pool_index(traffic: dict) -> dict[str, int]:
    """Which pool well each well id of the plate shows: the ids cycle over
    the pool, so consecutive batches hold different wells."""
    ids = plate_well_ids(traffic["plate_rows"], traffic["plate_cols"])
    return {w: k % traffic["pool_wells"] for k, w in enumerate(ids)}


def _one_well(recipe: dict, shape: tuple[int, int, int], g: torch.Generator, device) -> torch.Tensor:
    c, h, w = shape
    r = recipe["blob_size"] // 2
    n = recipe["blobs"]
    base = torch.randn((c, h, w), generator=g, device=device, dtype=torch.float32)
    base = (base * recipe["noise_std"] + recipe["noise_mean"]).clamp_min(0.0)
    cy = torch.randint(r, h - r, (n,), generator=g, device=device)
    cx = torch.randint(r, w - r, (n,), generator=g, device=device)
    lo, hi = recipe["channel_scale"]
    scale = torch.rand((n, c), generator=g, device=device) * (hi - lo) + lo
    scale[:, 0] = 1.0
    d = torch.arange(2 * r, device=device)
    yy, xx = torch.meshgrid(d, d, indexing="ij")
    blob = recipe["blob_peak"] * torch.exp(
        -((yy - r) ** 2 + (xx - r) ** 2).to(torch.float64) / recipe["blob_spread"]
    )
    idx = ((cy[:, None, None] - r + yy) * w + (cx[:, None, None] - r + xx)).reshape(-1)
    # blobs are summed as fixed-point integers: integer atomics add in any
    # order to the same total, so a seed gives the same wells on every run
    fixed = 1 << 16
    acc = torch.zeros((c, h * w), dtype=torch.int64, device=device)
    for ch in range(c):
        vals = torch.round(blob[None] * scale[:, ch, None, None].double() * fixed).long()
        acc[ch].index_add_(0, idx, vals.reshape(-1))
    img = torch.floor(base.double() + acc.reshape(c, h, w).double() / fixed)
    return img.clamp(0, 65535).to(torch.int32)


def make_pool(traffic: dict, seed: int, device) -> np.ndarray:
    """(pool_wells, C, H, W) uint16 host array of distinct wells from `seed`."""
    recipe = traffic["well"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    shape = (recipe["channels"], recipe["height"], recipe["width"])
    pool = np.empty((traffic["pool_wells"], *shape), dtype=np.uint16)
    for k in range(traffic["pool_wells"]):
        pool[k] = _one_well(recipe, shape, g, device).cpu().numpy()  # int32 -> uint16, exact
    return pool
