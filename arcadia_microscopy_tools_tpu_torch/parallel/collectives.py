"""Cross-rank collectives for row-sharded image compute.

Counterpart of `arcadia_microscopy_tools_tpu/parallel/collectives.py`.
When one large image is sharded across ranks along Y, stencil ops need
their neighbours' border rows (a halo exchange) and global statistics
(percentiles, histogram thresholds) need a two-pass reduction: local
histograms, an all-reduce, then a threshold decision identical on every
rank.

The JAX functions run inside `shard_map` over a mesh axis; these take the
process group of that axis (`Mesh.group("space")`), and None for a single
shard, which communicates nothing. Every exchange is an all-gather or an
all-reduce: gloo runs both on CUDA tensors (through host memory) as well as
on CPU tensors, and NCCL on the card, so two ranks sharing one card run
the same code as ranks with a card each.
"""

from __future__ import annotations

import bisect
import itertools

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.filters import _pad_last2, gaussian_radius, gaussian_valid
from ..ops.stats import histogram_int
from ..ops.threshold import otsu_from_hist

__all__ = [
    "all_gather_rows",
    "halo_exchange",
    "halo_rows_nhwc",
    "make_sharded_otsu",
    "sharded_histogram_uint16",
    "sharded_otsu_threshold",
    "sharded_gaussian_filter",
]

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def group_rank_size(group) -> tuple[int, int]:
    """(this rank's index in `group`, the group's size); (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(n, *t.shape): every rank's `t` in group order (the same shape on
    every rank)."""
    if group is None:
        return t[None]
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """`t` reduced elementwise over the group ("sum", "min" or "max"), as
    a new tensor."""
    if group is None:
        return t
    t = t.clone().contiguous()
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def halo_rows(x: torch.Tensor, halo: int, group, fill=None) -> torch.Tensor:
    """`x` (..., H_local, W), one row slab of an image whose slabs lie on
    the ranks of `group` in order, padded to (..., H_local + 2 * halo, W)
    with the image's rows above and below it. Past the image's edges the
    rows replicate the edge (fill None) or hold `fill`.

    Any halo works: rows come from as many neighbours as they need, and
    slabs may differ in height (a ragged last shard). Each rank contributes
    its first and last min(halo, H_local) rows to one all-gather."""
    if halo == 0:
        return x
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    me, n = group_rank_size(group)
    heights = [int(v) for v in all_gather(torch.tensor([h], device=x.device), group)[:, 0]]
    k = min(halo, max(heights))
    kj = [min(halo, hj) for hj in heights]
    own = min(k, h)
    pad = x.new_zeros((*lead, k - own, w))
    blocks = torch.cat([x[..., :own, :], pad, x[..., h - own :, :], pad], -2)
    gathered = all_gather(blocks, group).reshape(n, -1, 2 * k, w)

    starts = [0, *itertools.accumulate(heights)]
    total = starts[-1]
    row0 = starts[me]
    need = [*range(row0 - halo, row0), *range(row0 + h, row0 + h + halo)]
    src, pos, outside = [], [], []
    for r in need:
        out = not 0 <= r < total
        rr = min(max(r, 0), total - 1)
        j = bisect.bisect_right(starts, rr) - 1
        o = rr - starts[j]
        # rows near a slab's top sit in its first block, the others in its last
        src.append(j)
        pos.append(o if o < kj[j] else k + o - (heights[j] - kj[j]))
        outside.append(out and fill is not None)
    rows = gathered[torch.tensor(src), :, torch.tensor(pos)]  # (2 * halo, L, W)
    rows = rows.permute(1, 0, 2).reshape(*lead, 2 * halo, w)
    if any(outside):
        rows[..., torch.tensor(outside, device=x.device), :] = fill
    return torch.cat([rows[..., :halo, :], x, rows[..., halo:, :]], -2)


def all_gather_rows(t: torch.Tensor, sizes, group, dim: int = 1) -> torch.Tensor:
    """Every rank's `t` concatenated along `dim` in group order, where rank
    r's `t` holds sizes[r] entries along `dim` (the other dimensions equal):
    the rows of a row-sharded tensor, or its per-slab partial sums."""
    if group is None:
        return t
    most = max(sizes)
    pad = [0, 0] * (t.dim() - 1 - dim % t.dim()) + [0, most - t.shape[dim]]
    parts = all_gather(F.pad(t, pad), group)
    return torch.cat([p.narrow(dim, 0, k) for p, k in zip(parts, sizes)], dim)


def halo_rows_nhwc(x: torch.Tensor, group) -> tuple[torch.Tensor, int, int]:
    """`x` (B, H_local, W, C), one row slab of an NHWC image whose slabs lie
    on the ranks of `group` in order, with the neighbouring slabs' rows
    next to it: (padded, top, bottom), where top / bottom is 1 when a row
    was added above / below and 0 at the image's edge (where a SAME
    convolution pads zeros itself). One all-gather of each slab's first and
    last rows."""
    me, n = group_rank_size(group)
    if n == 1:
        return x, 0, 0
    ends = all_gather(torch.stack([x[:, 0], x[:, -1]], 1), group)  # (S, B, 2, W, C)
    top, bottom = int(me > 0), int(me < n - 1)
    rows = ([ends[me - 1][:, 1:]] if top else []) + [x] + ([ends[me + 1][:, :1]] if bottom else [])
    return torch.cat(rows, 1), top, bottom


def halo_exchange(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """Pad a Y-sharded block with `halo` rows from its neighbours.

    Input (..., H_local, W) -> output (..., H_local + 2 * halo, W). The
    outermost shards get edge-replicated rows (the single-image "nearest"
    boundary), so a sharded stencil equals the unsharded one exactly. Any
    halo works, also one taller than H_local (`halo_rows`).
    """
    return halo_rows(x, halo, group)


def sharded_histogram_uint16(x_local: torch.Tensor, group) -> torch.Tensor:
    """Global 65536-bin histogram of a sharded uint16 image: a local
    bincount, then an all-reduce of the int64 counts (exact at any size;
    the JAX function's float32 counts stay exact below 2^24 per bin)."""
    return all_reduce(histogram_int(x_local, 65536)[0], "sum", group)


def sharded_otsu_threshold(x_local: torch.Tensor, group) -> torch.Tensor:
    """Otsu threshold of a sharded uint16 image, equal to the single-image
    `threshold_otsu` because the global histogram is exact."""
    counts = sharded_histogram_uint16(x_local, group)
    centers = torch.arange(65536, dtype=torch.float32, device=x_local.device)
    return otsu_from_hist(counts, centers)


def make_sharded_otsu(mesh, axis_name: str = "space"):
    """Global Otsu over a mesh axis (convenience wrapper): a function of
    this rank's block of image rows that returns the whole image's
    threshold, the same on every rank of the axis."""
    group = mesh.group(axis_name)

    def run(x_local: torch.Tensor) -> torch.Tensor:
        return sharded_otsu_threshold(x_local, group)

    return run


def sharded_gaussian_filter(
    x_local: torch.Tensor, sigma: float, group, truncate: float = 4.0
) -> torch.Tensor:
    """Gaussian blur of a Y-sharded image: halo exchange, then the local
    convolution. Equal to `ops.filters.gaussian_filter` (mode "nearest") of
    the whole image, because interior halos carry the true neighbour rows
    and exterior halos replicate the image's edge."""
    x = x_local.to(torch.float32)
    if sigma <= 0:
        return x
    radius = gaussian_radius(sigma, truncate)
    padded = _pad_last2(halo_exchange(x, radius, group), 0, radius, "nearest")
    return gaussian_valid(padded, sigma, truncate)
