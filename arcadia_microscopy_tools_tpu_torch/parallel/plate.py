"""End-to-end plate pipeline on one device or on a mesh of ranks.

Counterpart of `arcadia_microscopy_tools_tpu/parallel/plate.py`: well images
-> a mask -> per-cell morphology and per-channel intensity, for a whole
microplate. A batch of wells is one (B, C, H, W) tensor on the device. Two
methods make the mask:

- "classical": DoG / percentile rescale / global threshold (optionally a
  binary opening) -> connected components -> foreground compaction;
- "unet": a 1-99 percentile stretch from the exact integer histogram ->
  the U-Net forward -> mask reconstruction in the compact domain
  (`models.flows.compute_masks_sparse_compact`), whose listed pixels are
  measured directly.

On a mesh (`parallel.mesh`; one rank per device, `torch.distributed`), each
rank decodes, stages and runs only its block of every batch, and the packed
per-cell columns and health scalars are all-gathered, so every rank builds
the same `PlateResults`. With space_parallelism > 1 both methods run on row
slabs of each well: the JAX package leaves those collectives to XLA's
partitioner and turns its Pallas kernels off there; here the cross-shard
steps are written out and the CUDA kernels run on every slab. The classical
program (`_classical_rows`) runs the fused frontend on its slab, or gathers
the segmentation channel and runs the staged mask whole on every rank of
the space group; the U-Net program (`_unet_rows`) runs the forward on its
slab (halo rows, gathered GroupNorm partials), lists its active pixels, and
runs the compact mask tail whole on every rank. Packed columns and health
equal the single device's bit for bit.

The runner keeps the reference's host-side contract:
- per-well failure isolation: a failed well yields None and a
  SegmentationWarning, and the run continues;
- checkpoint/resume: per-well CSV tables plus a `manifest.json` under
  `checkpoint_dir`, in the reference's format, so a plate begun by either
  runner resumes in the other (on a mesh rank 0 reads and writes them and
  shares what it read);
- capacity escalation: wells whose health scalars report a foreground,
  cell-count or boundary-edge overflow (or a CC certificate failure) are
  re-dispatched with 4x and then 16x capacities before they are failed;
- decode prefetch on a thread pool, which also stages each batch into
  reused (on a CUDA card page-locked) host buffers, and per-stage timings.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import pandas as pd
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.channels import Channel
from ..core.microplate import MicroplateLayout
from ..exceptions import SegmentationWarning
from ..ops.basic import rescale_by_percentile, subtract_background_dog
from ..ops.compaction import compact_by_root
from ..ops.filters import (
    _pad_last2,
    centre_on_midrange,
    gaussian_radius,
    gaussian_valid,
    to_float,
)
from ..ops.fused import (
    HIST_THRESHOLD_METHODS,
    _percentile_from_cum,
    cutoff_from_hist,
    fused_classical_mask,
    q0_histograms,
    quantize,
)
from ..ops.labeling import component_roots
from ..ops.morphology import binary_opening, disk
from ..ops.regionprops import measure_compacted, measure_segments, perimeter_classes
from ..ops.threshold import GLOBAL_METHODS
from ..utils import get_tqdm, resolve_device
from ..utils.profiling import StageTimer
from .collectives import all_gather, all_reduce, group_rank_size, halo_rows
from .collectives import all_gather_rows
from .mesh import (
    HOST_AXIS,
    SPACE_AXIS,
    Mesh,
    MeshConfig,
    Shard,
    create_mesh,
    plate_sharding_multihost,
    row_bounds,
    well_sharding,
)

logger = logging.getLogger(__name__)

__all__ = [
    "PlateRunConfig",
    "PlateRunner",
    "PlateResults",
    "foreground_capacity",
    "resolve_device",
]

# column order of the packed per-cell output tensor (see _build_well_program)
_PROP_COLUMNS = [
    "label",
    "valid",
    "area",
    "centroid_y",
    "centroid_x",
    "perimeter",
    "eccentricity",
    "axis_major_length",
    "axis_minor_length",
    "orientation",
    "bbox_min_row",
    "bbox_min_col",
    "bbox_max_row",
    "bbox_max_col",
    "extent",
]
_INTENSITY_STATS = [
    "intensity_mean",
    "intensity_max",
    "intensity_min",
    "intensity_std",
]


@dataclass(frozen=True)
class _PackedColumns:
    """The well program's packed per-cell columns: `_PROP_COLUMNS`, then
    `_INTENSITY_STATS` of each channel of `measure_idx`, in that order."""

    measure_idx: tuple[int, ...]

    @classmethod
    def of(cls, config: PlateRunConfig, n_channels: int) -> _PackedColumns:
        """The columns of wells of `n_channels` channels under `config`."""
        idx = config.measure_channel_indices
        return cls(tuple(idx) if idx is not None else tuple(range(n_channels)))

    @property
    def width(self) -> int:
        return len(_PROP_COLUMNS) + len(_INTENSITY_STATS) * len(self.measure_idx)

    def pack(self, props: dict, stats: list[dict]) -> torch.Tensor:
        """(..., max_cells, width) float32 from the measurement's columns."""
        columns = [props[name].to(torch.float32) for name in _PROP_COLUMNS]
        columns += [stats[k][stat].to(torch.float32)
                    for k in range(len(self.measure_idx)) for stat in _INTENSITY_STATS]
        return torch.stack(columns, -1)

    def unpack(self, row: np.ndarray) -> tuple[dict, dict]:
        """One well's (max_cells, width) host row -> its property columns and
        {channel index: {stat: column}}."""
        props = {name: row[:, i] for i, name in enumerate(_PROP_COLUMNS)}
        props["valid"] = props["valid"] > 0.5
        base, n = len(_PROP_COLUMNS), len(_INTENSITY_STATS)
        intensity = {ci: {stat: row[:, base + k * n + j] for j, stat in enumerate(_INTENSITY_STATS)}
                     for k, ci in enumerate(self.measure_idx)}
        return props, intensity

# wells per device dispatch when PlateRunConfig.batch_size is None
DEFAULT_BATCH = 8


@dataclass(frozen=True)
class PlateRunConfig:
    """Configuration for a plate run; the same fields and defaults as the
    reference's PlateRunConfig, so `PlateRunConfig(**asdict(reference))`
    works.

    Attributes:
        seg_channel_index: Index of the channel used for segmentation.
        method: "classical" (DoG -> rescale -> threshold -> CC) or "unet"
            (U-Net + flow tracking).
        threshold_method: Global threshold for the classical path: a
            histogram method or "li" ("li", like any opening, takes the
            staged branch).
        low_sigma / high_sigma: DoG sigmas for background subtraction.
        opening_radius: Binary opening radius for mask cleanup (0 = none).
        remove_edge_cells: Drop cells touching image borders.
        max_cells: Per-well cell capacity (padded measurements).
        batch_size: Wells per device dispatch (None = DEFAULT_BATCH).
        measure_channel_indices: Channels to quantify per cell (None = all).
        min_size: Minimum object size in pixels (classical cleanup and the
            U-Net mask filter).
        cellprob_threshold / flow_threshold / niter: U-Net mask
            reconstruction settings.
        fg_cap_fraction: Foreground-pixel capacity of the compacted
            measurement path (and of the U-Net's active-pixel list), as a
            fraction of the image area.
        pair_cap: Capacity for connected-components boundary-merge edges.
    """

    seg_channel_index: int = 0
    method: str = "classical"
    threshold_method: str = "otsu"
    low_sigma: float = 1.0
    high_sigma: float = 16.0
    opening_radius: int = 0
    remove_edge_cells: bool = False
    max_cells: int = 1024
    batch_size: int | None = None
    measure_channel_indices: tuple[int, ...] | None = None
    min_size: int = 15
    cellprob_threshold: float = 0.0
    flow_threshold: float = 0.4
    niter: int = 200
    fg_cap_fraction: float = 0.0625
    pair_cap: int = 16384


# the main thread's steps in `PlateRunner.run`: profiler range -> timings key
_RUN_SPANS = {
    "plate.fetch_wait": "fetch_wait_s",
    "plate.stage": "stage_s",
    "plate.h2d": "h2d_s",
    "plate.launch": "launch_s",
    "plate.readback": "readback_s",
    "plate.gather": "gather_s",
    "plate.assemble": "assemble_s",
}


class PlateResults:
    """Per-well measurement tables plus run metadata."""

    def __init__(self, tables: dict[str, pd.DataFrame | None], timings: dict[str, float]):
        self.tables = tables
        self.timings = timings

    @property
    def failed_wells(self) -> list[str]:
        return [w for w, t in self.tables.items() if t is None]

    def to_dataframe(self) -> pd.DataFrame:
        """All wells concatenated with a well_id column."""
        frames = []
        for well_id, table in self.tables.items():
            if table is None or table.empty:
                continue
            t = table.copy()
            t.insert(0, "well_id", well_id)
            frames.append(t)
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)

    def summary(self) -> pd.DataFrame:
        """Per-well cell counts and mean morphology."""
        rows = []
        for well_id, table in self.tables.items():
            if table is None:
                rows.append({"well_id": well_id, "num_cells": -1})
                continue
            row = {"well_id": well_id, "num_cells": len(table)}
            for col in ("area", "circularity"):
                if col in table:
                    row[f"mean_{col}"] = float(table[col].mean()) if len(table) else np.nan
            rows.append(row)
        return pd.DataFrame(rows)


def _check_supported(config: PlateRunConfig) -> None:
    """Raise for unknown methods and threshold names."""
    if config.method not in ("classical", "unet"):
        raise ValueError(f"Unknown segmentation method: {config.method!r}")
    if config.threshold_method not in GLOBAL_METHODS:
        raise ValueError(f"Unknown threshold method: {config.threshold_method!r}")


def foreground_capacity(config: PlateRunConfig, h: int, w: int) -> int:
    """Compaction slots per well: `fg_cap_fraction` of the image, rounded up
    to the reference's 8192-slot reduction block, at most the image."""
    cap = max(1, int(h * w * config.fg_cap_fraction))
    return min(-(-cap // 8192) * 8192, h * w)


def _staged_mask(seg_img: torch.Tensor, config: PlateRunConfig) -> torch.Tensor:
    """One well's mask by separate stages, for the configurations the fused
    histogram frontend does not cover (a non-histogram threshold, or a
    binary opening): DoG background subtraction -> percentile rescale ->
    uint16 quantisation -> image-level threshold -> optional opening."""
    x = subtract_background_dog(seg_img, low_sigma=config.low_sigma, high_sigma=config.high_sigma)
    x = rescale_by_percentile(x, (0.5, 99.9))
    # quantise so that the integer-exact histogram thresholds apply; 16-bit
    # quantisation is far below the noise level
    q = (x * 65535.0).to(torch.uint16)
    mask = q.to(torch.float32) > GLOBAL_METHODS[config.threshold_method](q)
    if config.opening_radius > 0:
        mask = binary_opening(mask, disk(config.opening_radius))
    return mask


def unet_network(unet_params=None, device: str | torch.device | None = None):
    """The plate runner's U-Net (bfloat16 forward) on `device` (None means
    the CUDA card, and raises when there is none).

    `unet_params` is the JAX package's parameter tree as numpy arrays (a
    nested dict / list, or flattened to dotted keys as in the `.npz`
    checkpoints) or the port's `UNet` state_dict (torch tensors, as
    `models.weights.load_weights` returns). None gives seeded weights
    (`torch.Generator` seed 0; the numbers differ from the JAX package's
    `seeded_params()` by design, see `models.unet.UNet`)."""
    from ..models.unet import UNet, UNetConfig
    from ..models.weights import flatten_tree, state_dict_from_tree

    device = resolve_device(device)
    if unet_params is None:
        net = UNet(UNetConfig(), generator=torch.Generator().manual_seed(0))
    else:
        if isinstance(unet_params, Mapping) and all(
            isinstance(v, torch.Tensor) for v in unet_params.values()
        ):
            state = dict(unet_params)
        else:
            state = state_dict_from_tree(flatten_tree(unet_params))
        net = UNet(UNetConfig(), generator=torch.Generator())
        net.load_state_dict(state)
    return net.to(device).eval()


def _normalised(seg: torch.Tensor, group=None, n: int | None = None) -> torch.Tensor:
    """(B, H, W) uint16-valued float32 frames stretched to [0, 1] between
    each frame's 1st and 99th percentiles, read from its exact integer
    histogram (np.percentile's values), clipped in float32. For row slabs
    of frames of n pixels the slabs of `group` add up their counts."""
    b, h, w = seg.shape
    n = h * w if n is None else n
    values = seg.reshape(b, h * w).long() + 65536 * torch.arange(b, device=seg.device)[:, None]
    counts = torch.bincount(values.reshape(-1), minlength=65536 * b).reshape(b, 65536)
    counts = all_reduce(counts, "sum", group)
    cum = torch.cumsum(counts, -1).to(torch.float32)  # exact below 2^24 pixels
    p1 = _percentile_from_cum(cum, 1.0, n)[:, None, None]
    p99 = _percentile_from_cum(cum, 99.0, n)[:, None, None]
    return ((seg - p1) / torch.clamp(p99 - p1, min=1e-6)).clamp(0.0, 1.0)


def _unet_forward(seg: torch.Tensor, network) -> torch.Tensor:
    """The U-Net's (B, H, W, 3) output on (B, H, W) float32 frames: the
    stretch, an edge pad to the U-Net's multiple of 8, the forward on the
    replicated grayscale (B, H, W, 3) input, and the crop."""
    _, h, w = seg.shape
    x = _normalised(seg)
    ph, pw = (-h) % 8, (-w) % 8
    if ph or pw:
        x = F.pad(x[:, None], (0, pw, 0, ph), mode="replicate")[:, 0]
    return network(x[..., None].expand(-1, -1, -1, 3))[:, :h, :w]


def _unet_masks(out: torch.Tensor, config: PlateRunConfig):
    """Compact U-Net masks of the forward's output: mask reconstruction in
    the compact domain with the border filter folded in."""
    from ..models.flows import compute_masks_sparse_compact

    _, h, w, _ = out.shape
    return compute_masks_sparse_compact(
        out,
        foreground_capacity(config, h, w),
        cellprob_threshold=config.cellprob_threshold,
        flow_threshold=config.flow_threshold,
        niter=config.niter,
        max_cells=config.max_cells,
        min_size=config.min_size,
        clear_border_labels=config.remove_edge_cells,
    )


def measure_unet_masks(labels, lab_c, idx, valid, stack: torch.Tensor, max_cells: int):
    """Per-cell measurement of compact U-Net masks: the listed pixels sorted
    by (label, flat index) as one int64 key, then `measure_compacted` with
    the roots image `labels - 1` (H * W where there is no label). Returns
    measure_compacted's (props, intensity)."""
    b, h, w = labels.shape
    n = h * w
    key = torch.where(valid, lab_c.long(), 0) * (n + 1) + torch.where(valid, idx, n)
    key = torch.sort(key, 1).values
    roots = torch.where(labels > 0, labels - 1, n)
    # padding slots (label 0) are not measured; their index only has to be in range
    idx_s = (key % (n + 1)).clamp_max(n - 1)
    return measure_compacted(key // (n + 1), idx_s, roots, stack, max_cells, w)


@dataclass(frozen=True)
class RowSlab:
    """Slab `index` of the row slabs `bounds` = (0, ..., height) of wells
    (`mesh.row_bounds`), this rank's; the slabs lie, in order, on the ranks
    of `group` (the mesh's space group)."""

    group: Any
    index: int
    bounds: tuple[int, ...]

    @property
    def row0(self) -> int:
        return self.bounds[self.index]

    @property
    def height(self) -> int:
        return self.bounds[-1]

    @property
    def heights(self) -> list[int]:
        return [b - a for a, b in zip(self.bounds, self.bounds[1:])]


def unet_row_align(w: int) -> int:
    """The rows U-Net row slabs of wells `w` columns wide start on a
    multiple of: 16, so that max-pooling pairs rows alike and every conv
    call's tiles (16 full-resolution rows at each level) are a run of the
    whole image's; and the rows of one partial of the moments kernel at the
    forward's padded width (a power of two; more than 16 only below 256
    columns)."""
    from ..models.gn_cuda import lane_rows

    return max(16, lane_rows(w + (-w) % 8))


def _row_slab_dog(seg: torch.Tensor, config: PlateRunConfig, slab: RowSlab) -> torch.Tensor:
    """The DoG of each well's rows on this slab: the midrange from every
    slab, then each Gaussian on the slab padded with its neighbours' rows
    (the image's edge rows past its ends) and cropped back - the same
    convolution inputs, so the same bits, as the whole image's."""
    group = slab.group
    flat = seg.flatten(1)
    lo = all_reduce(flat.amin(1), "min", group)
    hi = all_reduce(flat.amax(1), "max", group)
    centred = centre_on_midrange(seg, lo, hi)
    sigmas = (config.low_sigma, config.high_sigma)
    radii = [gaussian_radius(s) if s > 0 else 0 for s in sigmas]
    halo = max(radii)
    padded = halo_rows(centred, halo, group)
    hs = seg.shape[1]

    def blur(sigma: float, r: int) -> torch.Tensor:
        if sigma <= 0:
            return centred
        rows = padded[:, halo - r : halo + hs + r]
        return gaussian_valid(_pad_last2(rows, 0, r, "nearest"), sigma)

    return blur(sigmas[0], radii[0]) - blur(sigmas[1], radii[1])


def _merge_row_slabs(roots: torch.Tensor, n: int, group) -> torch.Tensor:
    """Relabel (B, H_local, W) int64 component roots, global linear indices
    of this slab's components (sentinel n on background), to the roots of
    the whole image: pairs of 8-connected labels across every slab edge are
    gathered, every rank runs the same exact min-label union over them to
    its fixpoint (`labeling._merge_boundary_pairs` one level up, uncapped),
    and every pixel takes its merged root."""
    _, size = group_rank_size(group)
    if size == 1:
        return roots
    b, _, w = roots.shape
    edges = all_gather(torch.stack([roots[:, 0], roots[:, -1]], 1), group)  # (S, B, 2, W)
    upper, lower = edges[:-1, :, 1], edges[1:, :, 0]  # each slab's last row, the next one's first
    fill = lower.new_full((*lower.shape[:-1], 1), n)
    pairs_b = [lower, torch.cat([lower[..., 1:], fill], -1), torch.cat([fill, lower[..., :-1]], -1)]
    la = upper.repeat(3, 1, 1).transpose(0, 1).reshape(b, -1)
    lb = torch.cat(pairs_b).transpose(0, 1).reshape(b, -1)
    real = (la < n) & (lb < n) & (la != lb)
    if not bool(real.any()):
        return roots
    offset = torch.arange(b, device=roots.device, dtype=torch.int64)[:, None] * (n + 1)
    ga, gb = (la + offset)[real], (lb + offset)[real]
    keys, inv = torch.unique(torch.cat([ga, gb]), return_inverse=True)
    ua, ub = inv[: ga.numel()], inv[ga.numel() :]
    # parents as indices into the sorted keys: the smallest index is the
    # smallest root; min propagation with pointer jumping to the fixpoint
    parent = torch.arange(keys.numel(), device=roots.device)
    while True:
        m = torch.minimum(parent[ua], parent[ub])
        new = parent.scatter_reduce(0, ua, m, "amin").scatter_reduce_(0, ub, m, "amin")
        new = new[new]
        if torch.equal(new, parent):
            break
        parent = new
    flat = roots.reshape(b, -1)
    gv = flat + offset
    pos = torch.searchsorted(keys, gv).clamp_max(keys.numel() - 1)
    hit = (keys[pos] == gv) & (flat < n)
    return torch.where(hit, keys[parent[pos]] - offset, flat).reshape(roots.shape)


def _within_capacity(comp, fg, num, cap: int, group) -> torch.Tensor:
    """(B, P) bool: the slab's foreground pixels among the first `cap` of
    the whole image in (root, linear index) order - the pixels the single
    device's compaction keeps when a well overflows. `comp` is each pixel's
    0-based component rank in [0, num)."""
    b, p = comp.shape
    me, _ = group_rank_size(group)
    key = torch.where(fg, comp, num)
    local = torch.zeros((b, num + 1), dtype=torch.int64, device=comp.device)
    local.scatter_add_(1, key, torch.ones_like(key))
    areas = all_gather(local[:, :num], group)  # (S, B, num)
    start = torch.cumsum(areas.sum(0), 1) - areas.sum(0)  # component starts in the image
    before = areas[:me].sum(0)  # the component's pixels on the slabs above
    # rank within the component on this slab: pixels are in linear order
    order = torch.sort(key, dim=1, stable=True)
    srt = order.values
    first = torch.searchsorted(srt, srt)  # first slot of each run
    run = torch.arange(p, device=comp.device).expand(b, p) - first
    rank = torch.empty_like(run).scatter_(1, order.indices, run)
    c = comp.clamp_max(max(num - 1, 0))
    pos = torch.gather(start, 1, c) + torch.gather(before, 1, c) + rank
    return fg & (pos < cap)


def _fused_rows_mask(seg: torch.Tensor, config: PlateRunConfig, slab: RowSlab) -> torch.Tensor:
    """The fused frontend's mask on this slab: the DoG on a halo-padded
    slab (`_row_slab_dog`), one local 65536-bin histogram per slab,
    all-reduced, then the percentile and threshold decisions from the whole
    well's counts."""
    group = slab.group
    dog = _row_slab_dog(seg, config, slab)
    flat = dog.flatten(1)
    mn = all_reduce(flat.amin(1), "min", group)
    mx = all_reduce(flat.amax(1), "max", group)
    q0 = quantize(dog, mn, mx)
    counts = all_reduce(q0_histograms(q0), "sum", group)
    c0 = cutoff_from_hist(counts, slab.height * seg.shape[-1], mn, mx, (0.5, 99.9),
                          config.threshold_method)
    return q0 > c0[:, None, None]


def _classical_rows(img: torch.Tensor, stack: torch.Tensor, config: PlateRunConfig, slab: RowSlab):
    """The classical well program on this rank's row slab of each well.

    (a) the mask: the fused frontend on the slab (`_fused_rows_mask`), or,
    for the configurations it does not cover, the segmentation channel's
    rows of every slab gathered and `_staged_mask` run on the whole well on
    every rank of the space group, of which the slab keeps its rows; (b)
    `component_roots` on the slab through the CUDA CC kernels, roots turned
    into the well's linear indices; (c) the cross-slab merge
    (`_merge_row_slabs`); (d) the certificate ANDed over slabs, the
    component count and the foreground overflow of the whole well, and cell
    slots in root order; (e) the exact partial sums of `measure_segments`,
    reduced over slabs, with the perimeter read on two halo rows of merged
    roots. Returns what the single-device program returns, with the same
    bits on every slab."""
    group, row0, height = slab.group, slab.row0, slab.height
    seg = to_float(img[:, config.seg_channel_index])
    b, hs, w = seg.shape
    n = height * w
    dev = seg.device

    if config.threshold_method in HIST_THRESHOLD_METHODS and config.opening_radius == 0:
        mask = _fused_rows_mask(seg, config, slab)
    else:  # repeated on every rank of the space group: the thresholds take the whole well
        whole = all_gather_rows(seg, slab.heights, group)
        mask = torch.stack([_staged_mask(frame, config) for frame in whole])[:, row0 : row0 + hs]
        del whole

    local, converged = component_roots(mask, pair_cap=config.pair_cap)
    roots = torch.where(mask, local.long() + row0 * w, n)
    roots = _merge_row_slabs(roots, n, group)
    converged = all_reduce(converged.to(torch.int32), "min", group) > 0

    flat = roots.reshape(b, hs * w)
    fg = flat < n
    pix = torch.arange(row0 * w, row0 * w + hs * w, device=dev)
    # each component's root pixel lies on exactly one slab: slabs list the
    # roots they hold, in order, and every slab learns the whole list
    own = torch.sort(torch.where(fg & (flat == pix), flat, n), 1).values
    held = all_gather((own < n).sum(1), group)  # (S, B)
    num = held.sum(0)
    most = max(1, int(held.max()))  # one padding column when no slab holds a root
    roots_all = torch.sort(all_gather(own[:, :most], group).permute(1, 0, 2).reshape(b, -1), 1).values
    comp = torch.searchsorted(roots_all, torch.where(fg, flat, n))
    fg_count = all_reduce(fg.sum(1), "sum", group)
    cap = foreground_capacity(config, height, w)
    overflow = fg_count > cap
    keep = fg
    if bool(overflow.any()):
        keep = _within_capacity(comp, fg, int(num.max()), cap, group)

    labels = torch.where(roots < n, roots + 1, 0)
    pclass = perimeter_classes(halo_rows(labels, 2, group, fill=0))[:, 2 : 2 + hs].reshape(b, -1)
    ys = (torch.arange(hs, device=dev) + row0).repeat_interleave(w)
    xs = torch.arange(w, device=dev).repeat(hs)
    props, stats = measure_segments(
        torch.where(keep, comp + 1, 0).clamp_max(config.max_cells),
        keep,
        ys.expand(b, -1),
        xs.expand(b, -1),
        pclass,
        stack.reshape(b, stack.shape[1], -1),
        config.max_cells,
        root=flat,
        reduce=lambda t, op: all_reduce(t, op, group),
    )
    return props, stats, (num, overflow, converged), None


def _listed_rows(flows: torch.Tensor, active: torch.Tensor, cap: int, slab: RowSlab):
    """The compact tail's list of the whole well from this rank's rows:
    each slab lists its active pixels in ascending order with their one-step
    successors and flows, an exclusive scan of the slabs' counts gives each
    pixel its slot, and every slab's list is gathered. Returns (idx, valid,
    successors, listed flows, ok), each (B, cap) ((B, cap, 2) flows): what
    `models.flows._follow_sparse_core` lists for the whole well, the same on
    every rank."""
    from ..models.flows import _segments_fit, _successors

    group, row0, height = slab.group, slab.row0, slab.height
    b, hs, w = active.shape
    n, p = height * w, hs * w
    dev = active.device
    nxt = _successors(flows, active, row0, height)
    act = active.reshape(b, p)
    counts = all_gather(act.sum(1), group)  # (S, B) active pixels per slab
    before = torch.cumsum(counts, 0) - counts
    take = torch.minimum(counts, (cap - before).clamp_min(0))  # what each slab lists
    most = max(1, int(take.max()))
    ranks = torch.arange(1, most + 1, device=dev).expand(b, most).contiguous()
    at = torch.searchsorted(torch.cumsum(act, 1), ranks).clamp_max(p - 1)
    mine = ranks <= take[slab.index][:, None]
    lists = [
        all_gather(t, group).transpose(0, 1).reshape(b, -1, *t.shape[2:])
        for t in (
            torch.where(mine, at + row0 * w, n),
            torch.where(mine, torch.gather(nxt, 1, at), 0),
            torch.where(mine[..., None], torch.gather(flows.float().reshape(b, p, 2), 1,
                                                      at[..., None].expand(b, most, 2)), 0.0),
        )
    ]
    listed = ranks[None] <= take[..., None]  # (S, B, most)
    slot = torch.where(listed, before[..., None] + ranks[None] - 1, cap).transpose(0, 1).reshape(b, -1)

    def place(vals: torch.Tensor, fill) -> torch.Tensor:
        out = vals.new_full((b, cap + 1, *vals.shape[2:]), fill)
        index = slot.reshape(*slot.shape, *[1] * (vals.dim() - 2)).expand_as(vals)
        # unlisted entries land past the cap
        return out.scatter_(1, index, vals)[:, :cap].contiguous()

    idx, succ, pred_c = place(lists[0], n), place(lists[1], 0), place(lists[2], 0.0)
    ok = (counts.sum(0) <= cap) & _segments_fit(
        act, cap, n, reduce=lambda t, op: all_reduce(t, op, group))
    return idx, idx < n, succ, pred_c, ok


def _unet_rows(img: torch.Tensor, stack: torch.Tensor, config: PlateRunConfig, network,
               slab: RowSlab):
    """The U-Net well program on this rank's row slab of each well.

    (a) the stretch from the all-reduced histograms; (b) the edge pad to the
    U-Net's multiple of 8 (rows on the last slab only) and the forward on
    the slab (`UNet.forward(slab=...)`); (c) the compact list of the whole
    well (`_listed_rows`); (d) the doubling, the sink clustering, the size
    filter, the QC (the diffusion kernel) and the border filter, whole on
    every rank of the space group, on the inputs the single device has; (e)
    the exact partial sums of `measure_segments` over the slab's pixels,
    reduced over slabs, with the perimeter read on the whole label image.
    Returns what the single-device program returns, with the same bits on
    every slab."""
    from ..models.flows import _finish_masks_compact, _land_listed
    from ..models.unet import SlabRows

    group, row0, height = slab.group, slab.row0, slab.height
    seg = img[:, config.seg_channel_index].to(torch.float32)
    b, hs, w = seg.shape
    dev = seg.device
    x = _normalised(seg, group, height * w)
    heights = slab.heights
    heights[-1] += (-height) % 8
    ph = heights[slab.index] - hs
    if ph or w % 8:
        x = F.pad(x[:, None], (0, (-w) % 8, 0, ph), mode="replicate")[:, 0]
    out = network(x[..., None].expand(-1, -1, -1, 3), SlabRows(group, tuple(heights)))
    del x
    out = out[:, :hs, :w]
    flows = out[..., :2] * 0.2  # as compute_masks_sparse_compact takes them
    active = out[..., 2] > config.cellprob_threshold
    del out
    idx, valid, succ, pred_c, ok = _listed_rows(flows, active, foreground_capacity(config, height, w),
                                                slab)
    del flows, active
    labels, lab_c, sink_overflow = _finish_masks_compact(
        idx, valid, _land_listed(idx, valid, succ, config.niter), None, height, w,
        config.flow_threshold, config.max_cells, config.min_size,
        clear_border_labels=config.remove_edge_cells, pred_c=pred_c,
    )
    ok = ok & ~sink_overflow

    flat = labels[:, row0 : row0 + hs].reshape(b, -1).long()
    pclass = perimeter_classes(F.pad(labels, (0, 0, 2, 2))[:, row0 : row0 + hs + 4])
    ys = (torch.arange(hs, device=dev) + row0).repeat_interleave(w)
    xs = torch.arange(w, device=dev).repeat(hs)
    props, stats = measure_segments(
        flat.clamp(0, config.max_cells),
        flat > 0,
        ys.expand(b, -1),
        xs.expand(b, -1),
        pclass[:, 2 : 2 + hs].reshape(b, -1),
        stack.reshape(b, stack.shape[1], -1),
        config.max_cells,
        root=flat - 1,
        reduce=lambda t, op: all_reduce(t, op, group),
    )
    return props, stats, (lab_c.amax(1), ~ok, torch.ones_like(ok)), labels


def _build_well_program(
    config: PlateRunConfig,
    n_channels: int,
    network=None,
    debug_labels: bool = False,
    slab: RowSlab | None = None,
    stages: StageTimer | None = None,
) -> Callable[[torch.Tensor], tuple[torch.Tensor, ...]]:
    """The batched well program: (B, C, H, W) uint16 wells -> packed
    (B, max_cells, 15 + 4 * C_measured) float32 per-cell columns and (B, 3)
    int32 health scalars (component count, foreground overflow, CC
    convergence certificate). The "unet" method needs `network`
    (`unet_network`); `debug_labels` (unet only) also returns its (B, H, W)
    label images. With a `slab` the program takes this rank's rows of each
    well and returns the whole wells' results. The single-device program's
    steps are `stages` (a fresh timer if None): "well.mask", "well.label",
    "well.compact" (classical) or "well.forward", "well.masks" (unet), then
    "well.measure" and "well.pack"; each is a named profiler range."""
    _check_supported(config)
    stages = stages if stages is not None else StageTimer()
    if debug_labels and config.method != "unet":
        raise ValueError("debug_labels is only supported for method='unet'")
    seg_idx = config.seg_channel_index
    columns = _PackedColumns.of(config, n_channels)

    def classical(img: torch.Tensor, stack: torch.Tensor):
        if slab is not None:
            return _classical_rows(img, stack, config, slab)
        h, w = img.shape[-2:]
        with stages.stage("well.mask"):
            seg_img = to_float(img[:, seg_idx])
            if config.threshold_method in HIST_THRESHOLD_METHODS and config.opening_radius == 0:
                mask = fused_classical_mask(
                    seg_img,
                    low_sigma=config.low_sigma,
                    high_sigma=config.high_sigma,
                    percentile_range=(0.5, 99.9),
                    method=config.threshold_method,
                )
            else:  # per well: the percentiles and the threshold are per image
                mask = torch.stack([_staged_mask(frame, config) for frame in seg_img])
        with stages.stage("well.label"):
            roots, converged = component_roots(mask, pair_cap=config.pair_cap)
        with stages.stage("well.compact"):
            comp = compact_by_root(roots, foreground_capacity(config, h, w))
        with stages.stage("well.measure"):
            props, stats = measure_compacted(comp.seg, comp.idx, roots, stack, config.max_cells, w)
        health = (comp.num_components, comp.overflow, converged)
        return props, stats, health, None

    def unet(img: torch.Tensor, stack: torch.Tensor):
        if slab is not None:
            return _unet_rows(img, stack, config, network, slab)
        with stages.stage("well.forward"):
            out = _unet_forward(img[:, seg_idx].to(torch.float32), network)
        with stages.stage("well.masks"):
            cm = _unet_masks(out, config)
        del out
        with stages.stage("well.measure"):
            props, stats = measure_unet_masks(
                cm.labels, cm.lab_c, cm.idx, cm.valid, stack, config.max_cells
            )
        # the largest label; padding slots hold 0
        health = (cm.lab_c.amax(1), ~cm.ok, torch.ones_like(cm.ok))
        return props, stats, health, cm.labels

    def well_fn(img: torch.Tensor) -> tuple[torch.Tensor, ...]:
        # convert before any indexing: on CUDA, uint16 tensors support little
        # beyond copies and casts. Integer channels stay integers, which the
        # measurement sums exactly.
        wide = img.to(torch.float32 if img.dtype.is_floating_point else torch.int32)
        stack = wide[:, list(columns.measure_idx)]
        method = classical if config.method == "classical" else unet
        props, stats, health, labels = method(img, stack)
        with stages.stage("well.pack"):
            packed = columns.pack(props, stats)
            health = torch.stack([h.to(torch.int32) for h in health], -1)
        return (packed, health, labels) if debug_labels else (packed, health)

    return well_fn


# batches of host staging a runner keeps: batch k is copied and launched while
# batches k + 1 and k + 2 are staged
STAGING_SLOTS = 3


class _StagingRing:
    """`STAGING_SLOTS` reused host buffers of one (wells, C, H, W) uint16
    batch shape, page-locked where `pinned` (the copy to a CUDA card is then
    non-blocking), and the event behind the last copy out of each."""

    def __init__(self, shape: tuple[int, ...], pinned: bool):
        self.shape = shape
        self.slots = [torch.empty(shape, dtype=torch.uint16, pin_memory=pinned)
                      for _ in range(STAGING_SLOTS)]
        self.arrays = [s.numpy() for s in self.slots]
        self.events: list[torch.cuda.Event | None] = [None] * STAGING_SLOTS


class PlateRunner:
    """Runs a plate of wells through the fused pipeline on one device or on
    a mesh of ranks (one device each)."""

    def __init__(
        self,
        config: PlateRunConfig | None = None,
        mesh_config: MeshConfig | None = None,
        *,
        unet_params=None,
        checkpoint_dir: str | Path | None = None,
        mesh: Mesh | None = None,
        device: str | torch.device | None = None,
    ):
        """`mesh` overrides `mesh_config` with a pre-built mesh (a
        `create_multihost_mesh(...)` result spreads each batch over the
        hosts axis too); without either, `create_mesh()` spans every rank of
        the default process group, or is the 1 x 1 mesh of this process when
        none is initialised. On a mesh every rank builds the runner and calls
        `run` with the same arguments. `device` None means the CUDA card (each rank's current
        one), and raises when there is none; pass device="cpu" to run the
        plain versions of the kernels. `unet_params` are the U-Net weights
        of the "unet" method, in any form `unet_network` takes; None gives
        seeded weights."""
        self.config = config or PlateRunConfig()
        _check_supported(self.config)
        self.mesh = mesh if mesh is not None else create_mesh(mesh_config)
        self.device = resolve_device(device)
        self.checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir else None
        self.network = (
            unet_network(unet_params, self.device) if self.config.method == "unet" else None
        )
        self._staging: _StagingRing | None = None  # kept across runs of one batch shape

    # -- checkpoint / resume ---------------------------------------------------

    def _manifest_path(self) -> Path:
        return self.checkpoint_dir / "manifest.json"

    def _load_manifest(self) -> dict[str, str]:
        if self.checkpoint_dir is None or not self._manifest_path().exists():
            return {}
        return json.loads(self._manifest_path().read_text())

    def _record_well(self, manifest: dict[str, str], well_id: str, table: pd.DataFrame) -> None:
        if self.checkpoint_dir is None:
            return
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        out = self.checkpoint_dir / f"{well_id}.csv"
        table.to_csv(out, index=False)
        manifest[well_id] = out.name
        self._manifest_path().write_text(json.dumps(manifest, indent=1))

    def _load_well(self, manifest: dict[str, str], well_id: str) -> pd.DataFrame | None:
        if self.checkpoint_dir is None or well_id not in manifest:
            return None
        path = self.checkpoint_dir / manifest[well_id]
        if not path.exists():
            return None
        return pd.read_csv(path)

    # -- execution -----------------------------------------------------------------

    def _escalated_config(self, level: int) -> PlateRunConfig:
        """Capacity escalation for wells denser than the defaults."""
        factor = 4**level
        return replace(
            self.config,
            fg_cap_fraction=min(1.0, self.config.fg_cap_fraction * factor),
            max_cells=self.config.max_cells * factor,
            pair_cap=self.config.pair_cap * factor,
        )

    def _batch_size(self) -> int:
        """Wells per batch: `config.batch_size`, else DEFAULT_BATCH for each
        rank along the batch axes (hosts x wells; JAX `:540-549` takes one
        well per device)."""
        if self.config.batch_size is not None:
            return self.config.batch_size
        return DEFAULT_BATCH * self._input_sharding().batch_count

    def _input_sharding(self) -> Shard:
        """What this rank owns of each batch."""
        spatial = self.mesh.shape[SPACE_AXIS] > 1
        if HOST_AXIS in self.mesh.shape:
            return plate_sharding_multihost(self.mesh, spatial=spatial)
        return well_sharding(self.mesh, spatial=spatial)

    def _slab(self, height: int, width: int) -> tuple[slice, RowSlab | None]:
        """This rank's rows of wells of `height` x `width` pixels and, on a
        spatial mesh, the slab the well program takes (U-Net slabs start on
        multiples of `unet_row_align(width)` rows)."""
        shard = self._input_sharding()
        if shard.space_count == 1:
            return slice(0, height), None
        align = unet_row_align(width) if self.config.method == "unet" else 1
        bounds = row_bounds(height, shard.space_count, align)
        i = shard.space_index
        return slice(bounds[i], bounds[i + 1]), RowSlab(self.mesh.group(SPACE_AXIS), i, bounds)

    def _program(
        self,
        config: PlateRunConfig,
        n_channels: int,
        shape: tuple[int, int],
        stages: StageTimer | None = None,
    ) -> tuple[slice, Callable[[torch.Tensor], tuple[torch.Tensor, ...]]]:
        """This rank's rows of wells of `n_channels` x `shape` pixels and the
        well program that takes them (on a spatial mesh, this rank's row
        slab of each well; see `_slab`)."""
        rows, slab = self._slab(*shape)
        return rows, _build_well_program(config, n_channels, self.network, slab=slab, stages=stages)

    def _get_compiled(
        self, n_channels: int, shape: tuple[int, int], config: PlateRunConfig | None = None
    ) -> Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
        """The well program over a whole (B, C, H, W) batch on this mesh,
        the counterpart of the JAX runner's jitted, sharded program: every
        rank passes the same batch, runs its share (its wells, its rows),
        and gets every well's packed columns and health, all-gathered."""
        config = config or self.config
        shard = self._input_sharding()
        rows, program = self._program(config, n_channels, shape)
        width = _PackedColumns.of(config, n_channels).width

        def run(batch: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
            b = batch.shape[0]
            mine = batch[shard.batch_rows(b)][..., rows, :]
            per = -(-b // shard.batch_count)
            packed = torch.zeros((per, config.max_cells, width), device=self.device)
            health = torch.zeros((per, 3), dtype=torch.int32, device=self.device)
            if mine.shape[0]:
                got = program(mine.to(self.device))
                packed[: mine.shape[0]], health[: mine.shape[0]] = got
            if self.mesh.size == 1:
                return packed[:b], health[:b]
            out = []
            for t in (packed, health):
                parts = all_gather(t, dist.group.WORLD)  # ranks in mesh order
                parts = parts.reshape(-1, shard.space_count, *t.shape)[:, 0]
                out.append(parts.reshape(-1, *t.shape[1:])[:b])
            return tuple(out)

        return run

    def _gather(self, entries: list) -> list:
        """Every rank's `entries` in rank order (this rank's alone on a 1 x 1
        mesh)."""
        if self.mesh.size == 1:
            return entries
        out = [None] * self.mesh.size
        dist.all_gather_object(out, entries)
        return [e for part in out for e in part]

    def _shared(self, obj):
        """Rank 0's `obj` on every rank."""
        if self.mesh.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=int(self.mesh.devices.flat[0]))
        return box[0]

    def _results_to_table(
        self,
        props: dict[str, np.ndarray],
        intensity: dict[int, dict[str, np.ndarray]],
        channels: list[Channel] | None,
        image_shape: tuple[int, int],
    ) -> pd.DataFrame:
        """One well's table from its unpacked columns: its valid cells of at
        least `min_size` pixels, numbered from 1 in slot order."""
        keep = props["valid"] & (props["area"] >= self.config.min_size)
        if self.config.remove_edge_cells and self.config.method == "classical":
            # border cut from bboxes (skimage.segmentation.clear_border); the
            # unet method folds it into its mask tail
            h, w = image_shape
            keep &= (
                (props["bbox_min_row"] > 0)
                & (props["bbox_min_col"] > 0)
                & (props["bbox_max_row"] < h)
                & (props["bbox_max_col"] < w)
            )
        order = ["label", "area", "centroid_y", "centroid_x", "perimeter", "eccentricity",
                 "axis_major_length", "axis_minor_length", "orientation", "extent"]
        data = {name: props[name][keep] for name in order}
        # consecutive label numbering after the size cut
        data["label"] = np.arange(1, int(keep.sum()) + 1, dtype=np.int64)
        area = data["area"]
        perim = data["perimeter"]
        data["circularity"] = np.where(perim > 0, 4 * np.pi * area / perim**2, 0.0)
        a = data["axis_major_length"] / 2
        b = data["axis_minor_length"] / 2
        data["volume"] = np.where((a > 0) & (b > 0), 4 / 3 * np.pi * a * b * b, 0.0)
        for ci, stats in intensity.items():
            suffix = channels[ci].name.lower() if channels else f"ch{ci}"
            for stat_name, values in stats.items():
                data[f"{stat_name}_{suffix}"] = values[keep]
        return pd.DataFrame(data)

    def run(
        self,
        layout: MicroplateLayout,
        image_source: Mapping[str, np.ndarray] | Callable[[str], np.ndarray],
        channels: list[Channel] | None = None,
        show_progress: bool = False,
        prefetch: int | None = None,
        max_inflight: int = 4,
    ) -> PlateResults:
        """Process every well of `layout`.

        On a mesh every rank calls this with the same arguments: each rank
        decodes only its contiguous block of every batch (the ranks of one
        space group decode the same wells and stage their own rows), and
        every rank returns the full results.

        Args:
            layout: The plate layout (well ids drive scheduling).
            image_source: Mapping or callable well_id -> (C, H, W) uint16
                array. Decode errors are isolated per well.
            channels: Channel identities for intensity-stat naming.
            show_progress: Display a progress bar over batches (needs tqdm).
            prefetch: Batches decoded ahead on a thread pool (None = one per
                host core, 0 = decode inline). With prefetch > 0 the
                image_source is called from several threads and must be
                thread-safe.
            max_inflight: Dispatched-but-undrained batch cap; bounds the
                decoded images held for capacity retries.

        The worker that decodes a batch of same-shape uint16 wells also
        copies them into one of `STAGING_SLOTS` host buffers of a whole
        batch, which the runner keeps for later runs of that batch shape
        (on a CUDA card page-locked: 3 x 268 MB for 8 wells of 4 x 2048^2,
        perhaps rounded up to a power of two by torch's pinned allocator);
        the main thread copies the batch to the device from there without
        waiting. Batches of several shapes, capacity retries and devices
        other than CUDA or the CPU are stacked on the main thread instead.

        Returns:
            PlateResults with one table per well (None for failed wells).
            Its `timings` are host seconds and counts: the main thread's
            steps, each a named profiler range ("plate.fetch_wait" ->
            `fetch_wait_s`, "plate.stage" -> `stage_s`, "plate.h2d" ->
            `h2d_s`, "plate.launch" -> `launch_s`, "plate.readback" ->
            `readback_s`, "plate.gather" -> `gather_s`, "plate.assemble" ->
            `assemble_s`, all inside "plate.run"), and the prefetch workers'
            `decode_s`, `decode_cpu_s`, `decode_wells` and `fill_s` (their
            copies into staging buffers), with `capacity_retries`,
            `batches` (every dispatch) and `pinned_batches` (dispatches
            uploaded from a buffer a worker filled; on the CPU the buffers
            are ordinary memory).
        """
        stages = StageTimer()
        with stages.stage("plate.run"):
            tables, timings = _PlateRun(self, layout, image_source, channels, prefetch,
                                        max_inflight, stages)(show_progress)
        for span, key in _RUN_SPANS.items():
            timings[key] = stages.totals.get(span, 0.0)
        return PlateResults(tables, timings)

    def _agree_on_slabs(self, images, ok_ids, failed):
        """On a spatial mesh the ranks of a space group decode the same
        wells: a well counts only if every one of them decoded it with one
        shape."""
        group = self.mesh.group(SPACE_AXIS)
        mine = {w: img.shape for w, img in zip(ok_ids, images)} | {w: None for w in failed}
        views = [None] * dist.get_world_size(group)
        dist.all_gather_object(views, mine, group=group)
        bad = {w for w in mine if any(v.get(w) != mine[w] or v.get(w) is None for v in views)}
        for w in sorted(bad - set(failed)):
            warnings.warn(f"Well {w}: decoded differently on another row shard's rank; well failed",
                          SegmentationWarning, stacklevel=3)
        keep = [i for i, w in enumerate(ok_ids) if w not in bad]
        return ([images[i] for i in keep], [ok_ids[i] for i in keep],
                failed + [w for w in ok_ids if w in bad])


def _well_health_problem(health: np.ndarray, config: PlateRunConfig) -> str | None:
    """None when one well's health row (component count, foreground
    overflow, CC certificate) vouches for its results, else what went
    wrong: each is a capacity overflow, which a re-dispatch with escalated
    capacities may cure."""
    n_comp, fg_overflow, converged = (int(v) for v in health)
    if n_comp > config.max_cells:
        return f"{n_comp} components exceed max_cells={config.max_cells}"
    if fg_overflow > 0:
        return (
            "foreground pixels exceed the compaction capacity "
            f"(fg_cap_fraction={config.fg_cap_fraction})"
        )
    if converged <= 0:
        return (
            "connected-components labeling did not converge (boundary-edge "
            f"capacity pair_cap={config.pair_cap} exceeded, or pathological "
            "component shapes); results would be unreliable"
        )
    return None


class _PlateRun:
    """One call of `PlateRunner.run`: its state, its main thread's steps and
    its prefetch workers' turns on the runner's staging ring.

    A worker decodes this rank's block of batch j (`_load`) and copies it
    into slot j % STAGING_SLOTS of the ring (`_fill`). The main thread
    dispatches the batches in order (`_submit`), uploading each from its
    slot or stacking it (`_upload`), drains them at most `max_inflight`
    behind (`_drain`: read back, gather, one table per well), and then
    re-dispatches dense wells at escalated capacities (`_escalate`).

    Batch j may fill its slot once the main thread has dispatched batch
    j - STAGING_SLOTS and the copy out of the slot has completed; the main
    thread hands each slot on in batch order (`_done`), whether or not the
    batch took it, so a worker waits only for a batch dispatched before its
    own. On the CPU the slots are ordinary memory, and the well program,
    which reads the slot itself there, has returned before `_done`."""

    def __init__(self, runner: PlateRunner, layout: MicroplateLayout, image_source, channels,
                 prefetch: int | None, max_inflight: int, stages: StageTimer):
        self.runner, self.source, self.channels = runner, image_source, channels
        self.prefetch = (os.cpu_count() or 1) if prefetch is None else prefetch
        self.max_inflight, self.stages = max_inflight, stages
        self.timings = dict.fromkeys(
            ("decode_s", "decode_cpu_s", "decode_wells", "capacity_retries", "fill_s", "batches",
             "pinned_batches"), 0.0)
        self.shard = runner._input_sharding()
        self.spatial = self.shard.space_count > 1
        self.lead = runner.mesh.rank == int(runner.mesh.devices.flat[0])
        self.manifest, cached = runner._shared(self._resume(layout) if self.lead else None)
        self.tables: dict[str, pd.DataFrame | None] = {
            w: cached[w] for w in layout.well_ids if w in cached}
        pending = [w for w in layout.well_ids if w not in cached]
        self.batch_size = size = runner._batch_size()
        self.batches = [pending[i : i + size] for i in range(0, len(pending), size)]
        self.inflight: deque = deque()  # (dispatch records, wells failed to load) per batch
        self.batch_no = itertools.count()  # dispatches of this run, named in its ranges
        self.programs: dict[tuple, tuple] = {}  # (config, (C, H, W)) -> `runner._program`
        self.retry_ids: list[str] = []
        self.retry_images: dict[str, np.ndarray] = {}
        # the staging turns; a slot holds this rank's wells of a whole batch
        self.wells = len(range(size)[self.shard.batch_rows(size)])
        self.ring: _StagingRing | None = None  # chosen by the run's first uniform batch
        self.turn = list(range(STAGING_SLOTS))
        self.held: list[list[str] | None] = [None] * STAGING_SLOTS  # the wells in each slot
        self.closed = False
        self.cond = threading.Condition()

    def __call__(self, show_progress: bool) -> tuple[dict, dict]:
        """Every batch, then the capacity retries: the tables and the run's
        counters."""
        progress = get_tqdm()(total=len(self.batches), desc="Plate", disable=not show_progress)
        try:
            if self.prefetch > 0:
                with ThreadPoolExecutor(max_workers=self.prefetch) as pool:
                    try:
                        ahead = min(self.prefetch, len(self.batches))
                        decoding = deque(pool.submit(self._load, j) for j in range(ahead))
                        while decoding:
                            with self.stages.stage("plate.fetch_wait"):
                                loaded = decoding.popleft().result()
                            if ahead < len(self.batches):
                                decoding.append(pool.submit(self._load, ahead))
                                ahead += 1
                            self._submit(*loaded)
                            progress.update(1)
                    finally:
                        self._close()  # a failed run leaves no worker waiting on a slot
            else:
                for j in range(len(self.batches)):
                    with self.stages.stage("plate.fetch_wait"):
                        loaded = self._load(j)
                    self._submit(*loaded)
                    progress.update(1)
        finally:
            progress.close()
        while self.inflight:
            self._drain(*self.inflight.popleft())
        self._escalate()
        return self.tables, self.timings

    def _resume(self, layout: MicroplateLayout) -> tuple[dict, dict]:
        """The checkpoint's manifest and its tables of `layout`'s wells."""
        manifest = self.runner._load_manifest()
        cached = {w: self.runner._load_well(manifest, w) for w in layout.well_ids}
        return manifest, {w: t for w, t in cached.items() if t is not None}

    # -- prefetch workers ---------------------------------------------------------

    def _fetch(self, well_id: str) -> np.ndarray | None:
        """One well's (C, H, W) image; None, with a warning, where it fails
        to load."""
        try:
            img = self.source(well_id) if callable(self.source) else self.source[well_id]
            img = np.asarray(img)
            return img[None] if img.ndim == 2 else img
        except Exception as e:  # noqa: BLE001 - per-well isolation boundary
            warnings.warn(
                f"Failed to load image for well {well_id}: {e}",
                SegmentationWarning,
                stacklevel=2,
            )
            return None

    def _load(self, j: int) -> tuple:
        """Decode this rank's block of batch j and stage it into its slot
        (on a prefetch worker, touching no state of the run but the staging
        turns): `_submit`'s arguments. Wall and thread-CPU seconds of the
        decode are summed per well, the fill's wall seconds per batch."""
        batch_ids = self.batches[j]
        images: list[np.ndarray] = []
        ok_ids: list[str] = []
        failed: list[str] = []
        wall = cpu = 0.0
        for well_id in batch_ids[self.shard.batch_rows(len(batch_ids))]:
            t0, c0 = time.time(), time.thread_time()
            img = self._fetch(well_id)
            wall += time.time() - t0
            cpu += time.thread_time() - c0
            if img is None:
                failed.append(well_id)
            else:
                images.append(img)
                ok_ids.append(well_id)
        slot, fill = self._fill(j, images, ok_ids)
        return j, images, ok_ids, failed, slot, (wall, cpu, len(images) + len(failed), fill)

    def _fill(self, j: int, images: list[np.ndarray],
              ok_ids: list[str]) -> tuple[int | None, float]:
        """Stage batch j's wells (this rank's rows of them) into its slot:
        the slot and the copy's wall seconds, or (None, 0.0) where the batch
        takes none: a device neither CUDA nor the CPU, no wells, wells of
        several shapes or not uint16, or a shape other than the ring's."""
        runner = self.runner
        skip = None, 0.0
        first = images[0] if images else None
        if (runner.device.type not in ("cuda", "cpu") or first is None
                or any(img.shape != first.shape or img.dtype != np.uint16 for img in images)):
            return skip
        try:
            rows, _ = runner._slab(*first.shape[-2:])
        except ValueError:  # a well too small for its slabs fails in dispatch
            return skip
        h, w = first.shape[-2:]
        shape = (self.wells, *first.shape[:-2], len(range(h)[rows]), w)
        with self.cond:
            if self.ring is None:  # the runner's, unless its shape differs
                ring = runner._staging
                if ring is None or ring.shape != shape:
                    runner._staging = None  # unpin the old ring before pinning anew
                    ring = runner._staging = _StagingRing(
                        shape, pinned=runner.device.type == "cuda")
                self.ring = ring
            if self.ring.shape != shape or len(images) > self.wells:
                return skip
            k = j % STAGING_SLOTS
            self.cond.wait_for(lambda: self.closed or self.turn[k] == j)
            if self.closed:
                return skip
        event = self.ring.events[k]
        if event is not None:
            event.synchronize()
        t0 = time.time()
        for dst, img in zip(self.ring.arrays[k], images):
            np.copyto(dst, img[..., rows, :])
        self.held[k] = ok_ids
        return k, time.time() - t0

    def _done(self, j: int) -> None:
        """Batch j is dispatched: its slot goes to batch j + STAGING_SLOTS."""
        with self.cond:
            self.turn[j % STAGING_SLOTS] = j + STAGING_SLOTS
            self.cond.notify_all()

    def _close(self) -> None:
        """Release every worker still waiting for a slot (the run ended)."""
        with self.cond:
            self.closed = True
            self.cond.notify_all()

    # -- the main thread ----------------------------------------------------------

    def _submit(self, j: int, images: list[np.ndarray], ok_ids: list[str], failed: list[str],
                slot: int | None, counters: tuple[float, ...]) -> None:
        """Dispatch a loaded batch, hand its slot on, and drain the batches
        past `max_inflight`."""
        for key, value in zip(("decode_s", "decode_cpu_s", "decode_wells", "fill_s"), counters):
            self.timings[key] += value
        if self.spatial:
            images, ok_ids, failed = self.runner._agree_on_slabs(images, ok_ids, failed)
        recs = self._dispatch_by_shape(images, ok_ids, self.runner.config, True, slot)
        self.inflight.append((recs, failed))
        self._done(j)
        while len(self.inflight) > self.max_inflight:
            self._drain(*self.inflight.popleft())

    def _dispatch_by_shape(self, images: list[np.ndarray], ok_ids: list[str],
                           config: PlateRunConfig, retryable: bool,
                           slot: int | None = None) -> list[dict]:
        """Dispatch wells grouped by image shape (a well whose shape differs
        gets its own dispatch instead of failing its batchmates), at most a
        batch per dispatch."""
        groups: dict[tuple, list[int]] = {}
        for i, img in enumerate(images):
            groups.setdefault(img.shape, []).append(i)
        recs = []
        for idxs in groups.values():
            for k in range(0, len(idxs), self.batch_size):
                part = idxs[k : k + self.batch_size]
                recs.append(self._dispatch([images[i] for i in part], [ok_ids[i] for i in part],
                                           config, retryable, slot))
        return recs

    def _dispatch(self, images: list[np.ndarray], ok_ids: list[str], config: PlateRunConfig,
                  retryable: bool, slot: int | None) -> dict:
        """Upload this rank's share of one batch of same-shape wells and
        launch the well program on it: the batch's record for `_drain`."""
        ordinal = f"batch {next(self.batch_no)}"
        self.timings["batches"] += 1
        shape = images[0].shape
        try:
            key = (config, shape)
            if key not in self.programs:
                self.programs[key] = self.runner._program(config, shape[0], shape[-2:], self.stages)
            rows, program = self.programs[key]
            staged = self._upload(images, ok_ids, rows, slot, ordinal)
            with self.stages.stage("plate.launch", args=ordinal):
                packed, health = program(staged)
        except Exception as e:  # noqa: BLE001 - per-batch isolation boundary
            if self.spatial:  # the other slabs of these wells wait in its collectives
                raise
            _batch_failed(ok_ids, e)
            return {"failed": ok_ids}
        return {
            "ordinal": ordinal,
            "images": images,
            "ok_ids": ok_ids,
            # what each well's result carries after its packed and health rows
            "result": (config, _PackedColumns.of(config, shape[0]), retryable, tuple(shape[-2:])),
            "packed": packed,
            "health": health,
        }

    def _upload(self, images: list[np.ndarray], ok_ids: list[str], rows: slice,
                slot: int | None, ordinal: str) -> torch.Tensor:
        """The batch's rows on the device, enqueued on its current stream:
        copied from staging slot `slot` where a worker filled it with these
        very wells (a CUDA card's copy out of the slot is non-blocking, and
        the slot's event follows it), else stacked here - a batch of several
        shapes, wells `_agree_on_slabs` dropped, a capacity retry."""
        if slot is None or self.held[slot] != ok_ids:
            with self.stages.stage("plate.stage", args=ordinal):
                batch = np.ascontiguousarray(np.stack(images)[..., rows, :])
            with self.stages.stage("plate.h2d", args=ordinal):
                return torch.from_numpy(batch).to(self.runner.device)
        with self.stages.stage("plate.stage", args=ordinal):
            n = len(images)
        with self.stages.stage("plate.h2d", args=ordinal):
            staged = self.ring.slots[slot][:n].to(self.runner.device, non_blocking=True)
            if staged.is_cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(staged.device))
                self.ring.events[slot] = event
        self.timings["pinned_batches"] += 1
        return staged

    def _drain(self, recs: list[dict], failed: list[str]) -> None:
        """Read this rank's dispatched batches back, gather every rank's
        per-well results and assemble them (the same on every rank)."""
        entries: list[tuple[str, tuple | None]] = [(w, None) for w in failed]
        owned: dict[str, np.ndarray] = {}
        for rec in recs:
            if "failed" in rec:
                entries += [(w, None) for w in rec["failed"]]
                continue
            try:
                with self.stages.stage("plate.readback", args=rec["ordinal"]):
                    packed = rec["packed"].cpu().numpy()
                    health = rec["health"].cpu().numpy()
            except Exception as e:  # noqa: BLE001 - per-batch isolation boundary
                _batch_failed(rec["ok_ids"], e)
                entries += [(w, None) for w in rec["ok_ids"]]
                continue
            for i, well_id in enumerate(rec["ok_ids"]):
                owned[well_id] = rec["images"][i]
                entries.append((well_id, (packed[i], health[i], *rec["result"])))
        with self.stages.stage("plate.gather"):
            gathered = self.runner._gather(entries)
        merged: dict[str, tuple | None] = {}
        for well_id, result in gathered:  # slabs of one well report alike
            merged.setdefault(well_id, result)
        with self.stages.stage("plate.assemble"):
            for well_id, result in merged.items():
                self._assemble(well_id, result, owned.get(well_id))

    def _assemble(self, well_id: str, result: tuple | None, image: np.ndarray | None) -> None:
        """Well `well_id`'s table from its gathered result (None: the well
        failed), or a capacity retry where its health asks for one; `image`
        is this rank's decode of the well, if it has one."""
        if result is None:
            self.tables[well_id] = None
            return
        packed, health, config, columns, retryable, image_shape = result
        problem = _well_health_problem(health, config)
        if problem is not None:
            if retryable:
                self.retry_ids.append(well_id)
                if image is not None:
                    self.retry_images[well_id] = image
                self.timings["capacity_retries"] += 1
            else:
                warnings.warn(f"Well {well_id}: {problem}", SegmentationWarning, stacklevel=2)
                self.tables[well_id] = None
            return
        props, intensity = columns.unpack(packed)
        table = self.runner._results_to_table(props, intensity, self.channels, image_shape)
        self.tables[well_id] = table
        if self.lead:
            self.runner._record_well(self.manifest, well_id, table)

    def _escalate(self) -> None:
        """Re-dispatch the dense wells with 4x and then 16x the capacities,
        each on the ranks that decoded it, grouped by shape."""
        for level in (1, 2):
            if not self.retry_ids:  # the same list on every rank
                break
            config = self.runner._escalated_config(level)
            current = [w for w in self.retry_ids if w in self.retry_images]
            self.retry_ids.clear()
            images = [self.retry_images.pop(w) for w in current]
            self._drain(self._dispatch_by_shape(images, current, config, level < 2), [])


def _batch_failed(ok_ids: list[str], error: Exception) -> None:
    """Log and warn that a batch's device work failed (from its except
    block)."""
    logger.exception("device batch failed for wells %s", ok_ids)
    warnings.warn(
        f"Device batch failed for wells {ok_ids}: {error}",
        SegmentationWarning,
        stacklevel=3,
    )
