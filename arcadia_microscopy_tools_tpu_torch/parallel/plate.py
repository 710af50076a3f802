"""End-to-end plate pipeline on one device.

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

The runner keeps the reference's host-side contract:
- per-well failure isolation: a failed well yields None and a
  SegmentationWarning, and the run continues;
- checkpoint/resume: per-well CSV tables plus a `manifest.json` under
  `checkpoint_dir`, in the reference's format, so a plate begun by either
  runner resumes in the other;
- capacity escalation: wells whose health scalars report a foreground,
  cell-count or boundary-edge overflow (or a CC certificate failure) are
  re-dispatched with 4x and then 16x capacities before they are failed;
- decode prefetch on a thread pool, and per-stage timings.
"""

from __future__ import annotations

import json
import logging
import os
import time
import warnings
from collections import deque
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, Mapping

import numpy as np
import pandas as pd
import torch
import torch.nn.functional as F

from ..core.channels import Channel
from ..core.microplate import MicroplateLayout
from ..exceptions import SegmentationWarning
from ..ops.basic import rescale_by_percentile, subtract_background_dog
from ..ops.compaction import compact_by_root
from ..ops.filters import to_float
from ..ops.fused import HIST_THRESHOLD_METHODS, _percentile_from_cum, fused_classical_mask
from ..ops.labeling import component_roots
from ..ops.morphology import binary_opening, disk
from ..ops.regionprops import measure_compacted
from ..ops.threshold import GLOBAL_METHODS

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


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. Raises when no CUDA device exists and none was named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return torch.device("cuda")


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


def _normalised(seg: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint16-valued float32 frames stretched to [0, 1] between
    each frame's 1st and 99th percentiles, read from its exact integer
    histogram (np.percentile's values), clipped in float32."""
    b, h, w = seg.shape
    values = seg.reshape(b, h * w).long() + 65536 * torch.arange(b, device=seg.device)[:, None]
    counts = torch.bincount(values.reshape(-1), minlength=65536 * b).reshape(b, 65536)
    cum = torch.cumsum(counts, -1).to(torch.float32)  # exact below 2^24 pixels
    p1 = _percentile_from_cum(cum, 1.0, h * w)[:, None, None]
    p99 = _percentile_from_cum(cum, 99.0, h * w)[:, None, None]
    return ((seg - p1) / torch.clamp(p99 - p1, min=1e-6)).clamp(0.0, 1.0)


def _unet_masks(seg: torch.Tensor, network, config: PlateRunConfig):
    """Compact U-Net masks of (B, H, W) float32 frames: the stretch, an edge
    pad to the U-Net's multiple of 8, the forward on the replicated
    grayscale (B, H, W, 3) input, the crop, and mask reconstruction in the
    compact domain with the border filter folded in."""
    from ..models.flows import compute_masks_sparse_compact

    _, h, w = seg.shape
    x = _normalised(seg)
    ph, pw = (-h) % 8, (-w) % 8
    if ph or pw:
        x = F.pad(x[:, None], (0, pw, 0, ph), mode="replicate")[:, 0]
    out = network(x[..., None].expand(-1, -1, -1, 3))
    del x
    return compute_masks_sparse_compact(
        out[:, :h, :w],
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


def _build_well_program(
    config: PlateRunConfig, n_channels: int, network=None, debug_labels: bool = False
) -> Callable[[torch.Tensor], tuple[torch.Tensor, ...]]:
    """The batched well program: (B, C, H, W) uint16 wells -> packed
    (B, max_cells, 15 + 4 * C_measured) float32 per-cell columns and (B, 3)
    int32 health scalars (component count, foreground overflow, CC
    convergence certificate). The "unet" method needs `network`
    (`unet_network`); `debug_labels` (unet only) also returns its (B, H, W)
    label images."""
    _check_supported(config)
    if debug_labels and config.method != "unet":
        raise ValueError("debug_labels is only supported for method='unet'")
    seg_idx = config.seg_channel_index
    measure_idx = (
        config.measure_channel_indices
        if config.measure_channel_indices is not None
        else tuple(range(n_channels))
    )

    def classical(img: torch.Tensor, stack: torch.Tensor):
        seg_img = to_float(img[:, seg_idx])
        h, w = seg_img.shape[-2:]
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
        roots, converged = component_roots(mask, pair_cap=config.pair_cap)
        comp = compact_by_root(roots, foreground_capacity(config, h, w))
        props, stats = measure_compacted(comp.seg, comp.idx, roots, stack, config.max_cells, w)
        health = (comp.num_components, comp.overflow, converged)
        return props, stats, health, None

    def unet(img: torch.Tensor, stack: torch.Tensor):
        cm = _unet_masks(img[:, seg_idx].to(torch.float32), network, config)
        props, stats = measure_unet_masks(
            cm.labels, cm.lab_c, cm.idx, cm.valid, stack, config.max_cells
        )
        # the largest label; padding slots hold 0
        health = (cm.lab_c.amax(1), ~cm.ok, torch.ones_like(cm.ok))
        return props, stats, health, cm.labels

    def well_fn(img: torch.Tensor) -> tuple[torch.Tensor, ...]:
        # convert before any indexing: on CUDA, uint16 tensors support little
        # beyond copies and casts
        stack = img.to(torch.float32)[:, list(measure_idx)]
        method = classical if config.method == "classical" else unet
        props, stats, health, labels = method(img, stack)
        columns = [props[name].to(torch.float32) for name in _PROP_COLUMNS]
        for k in range(len(measure_idx)):
            for stat in _INTENSITY_STATS:
                columns.append(stats[k][stat].to(torch.float32))
        packed = torch.stack(columns, -1)
        health = torch.stack([h.to(torch.int32) for h in health], -1)
        return (packed, health, labels) if debug_labels else (packed, health)

    return well_fn


def _unpack_outputs(
    packed: np.ndarray, health: np.ndarray, measure_idx: tuple[int, ...]
) -> tuple[dict, dict, dict]:
    """Host-side inverse of the program's column packing."""
    props = {name: packed[..., i] for i, name in enumerate(_PROP_COLUMNS)}
    props["valid"] = props["valid"] > 0.5
    base = len(_PROP_COLUMNS)
    intensity = {}
    for k, ci in enumerate(measure_idx):
        intensity[ci] = {
            stat: packed[..., base + k * len(_INTENSITY_STATS) + j]
            for j, stat in enumerate(_INTENSITY_STATS)
        }
    health_dict = {
        "num_components": health[..., 0],
        "fg_overflow": health[..., 1] > 0,
        "converged": health[..., 2] > 0,
    }
    return props, intensity, health_dict


def _progress_bar(total: int):
    try:
        from tqdm.auto import tqdm
    except ImportError:
        return None
    return tqdm(total=total, desc="Plate")


class PlateRunner:
    """Runs a plate of wells through the fused pipeline on one device."""

    def __init__(
        self,
        config: PlateRunConfig | None = None,
        checkpoint_dir: str | Path | None = None,
        device: str | torch.device | None = None,
        unet_params=None,
    ):
        """`device` None means the CUDA card, and raises when there is none;
        pass device="cpu" to run the plain versions of the kernels.
        `unet_params` are the U-Net weights of the "unet" method, in any
        form `unet_network` takes; None gives seeded weights."""
        self.config = config or PlateRunConfig()
        _check_supported(self.config)
        self.device = resolve_device(device)
        self.checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir else None
        self.network = (
            unet_network(unet_params, self.device) if self.config.method == "unet" else None
        )

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
        return self.config.batch_size if self.config.batch_size is not None else DEFAULT_BATCH

    def _results_to_table(
        self,
        props: dict[str, np.ndarray],
        intensity: dict[int, dict[str, np.ndarray]],
        channels: list[Channel] | None,
        well_index: int,
        image_shape: tuple[int, int],
    ) -> pd.DataFrame:
        valid = np.asarray(props["valid"][well_index])
        area_all = np.asarray(props["area"][well_index])
        keep = valid & (area_all >= self.config.min_size)
        if self.config.remove_edge_cells and self.config.method == "classical":
            # border cut from bboxes (skimage.segmentation.clear_border); the
            # unet method folds it into its mask tail
            h, w = image_shape
            keep &= (
                (np.asarray(props["bbox_min_row"][well_index]) > 0)
                & (np.asarray(props["bbox_min_col"][well_index]) > 0)
                & (np.asarray(props["bbox_max_row"][well_index]) < h)
                & (np.asarray(props["bbox_max_col"][well_index]) < w)
            )
        data: dict[str, np.ndarray] = {}
        order = [
            "label",
            "area",
            "centroid_y",
            "centroid_x",
            "perimeter",
            "eccentricity",
            "axis_major_length",
            "axis_minor_length",
            "orientation",
            "extent",
        ]
        for name in order:
            data[name] = np.asarray(props[name][well_index])[keep]
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
                data[f"{stat_name}_{suffix}"] = np.asarray(values[well_index])[keep]
        return pd.DataFrame(data)

    def _well_health_problem(
        self, health: dict[str, np.ndarray], well_index: int, config: PlateRunConfig
    ) -> tuple[str, str] | None:
        """None when the well is trustworthy, else (kind, message); kind
        "capacity" triggers a re-dispatch with escalated capacities."""
        n_comp = int(health["num_components"][well_index])
        if n_comp > config.max_cells:
            return ("capacity", f"{n_comp} components exceed max_cells={config.max_cells}")
        if bool(health["fg_overflow"][well_index]):
            return (
                "capacity",
                "foreground pixels exceed the compaction capacity "
                f"(fg_cap_fraction={config.fg_cap_fraction})",
            )
        if not bool(health["converged"][well_index]):
            return (
                "capacity",
                "connected-components labeling did not converge (boundary-edge "
                f"capacity pair_cap={config.pair_cap} exceeded, or pathological "
                "component shapes); results would be unreliable",
            )
        return None

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

        Returns:
            PlateResults with one table per well (None for failed wells).
        """
        if prefetch is None:
            prefetch = os.cpu_count() or 1
        timings = {
            "decode_s": 0.0,
            "decode_cpu_s": 0.0,
            "decode_wells": 0.0,
            "device_s": 0.0,
            "assemble_s": 0.0,
            "capacity_retries": 0.0,
        }
        manifest = self._load_manifest()
        tables: dict[str, pd.DataFrame | None] = {}

        def fetch(well_id: str) -> np.ndarray | None:
            try:
                img = image_source(well_id) if callable(image_source) else image_source[well_id]
                img = np.asarray(img)
                if img.ndim == 2:
                    img = img[None]
                return img
            except Exception as e:  # noqa: BLE001 - per-well isolation boundary
                warnings.warn(
                    f"Failed to load image for well {well_id}: {e}",
                    SegmentationWarning,
                    stacklevel=2,
                )
                return None

        pending_ids: list[str] = []
        for well_id in layout.well_ids:
            cached = self._load_well(manifest, well_id)
            if cached is not None:
                tables[well_id] = cached
            else:
                pending_ids.append(well_id)

        batch_size = self._batch_size()
        batches = [pending_ids[i : i + batch_size] for i in range(0, len(pending_ids), batch_size)]

        def fail(ok_ids: list[str], e: Exception) -> None:
            logger.exception("device batch failed for wells %s", ok_ids)
            warnings.warn(
                f"Device batch failed for wells {ok_ids}: {e}",
                SegmentationWarning,
                stacklevel=3,
            )
            for well_id in ok_ids:
                tables[well_id] = None

        def dispatch(
            images: list[np.ndarray], ok_ids: list[str], config: PlateRunConfig, retryable: bool
        ) -> dict | None:
            """Stage one batch of same-shape wells and run the well program."""
            t0 = time.time()
            try:
                staged = torch.from_numpy(np.stack(images)).to(self.device)
                n_channels = staged.shape[1]
                image_shape = tuple(staged.shape[-2:])
                packed, health = _build_well_program(config, n_channels, self.network)(staged)
            except Exception as e:  # noqa: BLE001 - per-batch isolation boundary
                fail(ok_ids, e)
                return None
            finally:
                timings["device_s"] += time.time() - t0
            return {
                "images": images,
                "ok_ids": ok_ids,
                "config": config,
                "retryable": retryable,
                "packed": packed,
                "health": health,
                "n_channels": n_channels,
                "image_shape": image_shape,
            }

        def drain(rec: dict | None, retry: dict[str, np.ndarray]) -> None:
            """Read one dispatched batch back and turn it into tables."""
            if rec is None:
                return
            config: PlateRunConfig = rec["config"]
            ok_ids: list[str] = rec["ok_ids"]
            t0 = time.time()
            try:
                packed_h = rec["packed"].cpu().numpy()
                health_raw = rec["health"].cpu().numpy()
            except Exception as e:  # noqa: BLE001 - per-batch isolation boundary
                fail(ok_ids, e)
                return
            finally:
                timings["device_s"] += time.time() - t0

            t0 = time.time()
            measure_idx = (
                config.measure_channel_indices
                if config.measure_channel_indices is not None
                else tuple(range(rec["n_channels"]))
            )
            props_h, intensity_h, health_h = _unpack_outputs(packed_h, health_raw, measure_idx)
            for i, well_id in enumerate(ok_ids):
                problem = self._well_health_problem(health_h, i, config)
                if problem is not None:
                    kind, message = problem
                    if kind == "capacity" and rec["retryable"]:
                        retry[well_id] = rec["images"][i]
                        timings["capacity_retries"] += 1
                        continue
                    warnings.warn(f"Well {well_id}: {message}", SegmentationWarning, stacklevel=2)
                    tables[well_id] = None
                    continue
                table = self._results_to_table(
                    props_h, intensity_h, channels, i, rec["image_shape"]
                )
                tables[well_id] = table
                self._record_well(manifest, well_id, table)
            timings["assemble_s"] += time.time() - t0

        def submit_batch(images, ok_ids, inflight: deque, retry) -> None:
            """Dispatch one decoded batch, grouped by image shape: a well
            whose shape differs gets its own dispatch instead of failing its
            batchmates."""
            groups: dict[tuple, list[int]] = {}
            for i, img in enumerate(images):
                groups.setdefault(img.shape, []).append(i)
            for idxs in groups.values():
                rec = dispatch(
                    [images[i] for i in idxs], [ok_ids[i] for i in idxs], self.config, True
                )
                if rec is not None:
                    inflight.append(rec)
            while len(inflight) > max_inflight:
                drain(inflight.popleft(), retry)

        def load_batch(batch_ids: list[str]):
            """Decode one batch (runs on a prefetch worker; touches no shared
            state). Wall and thread-CPU seconds are summed per well."""
            images: list[np.ndarray] = []
            ok_ids: list[str] = []
            failed: list[str] = []
            wall = cpu = 0.0
            for well_id in batch_ids:
                t0, c0 = time.time(), time.thread_time()
                img = fetch(well_id)
                wall += time.time() - t0
                cpu += time.thread_time() - c0
                if img is None:
                    failed.append(well_id)
                else:
                    images.append(img)
                    ok_ids.append(well_id)
            return images, ok_ids, failed, (wall, cpu, len(batch_ids))

        def record_batch(loaded):
            images, ok_ids, failed, (wall, cpu, n) = loaded
            for well_id in failed:
                tables[well_id] = None
            timings["decode_s"] += wall
            timings["decode_cpu_s"] += cpu
            timings["decode_wells"] += n
            return images, ok_ids

        retry: dict[str, np.ndarray] = {}
        inflight: deque = deque()
        progress = _progress_bar(len(batches)) if show_progress else None
        try:
            if prefetch > 0:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=prefetch) as pool:
                    decoding = deque(pool.submit(load_batch, b) for b in batches[:prefetch])
                    next_idx = min(prefetch, len(batches))
                    while decoding:
                        images, ok_ids = record_batch(decoding.popleft().result())
                        if next_idx < len(batches):
                            decoding.append(pool.submit(load_batch, batches[next_idx]))
                            next_idx += 1
                        if images:
                            submit_batch(images, ok_ids, inflight, retry)
                        if progress is not None:
                            progress.update(1)
            else:
                for batch_ids in batches:
                    images, ok_ids = record_batch(load_batch(batch_ids))
                    if images:
                        submit_batch(images, ok_ids, inflight, retry)
                    if progress is not None:
                        progress.update(1)
        finally:
            if progress is not None:
                progress.close()
        while inflight:
            drain(inflight.popleft(), retry)

        # capacity escalation: re-dispatch dense wells with 4x / 16x the
        # capacities, grouped by image shape
        for level in (1, 2):
            if not retry:
                break
            esc = self._escalated_config(level)
            current, retry = retry, {}
            by_shape: dict[tuple, list[str]] = {}
            for w in current:
                by_shape.setdefault(tuple(current[w].shape), []).append(w)
            for ids in by_shape.values():
                for i in range(0, len(ids), batch_size):
                    bids = ids[i : i + batch_size]
                    drain(dispatch([current[w] for w in bids], bids, esc, level < 2), retry)

        return PlateResults(tables, timings)
