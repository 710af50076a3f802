"""High-throughput segmentation model wrapper.

Counterpart of `arcadia_microscopy_tools_tpu/models/segmentation.py`, the
API twin of the reference's Cellpose `SegmentationModel`: the same defaults
(diameter 30, flow_threshold 0.4, cellprob_threshold 0, niter None, batch
size 8), the same validation ranges, the same host preparation (1-99
percentile stretch, zoom to the canonical diameter, edge pad to a multiple
of 16), and `batch_segment`'s per-image failure isolation
(SegmentationWarning and a None placeholder, indices preserved).

Underneath, a device batch runs the network and the batched mask
reconstruction (models/flows.py). The network is the PyTorch U-Net
(models/unet.py, `network="unet"`, the default) or Cellpose-SAM
(models/vit_sam.py, `network="cpsam"`), which sees each image as Cellpose
does: 256 x 256 tiles (models/sam_tiles.py) through the encoder in
micro-batches of `SAM_MICRO_BATCH` tiles, blended back with Cellpose's
taper. Its input is the same 1-99 percentile stretch of the first three
planes, clipped to [0, 1] (Cellpose's `normalize99` does not clip), and is
not padded to a multiple of 16. An image whose expected
diameter needs no zoom (scale 1) is copied to the device as given and its
chunk stretched there (models/stretch_cuda.py, the same values as the numpy
`_prepare_image`); an image that needs a zoom is prepared on the host by
`_prepare_image`, since the zoom has no device counterpart. The model runs
on the CUDA card unless constructed with `device="cpu"`, which runs the
kernels' plain PyTorch versions; without a card and without that choice it
raises.
"""

from __future__ import annotations

import logging
import warnings
from collections.abc import Sequence
from dataclasses import InitVar, dataclass, field
from pathlib import Path
from typing import Any, TypedDict

import numpy as np
import torch
import torch.nn.functional as F

from ..exceptions import SegmentationWarning
from ..typing import Float64Array, Int64Array
from ..utils import get_tqdm, resolve_device
from ..utils.profiling import StageTimer
from .flows import compute_masks
from .sam_tiles import average_tiles, crop_padding, make_tiles, pad_to_tile, tile_count
from .stretch_cuda import percentile_stretch
from .unet import UNet, UNetConfig
from .vit_sam import CellposeSAM, SamConfig, seeded_state_dict
from .weights import DEFAULT_WEIGHTS, load_state_dict, load_weights

__all__ = [
    "NETWORKS",
    "SAM_MICRO_BATCH",
    "SegmentationModel",
    "SegmentationParams",
    "find_best_available_device",
]

logger = logging.getLogger(__name__)

_DOWNSAMPLE_MULTIPLE = 16  # pad H, W to this multiple for the U-Net
NETWORKS = ("unet", "cpsam")
# Cellpose-SAM tiles per encoder call: at the published widths a call of 64
# tiles holds ~2.5 GB of activations besides the chunk's tiles and maps
SAM_MICRO_BATCH = 64
# dtypes copied to the device as given; any other is cast to float32 on the host
_DEVICE_DTYPES = (np.dtype(np.float64), np.dtype(np.float32), np.dtype(np.uint16))


def _needs_zoom(scale: float) -> bool:
    """Whether the expected diameter calls for a zoom (`_prepare_image`)."""
    return abs(scale - 1.0) > 1e-3


@dataclass(frozen=True)
class _Staged:
    """One image of a call, checked and grouped, not yet prepared."""

    index: int  # in the call
    array: np.ndarray  # ([C], H, W) as the caller gave it
    hw: tuple[int, int]  # original size
    hws: tuple[int, int]  # after the zoom
    padded: tuple[int, int]  # (Hp, Wp), the U-Net's input size


class SegmentationParams(TypedDict):
    """Resolved parameters for a segmentation run."""

    diameter: float
    flow_threshold: float
    cellprob_threshold: float
    niter: int | None
    batch_size: int


def find_best_available_device() -> torch.device:
    """The CUDA card; raises when there is none (no silent CPU fallback:
    pass device="cpu" to run on the CPU)."""
    return resolve_device(None)


class _Network:
    """`SegmentationModel.network`: on the class, the init argument's default
    ("unet"); on a model, its network (U-Net or Cellpose-SAM) on the model's
    device, built at first use."""

    def __get__(self, model, owner=None):
        return "unet" if model is None else model._built_network()


@dataclass
class SegmentationModel:
    """Segmentation wrapper for high-throughput cell segmentation.

    Attributes:
        network: "unet" (the Cellpose-style U-Net, the default) or "cpsam"
            (Cellpose-SAM); an init argument, read back as `architecture`.
            After construction `network` is the built network.
        default_cell_diameter_px: default expected cell diameter in pixels (30).
        default_flow_threshold: default flow-error threshold; higher keeps
            more masks. Must be >= 0. Default 0.4.
        default_cellprob_threshold: default cell-probability threshold,
            between -10 and 10. Default 0.
        default_num_iterations: default flow-integration steps; None uses
            200 (the canonical count at the canonical diameter).
        default_batch_size: images per device batch. Default 8.
        device: torch device; None means the CUDA card (raises without one).
        checkpoint_path: U-Net: `.npz` of the JAX parameter tree
            (models/weights.py); Cellpose-SAM: a torch state dict in the
            published layout (such as Cellpose's `cpsam`), read with
            `torch.load(weights_only=True)`; otherwise seeded weights
            (identical pipeline, untrained network). A directory (the JAX
            package's orbax checkpoint) is a ValueError.
        seed: seed of the torch generator for seeded weights.
        stages: host seconds and calls of each step over the model's life,
            each a named profiler range: "segment.prepare" (one image's
            host work before its chunk's forward: the copy to the device,
            or on the host route its `_prepare_image`, inside
            "segment.prepare.host", which opens for no other image),
            "segment.stretch" (a chunk's stretch on the device, enqueued),
            "segment.upload" (the host route's stack and copy of a chunk),
            "segment.forward", "segment.masks" (`compute_masks`),
            "segment.readback" (labels, and maps where asked for, to the
            host) and "segment.finish" (upscale and int64 cast of one mask).
            Cellpose-SAM runs "segment.tiles" (a chunk's padding and tiles,
            args "<n> tiles"), "segment.encoder" (one micro-batch, args
            "tiles a-b", waiting for its maps, so its total is the
            encoder's time; `counts["segment.encoder.tiles"]` adds up its
            tiles) and "segment.blend" in place of "segment.forward".
    """

    default_cell_diameter_px: float = 30
    default_flow_threshold: float = 0.4
    default_cellprob_threshold: float = 0
    default_num_iterations: int | None = None
    default_batch_size: int = 8
    device: str | torch.device | None = None
    checkpoint_path: Path | str | None = None
    seed: int = 0
    max_cells: int = 4096
    min_size: int = 15
    network: InitVar[str] = _Network()
    architecture: str = field(default="unet", init=False)
    _network: UNet | CellposeSAM | None = field(default=None, init=False, repr=False)
    _config: UNetConfig = field(default_factory=UNetConfig, init=False, repr=False)
    _sam_config: SamConfig = field(default_factory=SamConfig, init=False, repr=False)
    stages: StageTimer = field(default_factory=StageTimer, init=False, repr=False)

    def __post_init__(self, network: str) -> None:
        if network not in NETWORKS:
            raise ValueError(f"network must be one of {NETWORKS}, got {network!r}")
        self.architecture = network
        if self.checkpoint_path is not None and Path(self.checkpoint_path).is_dir():
            raise ValueError(
                f"checkpoint_path {self.checkpoint_path} is a directory (the JAX package's "
                "orbax checkpoint); the port reads an .npz of the flattened parameter tree, "
                f"such as {DEFAULT_WEIGHTS.name} beside models/weights.py. Export one where "
                "orbax and the JAX package are installed with "
                "np.savez(path, **flatten_tree(load_checkpoint(directory)))"
            )
        self.device = resolve_device(self.device)

    def _resolve_and_validate_parameters(
        self,
        cell_diameter_px: float | None,
        flow_threshold: float | None,
        cellprob_threshold: float | None,
        num_iterations: int | None,
        batch_size: int | None,
    ) -> SegmentationParams:
        """Resolve parameters from the given values or the defaults, then
        validate them (same ranges as the reference)."""
        params: SegmentationParams = {
            "diameter": cell_diameter_px
            if cell_diameter_px is not None
            else self.default_cell_diameter_px,
            "flow_threshold": flow_threshold
            if flow_threshold is not None
            else self.default_flow_threshold,
            "cellprob_threshold": cellprob_threshold
            if cellprob_threshold is not None
            else self.default_cellprob_threshold,
            "niter": num_iterations if num_iterations is not None else self.default_num_iterations,
            "batch_size": batch_size if batch_size is not None else self.default_batch_size,
        }
        if params["diameter"] <= 0:
            raise ValueError(f"Cell diameter [px] must be positive, got {params['diameter']}")
        if params["flow_threshold"] < 0:
            raise ValueError(
                f"Flow threshold must be non-negative, got {params['flow_threshold']}"
            )
        if not (-10 <= params["cellprob_threshold"] <= 10):
            raise ValueError(
                "Cell probability threshold must be between -10 and 10, got "
                f"{params['cellprob_threshold']}"
            )
        return params

    def _built_network(self) -> UNet | CellposeSAM:
        """The network on the model's device, built once (checkpoint or
        seeded): `network` after construction."""
        if self._network is None and self.architecture == "cpsam":
            if self.checkpoint_path is not None:
                logger.info(f"Loading Cellpose-SAM weights from {self.checkpoint_path}")
                state = load_state_dict(self.checkpoint_path)
            else:
                generator = torch.Generator().manual_seed(self.seed)
                state = seeded_state_dict(self._sam_config, generator)
            self._network = CellposeSAM(state, self._sam_config, device=self.device)
        if self._network is None:
            if self.checkpoint_path is not None:
                logger.info(f"Loading U-Net weights from {self.checkpoint_path} on {self.device}")
                # a private generator: the init is overwritten and must not
                # draw from the process's global random state
                net = UNet(self._config, generator=torch.Generator())
                net.load_state_dict(load_weights(self.checkpoint_path))
            else:
                logger.info(f"Initializing seeded U-Net weights on {self.device}")
                net = UNet(self._config, generator=torch.Generator().manual_seed(self.seed))
            self._network = net.to(self.device).eval()
        return self._network

    # canonical cell diameter the net is trained at
    _CANONICAL_DIAMETER = 30.0

    @staticmethod
    def _prepare_image(
        intensities: np.ndarray, scale: float = 1.0, multiple: int = _DOWNSAMPLE_MULTIPLE
    ) -> tuple[np.ndarray, tuple[int, int], tuple[int, int]]:
        """Normalise to [0, 1] by the 1-99 percentile stretch, arrange as
        (H, W, 3), rescale so the expected diameter hits the canonical
        training scale, and edge-pad to a multiple of `multiple` (the
        U-Net's 16; 1 for Cellpose-SAM).

        Returns (float32 (Hp, Wp, 3) image, original (h, w), scaled (hs, ws))."""
        x = np.asarray(intensities, dtype=np.float32)
        if x.ndim == 2:
            x = x[None]
        if x.ndim != 3:
            raise ValueError(f"Expected ([C], H, W) input, got shape {x.shape}")
        c, h, w = x.shape
        if c > 3:
            x = x[:3]
        elif c < 3:
            x = np.concatenate([x] + [x[-1:]] * (3 - c), axis=0)

        p1 = np.percentile(x, 1, axis=(1, 2), keepdims=True)
        p99 = np.percentile(x, 99, axis=(1, 2), keepdims=True)
        denom = np.maximum(p99 - p1, 1e-6)
        x = np.clip((x - p1) / denom, 0.0, 1.0)

        if _needs_zoom(scale):
            from scipy.ndimage import zoom

            x = zoom(x, (1.0, scale, scale), order=1)
        hs, ws = x.shape[1], x.shape[2]

        pad_h = (-hs) % multiple
        pad_w = (-ws) % multiple
        x = np.pad(x, ((0, 0), (0, pad_h), (0, pad_w)), mode="edge")
        return np.ascontiguousarray(np.moveaxis(x, 0, -1), dtype=np.float32), (h, w), (hs, ws)

    @staticmethod
    def _upscale_labels(labels: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
        """Nearest-neighbour resize of a label image back to the original grid."""
        hs, ws = labels.shape
        h, w = shape
        if (hs, ws) == (h, w):
            return labels
        yi = np.minimum(((np.arange(h) + 0.5) * hs / h).astype(int), hs - 1)
        xi = np.minimum(((np.arange(w) + 0.5) * ws / w).astype(int), ws - 1)
        return labels[yi[:, None], xi[None, :]]

    def _rescale_factor(self, params: SegmentationParams) -> float:
        return self._CANONICAL_DIAMETER / float(params["diameter"])

    def _resolve_niter(self, params: SegmentationParams) -> int:
        if params["niter"] is not None:
            return int(params["niter"])
        return 200

    def _staged(self, index: int, intensities, scale: float) -> _Staged:
        """Check one image of a call and find its padded shape from (h, w)
        and the scale alone, without preparing it."""
        x = np.asarray(intensities)
        if x.ndim not in (2, 3):
            raise ValueError(f"Expected ([C], H, W) input, got shape {x.shape}")
        if 0 in x.shape:
            raise ValueError(f"Expected a non-empty ([C], H, W) image, got shape {x.shape}")
        h, w = x.shape[-2:]
        # scipy.ndimage.zoom's output shape
        hs, ws = (round(h * scale), round(w * scale)) if _needs_zoom(scale) else (h, w)
        m = self._multiple
        padded = (hs + (-hs) % m, ws + (-ws) % m)
        return _Staged(index, x, (h, w), (hs, ws), padded)

    @property
    def _multiple(self) -> int:
        """What the network's input is padded to a multiple of."""
        return 1 if self.architecture == "cpsam" else _DOWNSAMPLE_MULTIPLE

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """One image's first three planes on the device, in the caller's
        float64, float32 or uint16 (any other dtype cast to float32 here)."""
        if x.dtype not in _DEVICE_DTYPES:
            x = np.asarray(x, dtype=np.float32)
        x = np.ascontiguousarray((x[None] if x.ndim == 2 else x)[:3])
        return torch.from_numpy(x).to(self.device)

    def _prepared(self, chunk: list[_Staged], scale: float) -> torch.Tensor:
        """The (N, Hp, Wp, 3) float32 U-Net input of one chunk of images of
        one padded shape, on the device. Without a zoom each image is copied
        as it is and the chunk stretched on the device (`percentile_stretch`,
        the same values as `_prepare_image`); with one each image goes
        through the numpy `_prepare_image`."""
        if _needs_zoom(scale):
            images = []
            for item in chunk:
                with self.stages.stage("segment.prepare"):
                    with self.stages.stage("segment.prepare.host"):
                        images.append(self._prepare_image(item.array, scale, self._multiple)[0])
                if images[-1].shape[:2] != item.padded:
                    raise RuntimeError(f"prepared {images[-1].shape[:2]}, not {item.padded}")
            with self.stages.stage("segment.upload"):
                return torch.from_numpy(np.stack(images)).to(self.device)
        planes = []
        for item in chunk:
            with self.stages.stage("segment.prepare"):
                planes.append(self._upload(item.array))
        with self.stages.stage("segment.stretch"):
            return percentile_stretch(planes, *chunk[0].padded)

    def _sam_maps(self, x: torch.Tensor) -> torch.Tensor:
        """Cellpose-SAM's (N, H, W, 3) float32 maps of (N, H, W, 3) prepared
        images: Cellpose's tiles, the encoder on micro-batches of
        SAM_MICRO_BATCH tiles, the taper blend."""
        net = self.network
        c = net.config
        n, h, w, _ = x.shape
        with self.stages.stage("segment.tiles", args=f"{n * tile_count(h, w, c.tile)} tiles"):
            img, offsets = pad_to_tile(x.permute(0, 3, 1, 2), c.tile)
            tiles = make_tiles(img, c.tile)
        maps = torch.empty((tiles.shape[0], c.maps, c.tile, c.tile), dtype=torch.float32,
                           device=tiles.device)
        for a in range(0, tiles.shape[0], SAM_MICRO_BATCH):
            b = min(a + SAM_MICRO_BATCH, tiles.shape[0])
            with self.stages.stage("segment.encoder", block=maps, args=f"tiles {a}-{b - 1}"):
                maps[a:b] = net(tiles[a:b])
            counts = self.stages.counts  # a counter with no time: the tiles encoded
            counts["segment.encoder.tiles"] = counts.get("segment.encoder.tiles", 0) + b - a
        del tiles
        with self.stages.stage("segment.blend"):
            y = average_tiles(maps, n, *img.shape[-2:])
            return crop_padding(y, offsets, (h, w)).permute(0, 2, 3, 1).contiguous()

    def _labels_of(self, x: torch.Tensor, params: SegmentationParams,
                   with_flows: bool = False) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
        """One device batch: (N, Hp, Wp, 3) prepared images -> (N, Hp, Wp)
        int32 labels on the host, and with `with_flows` the network's
        (N, Hp, Wp, 3) float32 maps there too."""
        with torch.inference_mode():
            if self.architecture == "cpsam":
                out = self._sam_maps(x)
            else:
                with self.stages.stage("segment.forward"):
                    out = self.network(x)
            with self.stages.stage("segment.masks"):
                labels = compute_masks(
                    out,
                    cellprob_threshold=float(params["cellprob_threshold"]),
                    flow_threshold=float(params["flow_threshold"]),
                    niter=self._resolve_niter(params),
                    max_cells=self.max_cells,
                    min_size=self.min_size,
                )
        with self.stages.stage("segment.readback"):
            if with_flows:
                return labels.cpu().numpy(), out.float().cpu().numpy()
            return labels.cpu().numpy()

    @staticmethod
    def _resize_flows(flows: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
        """(hs, ws, 3) maps back to the original (h, w) grid, bilinearly."""
        if flows.shape[:2] == tuple(shape):
            return flows
        t = torch.from_numpy(np.ascontiguousarray(flows)).permute(2, 0, 1)[None]
        t = F.interpolate(t, size=tuple(shape), mode="bilinear", align_corners=False)
        return t[0].permute(1, 2, 0).contiguous().numpy()

    def _segment_chunk(
        self, chunk: list[_Staged], scale: float, params: SegmentationParams,
        with_flows: bool = False,
    ) -> list[Int64Array] | tuple[list[Int64Array], list[np.ndarray]]:
        """Prepare, segment and finish one chunk: its int64 label images at
        the original sizes and, with `with_flows`, the network's float32
        (h, w, 3) maps at those sizes. Only this chunk's input is on the
        device."""
        x = self._prepared(chunk, scale)
        if with_flows:
            labels, maps = self._labels_of(x, params, with_flows=True)
        else:
            labels, maps = self._labels_of(x, params), None
        del x
        masks, flows = [], []
        for k, item in enumerate(chunk):
            hs, ws = item.hws
            with self.stages.stage("segment.finish"):
                masks.append(self._upscale_labels(labels[k][:hs, :ws], item.hw).astype(np.int64))
                if with_flows:
                    flows.append(self._resize_flows(maps[k][:hs, :ws], item.hw))
        return (masks, flows) if with_flows else masks

    def segment(
        self,
        intensities: Float64Array,
        cell_diameter_px: float | None = None,
        flow_threshold: float | None = None,
        cellprob_threshold: float | None = None,
        num_iterations: int | None = None,
        batch_size: int | None = None,
        return_flows: bool = False,
        **extra_kwargs: Any,
    ) -> Int64Array | tuple[Int64Array, np.ndarray]:
        """Segment one ([C], H, W) image; returns int64 labels (background 0)
        and, with `return_flows`, the network's (H, W, 3) float32 maps
        (dY, dX, cell probability).

        Raises ValueError for out-of-range parameters and RuntimeError when
        the segmentation itself fails."""
        resolved = self._resolve_and_validate_parameters(
            cell_diameter_px, flow_threshold, cellprob_threshold, num_iterations, batch_size
        )
        scale = self._rescale_factor(resolved)
        try:
            got = self._segment_chunk([self._staged(0, intensities, scale)], scale, resolved,
                                      return_flows)
            return (got[0][0], got[1][0]) if return_flows else got[0]
        except ValueError:
            raise
        except Exception as e:  # noqa: BLE001 - mirrors the reference's error wrapping
            raise RuntimeError(f"Segmentation failed: {e}") from e

    def batch_segment(
        self,
        intensities_batch: Sequence[Float64Array],
        cell_diameter_px: float | None = None,
        flow_threshold: float | None = None,
        cellprob_threshold: float | None = None,
        num_iterations: int | None = None,
        batch_size: int | None = None,
        show_progress: bool = True,
        return_flows: bool = False,
        **extra_kwargs: Any,
    ) -> list[Int64Array | None] | tuple[list[Int64Array | None], list[np.ndarray | None]]:
        """Segment many images with one set of parameters.

        Images are grouped by padded shape and run in chunks of
        `batch_size`, each prepared just before its forward. A failed chunk
        is retried image by image; each image that fails emits a
        SegmentationWarning and leaves None at its index. With
        `return_flows` the result is (masks, flows): each image's network
        maps as a float32 (H, W, 3) array (dY, dX, cell probability) at its
        original size, as Cellpose's `eval` returns its flows, or None.
        """
        resolved = self._resolve_and_validate_parameters(
            cell_diameter_px, flow_threshold, cellprob_threshold, num_iterations, batch_size
        )
        bs = max(1, int(resolved["batch_size"]))
        masks: list[Int64Array | None] = [None] * len(intensities_batch)
        flows: list[np.ndarray | None] = [None] * len(intensities_batch)
        progress = get_tqdm()(total=len(intensities_batch), desc="Segmenting") if show_progress else None

        def fail(i: int, e: Exception) -> None:
            warnings.warn(f"Segmentation failed on image {i}: {e}", SegmentationWarning, stacklevel=3)

        scale = self._rescale_factor(resolved)
        groups: dict[tuple[int, int], list[_Staged]] = {}
        for i, intensities in enumerate(intensities_batch):
            try:
                item = self._staged(i, intensities, scale)
                groups.setdefault(item.padded, []).append(item)
            except Exception as e:  # noqa: BLE001
                fail(i, e)
                if progress is not None:
                    progress.update(1)

        for group in groups.values():
            for start in range(0, len(group), bs):
                chunk = group[start : start + bs]
                try:
                    self._place(chunk, scale, resolved, return_flows, masks, flows)
                except Exception as e:  # noqa: BLE001
                    logger.debug(f"Batched dispatch failed ({e}); isolating per image")
                    for item in chunk:
                        try:
                            self._place([item], scale, resolved, return_flows, masks, flows)
                        except Exception as e1:  # noqa: BLE001
                            fail(item.index, e1)
                if progress is not None:
                    progress.update(len(chunk))

        if progress is not None:
            progress.close()
        return (masks, flows) if return_flows else masks

    def _place(self, chunk: list[_Staged], scale: float, params: SegmentationParams,
               with_flows: bool, masks: list, flows: list) -> None:
        """Segment one chunk and put its masks (and flows) at their indices."""
        got = self._segment_chunk(chunk, scale, params, with_flows)
        chunk_masks, chunk_flows = got if with_flows else (got, [None] * len(chunk))
        for item, mask, flow in zip(chunk, chunk_masks, chunk_flows):
            masks[item.index], flows[item.index] = mask, flow

