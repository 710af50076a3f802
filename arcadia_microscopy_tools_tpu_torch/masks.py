"""Segmentation mask analysis: `SegmentationMask`.

Counterpart of `arcadia_microscopy_tools_tpu/masks.py`, with the same
defaults, frozen fields, cached lazy properties, derived circularity and
volume formulas, per-channel intensity suffixes, `filter` semantics and unit
conversion table, and one keyword more: `device`, where the label image is
made and measured (None means the CUDA card, and raises when there is none;
pass device="cpu" for the plain PyTorch versions of the kernels).

The mask is uploaded once. Labeling (the connected-components kernels for a
bool mask), `clear_border`, `relabel_sequential` and the morphology and
intensity measurements run on the device on that one label tensor; each
measurement comes back to the host in one copy. Outlines, convex hulls,
Feret diameters and the moment families stay on the host (`measure.py`), as
they do in the JAX package.
"""

from __future__ import annotations

import warnings
from collections.abc import Mapping
from dataclasses import dataclass, field
from functools import cached_property
from typing import ClassVar, Literal

import numpy as np
import torch

from .core.channels import Channel
from .measure import convex_areas, extract_outlines, feret_diameters, region_moments
from .ops.labeling import clear_border as _clear_border
from .ops.labeling import label as _label
from .ops.labeling import relabel_sequential as _relabel_sequential
from .ops.regionprops import measure_intensity_stack, measure_labels
from .typing import BoolArray, Float64Array, Int64Array, ScalarArray, UInt16Array
from .utils import resolve_device

__all__ = [
    "DEFAULT_CELL_PROPERTY_NAMES",
    "DEFAULT_INTENSITY_PROPERTY_NAMES",
    "SUPPORTED_PROPERTY_NAMES",
    "SegmentationMask",
]

# Morphology columns produced when the caller does not ask for a specific set.
# Order matches the reference's defaults so downstream tables line up.
DEFAULT_CELL_PROPERTY_NAMES = (
    "label centroid volume area area_convex perimeter eccentricity "
    "circularity solidity axis_major_length axis_minor_length orientation"
).split()

# Per-channel intensity statistics computed by default whenever intensity
# images are attached.
DEFAULT_INTENSITY_PROPERTY_NAMES = (
    "intensity_mean intensity_max intensity_min intensity_std"
).split()

# Properties computed directly by the device measurement.
_DEVICE_PROPERTIES = {
    "area",
    "perimeter",
    "eccentricity",
    "axis_major_length",
    "axis_minor_length",
    "orientation",
    "extent",
}

# Host-side moment-derived property families (skimage regionprops_table
# column layout: "moments-p-q", "inertia_tensor-i-j", ...-eigvals-k).
_MOMENT_PROPERTIES = {
    "moments",
    "moments_central",
    "moments_normalized",
    "inertia_tensor",
    "inertia_tensor_eigvals",
}

SUPPORTED_PROPERTY_NAMES = sorted(
    _DEVICE_PROPERTIES
    | _MOMENT_PROPERTIES
    | {
        "label",
        "centroid",
        "bbox",
        "area_convex",
        "solidity",
        "circularity",
        "volume",
        "feret_diameter_max",
        "equivalent_diameter_area",
    }
)


def _round_up(n: int, multiple: int = 256) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def _process_mask(
    mask_image: BoolArray | Int64Array, remove_edge_cells: bool, device: torch.device
) -> tuple[torch.Tensor, int]:
    """Upload a mask once and make it a consecutive label image on `device`.

    Boolean masks are connected-component labeled; integer masks keep their
    groupings (as int64: labels at or above 2^31 stay distinct).
    Border-touching cells are optionally zeroed first, then labels are
    compacted to 1..num_cells. Returns the int32 label tensor and num_cells,
    the one value read back; raises when removing edge cells empties the
    mask.
    """
    mask = np.asarray(mask_image)
    if mask.dtype != bool:
        mask = mask.astype(np.int64)
    x = torch.from_numpy(np.ascontiguousarray(mask)).to(device)
    lbl = _label(x) if mask.dtype == bool else x
    if remove_edge_cells:
        lbl = _clear_border(lbl)
    lbl = _relabel_sequential(lbl)
    num_cells = int(lbl.max())
    if remove_edge_cells and num_cells == 0:
        raise ValueError(
            "No cells remain after removing edge cells. Try setting remove_edge_cells=False."
        )
    return lbl, num_cells


def _to_host(columns: dict) -> dict[str, np.ndarray]:
    """Device columns of equal length -> numpy arrays of their dtypes, in
    one device-to-host copy (every column is exact in float64)."""
    names = list(columns)
    host = torch.stack([columns[k].to(torch.float64) for k in names]).cpu().numpy()
    dtypes = {torch.bool: bool, torch.int32: np.int32, torch.float32: np.float32}
    return {k: row.astype(dtypes[columns[k].dtype]) for k, row in zip(names, host)}


def _extract_outlines_cellpose(label_image: Int64Array) -> list[Float64Array]:
    """Boundary-pixel outlines, (y, x) format (reference masks.py:68-79)."""
    return extract_outlines(label_image, method="cellpose")


def _extract_outlines_skimage(label_image: Int64Array) -> list[Float64Array]:
    """Sub-pixel marching-squares outlines, (y, x) format
    (reference masks.py:82-115)."""
    return extract_outlines(label_image, method="skimage")


@dataclass
class SegmentationMask:
    """A labeled cell mask plus everything measured from it.

    Construct one from a boolean foreground mask (connected components are
    labeled on the device) or an integer label image (labels are made
    consecutive), then read ``cell_properties`` / ``cell_outlines`` /
    ``centroids_yx`` - each is computed lazily on first access and cached.

    Args:
        mask_image: 2D array - bool foreground or per-cell integer labels
            (0 = background).
        intensity_image_dict: optional {Channel: 2D uint16 plane} whose planes
            share mask_image's shape; intensity statistics get the lowercased
            channel name as a suffix ("intensity_mean_dapi").
        remove_edge_cells: drop cells that touch any image border (default True).
        outline_extractor: "cellpose" (boundary pixels) or "skimage"
            (sub-pixel marching squares).
        property_names: morphology columns to compute; None selects
            DEFAULT_CELL_PROPERTY_NAMES.
        intensity_property_names: intensity statistics to compute; None selects
            DEFAULT_INTENSITY_PROPERTY_NAMES when intensity planes exist.
        device: where labeling and measurement run; None means the CUDA
            card, and raises when there is none.
    """

    mask_image: BoolArray | Int64Array
    intensity_image_dict: Mapping[Channel, UInt16Array] | None = None
    remove_edge_cells: bool = True
    outline_extractor: Literal["cellpose", "skimage"] = "cellpose"
    property_names: list[str] | None = field(default=None)
    intensity_property_names: list[str] | None = field(default=None)
    device: str | torch.device | None = None

    # Every dataclass field is frozen once __post_init__ completes; derived
    # state is allowed through because cached_property stores straight into
    # __dict__ rather than via attribute assignment.
    _FROZEN_SENTINEL: ClassVar[str] = "_initialized"

    def __setattr__(self, name: str, value: object) -> None:
        frozen = self.__dict__.get(self._FROZEN_SENTINEL, False)
        if frozen and name in {f for f in self.__dataclass_fields__}:
            raise AttributeError(
                f"Cannot modify '{name}' after SegmentationMask is initialized. "
                "Create a new instance instead."
            )
        super().__setattr__(name, value)

    def _check_plane(self, arr: object, what: str) -> None:
        """Require a 2D numpy array matching the mask's geometry."""
        if not isinstance(arr, np.ndarray):
            raise TypeError(f"{what} must be a numpy array")
        if arr.ndim != 2:
            raise ValueError(f"{what} must be 2D")
        if arr.shape != self.mask_image.shape:
            raise ValueError(f"{what} must have same shape as mask_image")

    def __post_init__(self):
        """Validate the mask + intensity planes, fill in default columns and
        resolve the device."""
        mask = self.mask_image
        if not isinstance(mask, np.ndarray):
            raise TypeError("mask_image must be a numpy array")
        if mask.ndim != 2:
            raise ValueError("mask_image must be a 2D array")
        lo, hi = (mask.min(), mask.max()) if mask.size else (0, 0)
        if lo < 0:
            raise ValueError("mask_image must have non-negative values")
        if hi == 0:
            raise ValueError("mask_image contains no cells (all values are 0)")

        if self.intensity_image_dict is not None:
            if not isinstance(self.intensity_image_dict, Mapping):
                raise TypeError("intensity_image_dict must be a Mapping of channels to 2D arrays")
            for channel, plane in self.intensity_image_dict.items():
                self._check_plane(plane, f"Intensity image for '{channel.name}'")
            # Own dict, shared arrays: filter() mutating the key set of a
            # derived instance must not leak back into the source instance.
            self.intensity_image_dict = dict(self.intensity_image_dict)

        if self.property_names is None:
            self.property_names = list(DEFAULT_CELL_PROPERTY_NAMES)
        if self.intensity_property_names is None:
            self.intensity_property_names = (
                list(DEFAULT_INTENSITY_PROPERTY_NAMES) if self.intensity_image_dict else []
            )
        self.device = resolve_device(self.device)

        object.__setattr__(self, self._FROZEN_SENTINEL, True)

    @cached_property
    def _processed(self) -> tuple[torch.Tensor, int]:
        """The int32 label tensor on the device and num_cells."""
        return _process_mask(self.mask_image, self.remove_edge_cells, self.device)

    @cached_property
    def label_image(self) -> Int64Array:
        """Processed label image with consecutive labels starting from 1
        (background=0). Edge cells removed if remove_edge_cells=True."""
        return self._processed[0].cpu().numpy().astype(np.int64)

    @cached_property
    def num_cells(self) -> int:
        """Number of cells in the mask (maximum label value)."""
        return self._processed[1]

    @cached_property
    def cell_outlines(self) -> list[Float64Array]:
        """Cell outlines via the configured extractor, ordered by label
        (index 0 = label 1); empty (0, 2) arrays keep alignment."""
        if self.outline_extractor == "cellpose":
            return _extract_outlines_cellpose(self.label_image)
        else:  # must be "skimage" due to Literal type
            return _extract_outlines_skimage(self.label_image)

    @cached_property
    def _device_measurements(self) -> dict[str, np.ndarray]:
        """One device pass of all morphological measurements on the cached
        label tensor, read back at once and trimmed to num_cells."""
        lbl, n = self._processed
        padded = measure_labels(lbl, max_cells=_round_up(n))
        return {k: v[:n] for k, v in _to_host(padded).items()}

    @cached_property
    def _intensity_measurements(self) -> dict[Channel, dict[str, np.ndarray]]:
        """Per-channel intensity statistics of all planes, uploaded as one
        (C, H, W) stack and measured in one device pass."""
        lbl, n = self._processed
        channels = list(self.intensity_image_dict)
        stack = np.stack([self.intensity_image_dict[ch] for ch in channels])
        planes = torch.from_numpy(stack).to(self.device)
        stats = measure_intensity_stack(lbl, planes, max_cells=_round_up(n))
        flat = _to_host({f"{ci}/{k}": v for ci, d in stats.items() for k, v in d.items()})
        return {
            ch: {k: flat[f"{ci}/{k}"][:n] for k in stats[ci]} for ci, ch in enumerate(channels)
        }

    @cached_property
    def cell_properties(self) -> dict[str, ScalarArray]:
        """Extract cell property values (morphological + per-channel intensity).

        For multichannel intensity images, property names are suffixed with
        the lowercased channel name: "intensity_mean_dapi", "intensity_max_fitc".

        Returns:
            Dictionary mapping property names to arrays of values (one per cell).
        """
        assert self.property_names is not None  # type checker blind to __post_init__

        requested = list(self.property_names)
        needs_convex = "area_convex" in requested or "solidity" in requested

        dm = self._device_measurements
        properties: dict[str, ScalarArray] = {}

        convex = convex_areas(self.label_image) if needs_convex else None
        needs_moments = bool(_MOMENT_PROPERTIES & set(requested))
        raw_m = central_m = None
        if needs_moments:
            raw_m, central_m = region_moments(self.label_image)

        for name in requested:
            if name == "label":
                properties["label"] = dm["label"].astype(np.int64)
            elif name == "centroid":
                properties["centroid_y"] = dm["centroid_y"].astype(np.float64)
                properties["centroid_x"] = dm["centroid_x"].astype(np.float64)
            elif name in _DEVICE_PROPERTIES:
                properties[name] = dm[name].astype(np.float64)
            elif name == "bbox":
                properties["bbox-0"] = dm["bbox_min_row"].astype(np.int64)
                properties["bbox-1"] = dm["bbox_min_col"].astype(np.int64)
                properties["bbox-2"] = dm["bbox_max_row"].astype(np.int64)
                properties["bbox-3"] = dm["bbox_max_col"].astype(np.int64)
            elif name == "area_convex":
                properties["area_convex"] = convex  # type: ignore[assignment]
            elif name == "solidity":
                area = dm["area"].astype(np.float64)
                properties["solidity"] = np.where(convex > 0, area / np.maximum(convex, 1), 0.0)
            elif name == "moments":
                for p in range(4):
                    for q in range(4):
                        properties[f"moments-{p}-{q}"] = raw_m[:, p, q]
            elif name == "moments_central":
                for p in range(4):
                    for q in range(4):
                        properties[f"moments_central-{p}-{q}"] = central_m[:, p, q]
            elif name == "moments_normalized":
                mu00 = np.maximum(central_m[:, 0, 0], 1e-30)
                for p in range(4):
                    for q in range(4):
                        if p + q < 2:
                            # undefined below order 2 (skimage leaves nan)
                            values = np.full(central_m.shape[0], np.nan)
                        else:
                            values = central_m[:, p, q] / mu00 ** (1 + (p + q) / 2.0)
                        properties[f"moments_normalized-{p}-{q}"] = values
            elif name in ("inertia_tensor", "inertia_tensor_eigvals"):
                # skimage convention: T[0,0] carries the COLUMN spread
                # (mu[0,2]/mu00) - inertia about axis 0 - and T[1,1] the row
                # spread; central_m indexes as [row power, col power]
                mu00 = np.maximum(central_m[:, 0, 0], 1e-30)
                t00 = central_m[:, 0, 2] / mu00
                t11 = central_m[:, 2, 0] / mu00
                t01 = -central_m[:, 1, 1] / mu00
                if name == "inertia_tensor":
                    properties["inertia_tensor-0-0"] = t00
                    properties["inertia_tensor-0-1"] = t01
                    properties["inertia_tensor-1-0"] = t01
                    properties["inertia_tensor-1-1"] = t11
                else:
                    half_trace = (t00 + t11) / 2.0
                    spread = np.sqrt(((t00 - t11) / 2.0) ** 2 + t01**2)
                    properties["inertia_tensor_eigvals-0"] = half_trace + spread
                    properties["inertia_tensor_eigvals-1"] = np.maximum(
                        half_trace - spread, 0.0
                    )
            elif name == "feret_diameter_max":
                properties["feret_diameter_max"] = feret_diameters(self.label_image)
            elif name == "equivalent_diameter_area":
                area = dm["area"].astype(np.float64)
                properties["equivalent_diameter_area"] = np.sqrt(4.0 * area / np.pi)
            elif name == "circularity":
                # (4*pi*area) / perimeter^2, clamped to 0 when perimeter == 0
                # (reference masks.py:291-297); derived IN PLACE so column
                # order follows the requested order
                area = dm["area"].astype(np.float64)
                perimeter = dm["perimeter"].astype(np.float64)
                properties["circularity"] = np.where(
                    perimeter > 0, (4.0 * np.pi * area) / (perimeter**2), 0.0
                )
            elif name == "volume":
                # prolate spheroid (4/3)*pi*a*b^2 from the 2D semi-axes
                # (reference masks.py:299-305)
                a = dm["axis_major_length"].astype(np.float64) / 2.0
                b = dm["axis_minor_length"].astype(np.float64) / 2.0
                properties["volume"] = np.where(
                    (a > 0) & (b > 0), (4.0 / 3.0) * np.pi * a * b * b, 0.0
                )
            else:
                raise ValueError(
                    f"Unsupported property name: '{name}'. Supported names: "
                    f"{SUPPORTED_PROPERTY_NAMES}"
                )

        if self.intensity_image_dict and self.intensity_property_names:
            for channel, stats in self._intensity_measurements.items():
                for prop_name in self.intensity_property_names:
                    if prop_name not in stats:
                        raise ValueError(
                            f"Unsupported intensity property name: '{prop_name}'"
                        )
                    properties[f"{prop_name}_{channel.name.lower()}"] = stats[prop_name].astype(
                        np.float64
                    )

        return properties

    @cached_property
    def centroids_yx(self) -> Float64Array:
        """(num_cells, 2) array of per-cell (row, col) centroids; empty with a
        warning when 'centroid' was not among the requested properties."""
        assert self.property_names is not None

        if "centroid" not in self.property_names:
            warnings.warn(
                "Centroid property not available. Include 'centroid' in property_names "
                "to get centroid coordinates. Returning empty array.",
                UserWarning,
                stacklevel=2,
            )
            return np.empty((0, 2), dtype=np.float64)

        table = self.cell_properties
        return np.column_stack(
            [np.asarray(table["centroid_y"], float), np.asarray(table["centroid_x"], float)]
        )

    def filter(
        self,
        property_name: str,
        min_value: float | None = None,
        max_value: float | None = None,
    ) -> SegmentationMask:
        """Derive a new mask keeping only cells whose ``property_name`` value
        lies inside ``[min_value, max_value]`` (either bound may be open).

        Surviving cells keep their pixels; dropped cells become background.
        The derived instance skips edge-cell removal (it already happened
        here, if requested) and inherits all other settings, the device
        included.

        Raises:
            ValueError: when both bounds are None, when the property was never
                computed, or when the filter would empty the mask.
        """
        assert self.property_names is not None
        assert self.intensity_property_names is not None

        if min_value is None and max_value is None:
            raise ValueError("At least one of min_value or max_value must be provided.")

        table = self.cell_properties
        if property_name not in table:
            raise ValueError(
                f"Property '{property_name}' not found. "
                f"Available properties: {list(table)}"
            )

        values = np.asarray(table[property_name])
        inside = np.ones(values.shape, dtype=bool)
        if min_value is not None:
            inside &= values >= min_value
        if max_value is not None:
            inside &= values <= max_value

        if not inside.any():
            raise ValueError(
                f"No cells remain after filtering '{property_name}' "
                f"with min={min_value}, max={max_value}."
            )

        # Remap through a lookup table indexed by label id: one gather over
        # the image. Slot 0 stays 0 so background is preserved; dropped labels
        # map to 0.
        lut = np.zeros(self.num_cells + 1, dtype=np.int64)
        survivors = np.flatnonzero(inside) + 1
        lut[survivors] = survivors
        filtered_labels = lut[self.label_image]

        return SegmentationMask(
            mask_image=filtered_labels,
            intensity_image_dict=self.intensity_image_dict,
            remove_edge_cells=False,
            outline_extractor=self.outline_extractor,
            property_names=list(self.property_names),
            intensity_property_names=list(self.intensity_property_names),
            device=self.device,
        )

    # Unit-conversion exponents: pixel_size_um ** n, suffixed _um / _um2 / _um3.
    # Tensor columns arrive suffixed ("inertia_tensor-0-0"), so conversion is
    # keyed on the base name before the first '-'.
    _MICRON_EXPONENTS: ClassVar[dict[str, int]] = {
        "perimeter": 1,
        "axis_major_length": 1,
        "axis_minor_length": 1,
        "feret_diameter_max": 1,
        "equivalent_diameter_area": 1,
        "area": 2,
        "area_convex": 2,
        "inertia_tensor": 2,
        "inertia_tensor_eigvals": 2,
        "volume": 3,
    }

    def convert_properties_to_microns(
        self,
        pixel_size_um: float,
    ) -> dict[str, ScalarArray]:
        """Rescale length-bearing properties from pixel units to microns.

        Each convertible column is multiplied by ``pixel_size_um ** n`` where
        n is its length dimension (1 for lengths, 2 for areas and inertia
        tensors, 3 for volumes) and renamed with the matching ``_um``/
        ``_um2``/``_um3`` suffix. Dimensionless shape factors, label ids,
        centroid pixel coordinates, and intensity statistics pass through
        untouched.
        """
        out: dict[str, ScalarArray] = {}
        for name, values in self.cell_properties.items():
            power = self._MICRON_EXPONENTS.get(name.split("-", 1)[0])
            if power is None:
                out[name] = values
            else:
                suffix = "_um" if power == 1 else f"_um{power}"
                out[f"{name}{suffix}"] = values * pixel_size_um**power
        return out
