"""Typed building blocks for instrument metadata.

Every loaded image carries, per channel, a tree of small frozen-ish records:
which axes exist (`DimensionFlags`), the nominal grid geometry
(`NominalDimensions`), the per-frame coordinates the hardware actually
reported (`MeasuredDimensions`), exposure/scan settings
(`AcquisitionSettings`), and the optical train (`MicroscopeConfig`) - all
aggregated by `ChannelMetadata`.

The field inventory and names are a public contract shared with the reference
library (`src/arcadia_microscopy_tools/metadata_structures.py:34-141`) and
are pinned by the golden-metadata tests. Validation works differently here:
instead of per-field dataclass metadata walked by a mixin, each record
declares a single CONDITIONAL table mapping "axis flag" -> "fields that must
be populated when that axis exists", and `_check_required` enforces it. The
outcome is identical (a ValueError naming the missing field and the flag)
with one obvious place to read the requirements per class.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime
from enum import Flag, auto

from ..typing import Float64Array
from .channels import Channel

__all__ = [
    "DimensionFlags",
    "DimensionValidatorMixin",
    "dimension_field",
    "NominalDimensions",
    "MeasuredDimensions",
    "AcquisitionSettings",
    "MicroscopeConfig",
    "ChannelMetadata",
]


class DimensionFlags(Flag):
    """Which acquisition axes an image has, as OR-able bits.

    A plain 2-D frame is `SPATIAL_2D` (no bits set); every extra axis the
    file declares sets one bit. Parsers OR these together and downstream
    code asks questions through the `is_*` predicates.
    """

    SPATIAL_2D = 0
    MULTICHANNEL = auto()
    Z_STACK = auto()
    TIMELAPSE = auto()
    SPECTRAL = auto()
    RGB = auto()
    MONTAGE = auto()

    @property
    def is_multichannel(self) -> bool:
        return DimensionFlags.MULTICHANNEL in self

    @property
    def is_zstack(self) -> bool:
        return DimensionFlags.Z_STACK in self

    @property
    def is_timelapse(self) -> bool:
        return DimensionFlags.TIMELAPSE in self

    @property
    def is_spectral(self) -> bool:
        return DimensionFlags.SPECTRAL in self

    @property
    def is_rgb(self) -> bool:
        return DimensionFlags.RGB in self

    @property
    def is_montage(self) -> bool:
        return DimensionFlags.MONTAGE in self


def dimension_field(dimension: "DimensionFlags", default=None):
    """A dataclass field required only when `dimension` is present.

    User-extension compatibility with the reference's field-metadata
    mechanism (`src/arcadia_microscopy_tools/metadata_structures.py:14-17`):
    records built from these fields validate through
    `DimensionValidatorMixin`. The built-in records here use the equivalent
    `_CONDITIONAL`-table mechanism instead (see module docstring); both
    raise the same error for the same omission.
    """
    from dataclasses import field

    return field(default=default, metadata={"requires_dimension": dimension})


class DimensionValidatorMixin:
    """Validation mixin for dataclasses using `dimension_field`
    (reference `metadata_structures.py:20-31`): `validate(dimensions)`
    raises when a set axis flag demands a field that is still None."""

    def validate(self, dimensions: "DimensionFlags") -> None:
        for field_info in self.__dataclass_fields__.values():  # type: ignore[attr-defined]
            required = field_info.metadata.get("requires_dimension")
            if required and (dimensions & required):
                if getattr(self, field_info.name) is None:
                    raise ValueError(
                        f"{field_info.name} is required for {required.name}"
                    )


def _check_required(
    record: object,
    conditional: dict[DimensionFlags, tuple[str, ...]],
    dimensions: DimensionFlags,
) -> None:
    """Raise if an axis flag is set but a field it requires is missing."""
    for flag, names in conditional.items():
        if not (dimensions & flag):
            continue
        for name in names:
            if getattr(record, name) is None:
                raise ValueError(f"{name} is required for {flag.name}")


@dataclass
class NominalDimensions:
    """Declared grid geometry: axis extents plus the intended step sizes.

    X/Y are always present; the optional axes carry a (size, step) pair each
    and are mandatory exactly when the matching `DimensionFlags` bit is set.
    """

    # fields conditionally required, keyed by the axis flag that demands them
    _CONDITIONAL = {
        DimensionFlags.Z_STACK: ("z_size_px", "z_step_um"),
        DimensionFlags.TIMELAPSE: ("t_size_px", "t_step_ms"),
        DimensionFlags.SPECTRAL: ("w_size_px", "w_step_nm"),
    }

    x_size_px: int  # frame width, pixels
    y_size_px: int  # frame height, pixels
    xy_step_um: float  # lateral pixel pitch, micrometers
    z_size_px: int | None = None  # focal planes per stack
    z_step_um: float | None = None  # focus step, micrometers
    t_size_px: int | None = None  # frames per timelapse
    t_step_ms: float | None = None  # frame interval, milliseconds
    w_size_px: int | None = None  # spectral sampling points
    w_step_nm: float | None = None  # spectral step, nanometers

    def validate(self, dimensions: DimensionFlags) -> None:
        """Check that every axis in `dimensions` has its geometry filled in."""
        _check_required(self, self._CONDITIONAL, dimensions)


@dataclass
class MeasuredDimensions:
    """Per-frame coordinates as the hardware actually recorded them.

    Stage drift, focus jitter, and deliberately non-uniform sampling all make
    the true coordinates differ from the nominal step grid; these arrays are
    the ground truth when they exist.
    """

    _CONDITIONAL = {
        DimensionFlags.MONTAGE: ("x_values_um", "y_values_um"),
        DimensionFlags.Z_STACK: ("z_values_um",),
        DimensionFlags.TIMELAPSE: ("t_values_ms",),
        DimensionFlags.SPECTRAL: ("w_values_nm",),
    }

    x_values_um: Float64Array | None = None  # stage X per tile (montages)
    y_values_um: Float64Array | None = None  # stage Y per tile (montages)
    z_values_um: Float64Array | None = None  # focus position per plane
    t_values_ms: Float64Array | None = None  # wall-clock time per frame
    w_values_nm: Float64Array | None = None  # wavelength per spectral step

    def validate(self, dimensions: DimensionFlags) -> None:
        """Check that every axis in `dimensions` has its coordinates."""
        _check_required(self, self._CONDITIONAL, dimensions)


@dataclass
class AcquisitionSettings:
    """Detector and scan settings for one channel's capture.

    Camera systems populate exposure/binning; point scanners populate dwell
    time, line rate, and the averaging/accumulation counters. Everything is
    optional - parsers fill in what the file format records.
    """

    exposure_time_s: float | None = None  # camera integration time
    zoom: float | None = None  # scanner digital zoom factor
    binning: str | None = None  # camera pixel binning, e.g. "2x2"
    pixel_dwell_time_us: float | None = None  # scanner time per pixel
    line_scan_speed_hz: float | None = None  # scan line rate
    line_averaging: int | None = None  # lines averaged per scan line
    line_accumulation: int | None = None  # lines summed per scan line
    frame_averaging: int | None = None  # frames averaged per image
    frame_accumulation: int | None = None  # frames summed per image

    def validate(self, dimensions: DimensionFlags) -> None:
        """No settings are axis-conditional; present for interface symmetry."""


@dataclass
class MicroscopeConfig:
    """The optical train: objective magnification/NA and the illumination."""

    magnification: int  # objective magnification, e.g. 20
    numerical_aperture: float  # objective NA
    objective: str | None = None  # full objective description string
    light_source: str | None = None  # laser / lamp identity
    power_mw: float | None = None  # illumination power at the sample


@dataclass
class ChannelMetadata:
    """Everything known about one acquired channel, validated on construction.

    Aggregates the channel identity, acquisition timestamp, axis flags, and
    the four sub-records; `__post_init__` immediately cross-checks the
    geometry records against the axis flags so a half-parsed file fails
    loudly at load time rather than deep inside analysis code.
    """

    channel: Channel  # identity + display color + ex/em wavelengths
    timestamp: datetime  # acquisition start
    dimensions: DimensionFlags  # which axes exist
    resolution: NominalDimensions  # nominal grid geometry
    measured: MeasuredDimensions  # recorded per-frame coordinates
    acquisition: AcquisitionSettings  # detector / scan settings
    optics: MicroscopeConfig  # objective and illumination

    def __post_init__(self) -> None:
        self.resolution.validate(self.dimensions)
        self.measured.validate(self.dimensions)
