"""Leica LIF ingest: image listing, loading, CRS physics, metadata
interpretation.

The port's own copy of `arcadia_microscopy_tools_tpu/io/leica.py`: host
code with the same rules, warnings and errors, building the port's
`core.metadata_structures` records and `core.microscopy.InstrumentMetadata`.

Built on the from-scratch container reader in `io.lif` (the reference
delegates to the `liffile` PyPI package and re-models its internals with
pydantic, `src/arcadia_microscopy_tools/leica.py:39-898`; this module
reproduces that layer's behavior with plain functions over the reader's XML
tree). The interpretation rules the test suite pins down:

- coherent-Raman physics: Raman shift ``(1/lp - 1/ls) * 1e7`` cm^-1 and
  anti-Stokes wavelength ``1/(2/lp - 1/ls)``, Stokes line at 1031.7 nm;
- channel inference: a single active 405-diode or white-light laser infers
  the channel from its excitation wavelength (NIR values out of the lookup
  range warn and fall back to a dark-red placeholder); otherwise the
  detector name + beam route decide, with CRS modalities (SRS/CARS/SHG)
  getting their wavelengths computed from the pump line, and the
  Trans PMT 3 brightfield/F-SHG ambiguity warned about;
- axis flags include the lambda/Lambda spectral keys and the M mosaic key;
- timestamps fall back to an Apollo-11 placeholder (with a warning) when
  the file carries none;
- X/Y pixel pitches differing by >1% warn before averaging;
- montage tile positions are mean-centered, and Z-stack coordinates
  override tile Z when both axes exist;
- Lambda scans read per-step laser wavelengths when present, else
  reconstruct a linspace from the Navigator scan definition;
- total exposure = dwell time x pixels x every averaging/accumulation pass.
"""

from __future__ import annotations

import warnings
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from datetime import datetime
from enum import IntEnum
from pathlib import Path
from typing import Any

import numpy as np

from ..core.channels import BRIGHTFIELD, E_CARS, E_SHG, F_CARS, F_SHG, SRS, Channel
from ..core.metadata_structures import (
    AcquisitionSettings,
    ChannelMetadata,
    DimensionFlags,
    MeasuredDimensions,
    MicroscopeConfig,
    NominalDimensions,
)
from ..core.microscopy import InstrumentMetadata
from ..exceptions import MetadataWarning
from ..typing import Float64Array, UInt16Array
from . import lif

__all__ = [
    "CRS_STOKES_WAVELENGTH_NM",
    "calculate_antistokes_wavelength",
    "calculate_raman_shift",
    "list_image_names",
    "load_lif_image",
]

CRS_STOKES_WAVELENGTH_NM: float = 1031.7  # the CRS system's fixed Stokes line

# multipliers to meters / seconds, for converting the XML's unit strings
_TO_BASE = {"m": 1.0, "mm": 1e-3, "um": 1e-6, "nm": 1e-9, "s": 1.0, "ms": 1e-3, "us": 1e-6}

# LAS X dimension-id legend (DimID attribute -> axis)
_DIM_X, _DIM_Y, _DIM_Z, _DIM_T = 1, 2, 3, 4
_DIM_LAMBDA, _DIM_BIG_LAMBDA = 5, 9

# axis-size keys -> dimension flags (lambda and Lambda both mean spectral)
_FLAG_BY_SIZE_KEY = {
    "T": DimensionFlags.TIMELAPSE,
    "Z": DimensionFlags.Z_STACK,
    "S": DimensionFlags.RGB,
    "λ": DimensionFlags.SPECTRAL,
    "Λ": DimensionFlags.SPECTRAL,
    "M": DimensionFlags.MONTAGE,
}

# detectors fed by the UV diode / white-light laser (fluorescence imaging)
_FLUOR_DETECTORS = frozenset({"HyD S 1", "HyD S 2", "HyD X 3", "HyD R 4"})

# (detector, beam route) -> modality; None route = any route
_DETECTOR_TABLE: dict[tuple[str | None, str | None], Channel] = {
    ("F-SRS", None): SRS,  # route expected "10;0", not checked
    ("HyD NDD 1", "20;21"): E_CARS,
    ("HyD NDD 2", "20;2"): E_SHG,
    ("Trans PMT 2", None): F_CARS,  # route unknown
    ("Trans PMT 3", "10;2"): BRIGHTFIELD,  # shared with F-SHG, see warning
}

_AMBIGUOUS_DETECTORS: dict[tuple[str | None, str | None], str] = {
    ("Trans PMT 3", "10;2"): (
        "Detected BRIGHTFIELD via Trans PMT 3 / BeamRoute '10;2', but this detector and beam "
        "route are also used for F-SHG. If this is an F-SHG channel, pass the channels "
        "argument explicitly (e.g. channels=[..., F_SHG, ...])."
    ),
}

# modalities whose wavelengths derive from the CRS pump line
_CRS_MODALITIES = frozenset({SRS, E_CARS, F_CARS, E_SHG, F_SHG})


# -- public API --------------------------------------------------------------------


def list_image_names(lif_path: Path) -> list[str]:
    """The names of every image stored in a LIF container."""
    container = lif.open_cached(lif_path)
    return [image.name for image in container.images]


def load_lif_image(
    lif_path: Path,
    image_name: str,
    channels: list[Channel] | None = None,
) -> tuple[UInt16Array, InstrumentMetadata]:
    """Read one image's pixels and interpreted metadata from a LIF container.

    Args:
        lif_path: The .lif file.
        image_name: Which image to load (see `list_image_names`).
        channels: Explicit channel identities to use instead of the
            laser/detector inference.

    Returns:
        (intensity array, InstrumentMetadata).

    Raises:
        ValueError: When `image_name` is not in the container.
    """
    # one parsed container per path is shared across calls (and across the
    # plate prefetcher's worker threads): plate workflows store many wells in
    # one .lif, and re-parsing the XML header costs ~39 ms per well
    container = lif.open_cached(lif_path)
    names = [image.name for image in container.images]
    if image_name not in names:
        raise ValueError(
            f"Image {image_name} not found in {lif_path}. Available images: {names}"
        )
    image = container.images[image_name]
    pixels = image.asarray()
    meta = _interpret(image, lif_path, image_name, channels)
    return pixels, meta


def calculate_raman_shift(
    pump_wavelength_nm: float | Float64Array,
    stokes_wavelength_nm: float | Float64Array = CRS_STOKES_WAVELENGTH_NM,
) -> float | Float64Array:
    """Raman shift in wavenumbers (cm^-1): ``(1/lp - 1/ls) * 1e7``."""
    return (1 / pump_wavelength_nm - 1 / stokes_wavelength_nm) * 1e7


def calculate_antistokes_wavelength(
    pump_wavelength_nm: float | Float64Array,
    stokes_wavelength_nm: float | Float64Array = CRS_STOKES_WAVELENGTH_NM,
) -> float | Float64Array:
    """Anti-Stokes emission wavelength in nm: ``1/(2/lp - 1/ls)``."""
    return 1 / (2 / pump_wavelength_nm - 1 / stokes_wavelength_nm)


# -- unit / value helpers ------------------------------------------------------------


def _rescale(value: float, from_unit: str, to_unit: str) -> float:
    """Convert between the XML's SI length/time unit strings."""
    for unit in (from_unit, to_unit):
        if unit not in _TO_BASE:
            raise ValueError(f"Unknown unit {unit!r}")
    return value * _TO_BASE[from_unit] / _TO_BASE[to_unit]


def _wavelength_nm(raw: str | int | float) -> float:
    """A wavelength in nm; magnitudes below 1e-3 are taken as SI meters
    (LAS X records some lines in meters, some in nm) and scaled up."""
    try:
        value = float(raw)
    except (ValueError, TypeError) as ex:
        raise ValueError(f"Cannot determine wavelength from {raw}") from ex
    return value * 1e9 if value < 1e-3 else value


def _as_list(node: Any) -> list:
    """XML-to-dict conversion collapses single-element lists; undo that.

    An EMPTY dict means the element was absent (the `.get(..., {})` chains
    used by every caller), not a single empty record - returning [{}] here
    would send field-less records into the record parsers (KeyError on
    laser-less widefield images, a bogus (0,0,0) tile for a montage without
    TileScanInfo, a 0-nm lambda step)."""
    if isinstance(node, dict):
        return [node] if node else []
    return list(node) if node else []


# -- structures read from the ImageDescription XML -------------------------------------


@dataclass(frozen=True)
class _DimensionInfo:
    """One <DimensionDescription>: axis id, sample count, extent, unit."""

    dim_id: int
    count: int
    length: float
    unit: str

    @property
    def step(self) -> float:
        """Sampling interval along this axis, in `unit`."""
        return self.length / self.count

    @classmethod
    def from_xml(cls, node: ET.Element) -> "_DimensionInfo":
        return cls(
            dim_id=int(_required(node, "DimID")),
            count=int(_required(node, "NumberOfElements")),
            length=float(_required(node, "Length")),
            unit=_required(node, "Unit"),
        )


def _required(node: ET.Element, attribute: str) -> str:
    value = node.get(attribute)
    if value is None:
        raise ValueError(f"Missing attribute {attribute!r} on <{node.tag}>")
    return value


def _channel_properties(node: ET.Element) -> dict[str, str]:
    """The <ChannelProperty> key/value pairs of one <ChannelDescription>."""
    # the fixed attributes must be present for a conformant channel
    required_attrs = (
        "DataType", "ChannelTag", "Resolution", "LUTName", "BytesInc", "BitInc", "Min", "Max",
    )
    for attribute in required_attrs:
        _required(node, attribute)
    pairs: dict[str, str] = {}
    for prop in node.findall("ChannelProperty"):
        key = prop.find("Key")
        value = prop.find("Value")
        if key is not None and value is not None and key.text is not None:
            pairs[key.text] = value.text or ""
    return pairs


# -- laser system ------------------------------------------------------------------


class _LaserKind(IntEnum):
    """LightSourceType codes LAS X writes for the lasers we understand."""

    DIODE = 1
    WLL = 4
    CRS = 6


@dataclass(frozen=True)
class _Laser:
    """One laser's state: kind, name, line wavelength, and whether it's on."""

    kind: _LaserKind
    name: str
    wavelength: float
    powered: bool

    @classmethod
    def from_record(cls, record: dict[str, Any]) -> "_Laser":
        return cls(
            kind=_LaserKind(int(record["LightSourceType"])),
            name=str(record.get("LightSourceName", "")),
            wavelength=float(record.get("WavelengthDouble", 0.0)),
            powered=str(record["PowerState"]) == "On",
        )


def _powered_kinds(lasers: list[_Laser]) -> list[_LaserKind]:
    return [laser.kind for laser in lasers if laser.powered]


def _laser_of_kind(lasers: list[_Laser], kind: _LaserKind) -> _Laser:
    for laser in lasers:
        if laser.kind == kind:
            return laser
    raise ValueError(f"No laser of type {kind!r} in laser system")


# -- per-image interpretation ------------------------------------------------------------


@dataclass(frozen=True)
class _ImageFacts:
    """Once-per-image snapshot shared by all the interpretation steps."""

    path: Path
    name: str
    image: Any  # lif.LifImage
    sizes: dict[str, int]
    dims: DimensionFlags
    dimensions_by_id: dict[int, _DimensionInfo]
    channel_props: list[dict[str, str]]
    lasers: list[_Laser]
    stamp: datetime

    def axis(self, dim_id: int) -> _DimensionInfo:
        info = self.dimensions_by_id.get(dim_id)
        if info is None:
            raise ValueError(f"Missing dimension (dim_id={dim_id}) in LIF metadata")
        return info

    @property
    def confocal(self) -> dict[str, Any]:
        """The ATLConfocalSettingDefinition hardware block."""
        return self.image.attrs.get("HardwareSetting", {}).get(
            "ATLConfocalSettingDefinition", {}
        )


def _gather_facts(
    image: Any, path: Path, name: str, channels: list[Channel] | None
) -> _ImageFacts:
    if not hasattr(image, "attrs"):
        raise ValueError(f"Missing attrs metadata for image '{name}' in {path}")

    description = image.xml_element.find("./Data/Image/ImageDescription")
    if description is None:
        raise ValueError(
            f"Missing image description metadata for image '{name}' in {path}"
        )
    channel_root = description.find("Channels")
    dimension_root = description.find("Dimensions")
    if channel_root is None or dimension_root is None:
        raise ValueError("Expected <Channels> and <Dimensions> under <ImageDescription>")

    dims_by_id = {}
    for node in dimension_root.findall("DimensionDescription"):
        info = _DimensionInfo.from_xml(node)
        dims_by_id[info.dim_id] = info

    sizes = image.sizes
    flags = DimensionFlags(0)
    for key, flag in _FLAG_BY_SIZE_KEY.items():
        if sizes.get(key, 0) > 1:
            flags |= flag

    laser_records = _as_list(
        image.attrs.get("HardwareSetting", {})
        .get("ATLConfocalSettingDefinition", {})
        .get("LaserArray", {})
        .get("Laser", {})
    )

    return _ImageFacts(
        path=path,
        name=name,
        image=image,
        sizes=sizes,
        dims=flags,
        dimensions_by_id=dims_by_id,
        channel_props=[
            _channel_properties(node)
            for node in channel_root.findall("ChannelDescription")
        ],
        lasers=[_Laser.from_record(r) for r in laser_records],
        stamp=_timestamp(image, path, name),
    )


def _timestamp(image: Any, path: Path, name: str) -> datetime:
    """First frame timestamp; a corrupt/absent list warns and yields the
    Apollo-11 landing as an unmistakable placeholder."""
    try:
        return image.timestamps[0]
    except IndexError:
        warnings.warn(
            f"Could not parse timestamp for image '{name}' in {path}. "
            "Defaulting to a placeholder timestamp. Image metadata may be corrupted.",
            MetadataWarning,
            stacklevel=2,
        )
        return datetime(1969, 7, 20, 20, 17)


def _interpret(
    image: Any, path: Path, name: str, channels: list[Channel] | None
) -> InstrumentMetadata:
    facts = _gather_facts(image, path, name, channels)

    count = len(facts.channel_props)
    if channels is not None and len(channels) != count:
        raise ValueError(
            f"Expected {count} channels but got {len(channels)} in channels list"
        )

    # the geometry/settings records are shared by all channels of one image
    geometry = _nominal_geometry(facts)
    coordinates = _measured_coordinates(facts)
    capture = _capture_settings(facts)
    optics = _optical_train(facts)

    records = []
    for index, props in enumerate(facts.channel_props):
        identity = channels[index] if channels else _infer_channel(facts, props)
        records.append(
            ChannelMetadata(
                channel=identity,
                timestamp=facts.stamp,
                dimensions=facts.dims,
                resolution=geometry,
                measured=coordinates,
                acquisition=capture,
                optics=optics,
            )
        )
    return InstrumentMetadata(facts.sizes, records)


# -- channel inference ------------------------------------------------------------------


def _infer_channel(facts: _ImageFacts, props: dict[str, str]) -> Channel:
    """Work out a channel identity from the laser system + detector routing.

    One active diode/WLL laser is unambiguous: the excitation wavelength
    names the channel. Anything else (CRS on, several lasers) goes through
    the detector table. The reference documents the same heuristics and
    their limits (leica.py:488-512).
    """
    powered = _powered_kinds(facts.lasers)
    if not powered:
        raise ValueError(f"No active laser for '{facts.name}' in {facts.path}")

    if len(powered) == 1 and powered[0] in (_LaserKind.DIODE, _LaserKind.WLL):
        only = _laser_of_kind(facts.lasers, powered[0])
        return _channel_from_laser(only)

    return _channel_from_detector(facts, props, powered)


def _channel_from_laser(laser: _Laser) -> Channel:
    """Channel named by the laser's excitation wavelength."""
    if laser.kind == _LaserKind.CRS:
        raise ValueError("Cannot infer channel from CRS laser")

    excitation = _wavelength_nm(laser.wavelength)
    try:
        return Channel.from_wavelength(excitation, name=laser.kind.name)
    except ValueError:
        warnings.warn(
            f"Parsed excitation wavelength {excitation} nm outside accepted "
            "range for Channel inference. Pass a Channel instance to prevent this warning.",
            MetadataWarning,
            stacklevel=2,
        )
        # NIR lines (700-1400 nm) have no visible color; use a dark red
        return Channel(name=laser.kind.name, color="#8B0000")


def _channel_from_detector(
    facts: _ImageFacts, props: dict[str, str], powered: list[_LaserKind]
) -> Channel:
    """Channel decided by which detector saw the light, and over which route."""
    detector = props.get("DetectorName")
    route = props.get("BeamRoute")

    if detector in _FLUOR_DETECTORS:
        # fluorescence detector: attribute it to the WLL if that is on,
        # else the diode (crude, as in the reference)
        kind = _LaserKind.WLL if _LaserKind.WLL in powered else _LaserKind.DIODE
        return _channel_from_laser(_laser_of_kind(facts.lasers, kind))

    modality = _DETECTOR_TABLE.get((detector, route)) or _DETECTOR_TABLE.get(
        (detector, None)
    )
    if modality is None:
        raise ValueError(
            f"Could not determine channel from DetectorName: {detector}, "
            f"BeamRoute: {route}. Please provide channels list explicitly."
        )

    caveat = _AMBIGUOUS_DETECTORS.get((detector, route)) or _AMBIGUOUS_DETECTORS.get(
        (detector, None)
    )
    if caveat:
        warnings.warn(caveat, MetadataWarning, stacklevel=2)

    if modality in _CRS_MODALITIES:
        return _crs_channel(facts, modality)
    return modality


def _crs_channel(facts: _ImageFacts, modality: Channel) -> Channel:
    """SRS/CARS/SHG channels with wavelengths computed from the pump line."""
    pump = _wavelength_nm(_laser_of_kind(facts.lasers, _LaserKind.CRS).wavelength)

    if modality in (E_CARS, F_CARS):
        # CARS emits at the anti-Stokes wavelength
        emission = float(calculate_antistokes_wavelength(pump, CRS_STOKES_WAVELENGTH_NM))
    elif modality in (E_SHG, F_SHG):
        # second harmonic: exactly half the excitation wavelength
        emission = pump / 2
    else:
        # SRS is a loss measurement at the excitation wavelength itself
        emission = pump

    return Channel(
        name=modality.name,
        excitation_nm=round(pump, 1),
        emission_nm=round(emission, 1),
        color=modality.color,
    )


# -- geometry / coordinates ------------------------------------------------------------


def _nominal_geometry(facts: _ImageFacts) -> NominalDimensions:
    """Grid geometry from the DimensionDescription records."""
    x = facts.axis(_DIM_X)
    y = facts.axis(_DIM_Y)
    x_step = _rescale(x.step, x.unit, "um")
    y_step = _rescale(y.step, y.unit, "um")
    if abs(x_step - y_step) / x_step > 0.01:
        warnings.warn(
            f"X ({x_step:.4f} µm) and Y ({y_step:.4f} µm) pixel steps differ by more "
            "than 1%; using average for xy_step_um.",
            MetadataWarning,
            stacklevel=2,
        )

    z_count = z_step = None
    if facts.dims.is_zstack:
        z = facts.axis(_DIM_Z)
        z_count, z_step = z.count, _rescale(z.step, z.unit, "um")

    t_count = t_step = None
    if facts.dims.is_timelapse:
        t = facts.axis(_DIM_T)
        t_count, t_step = t.count, _rescale(t.step, t.unit, "ms")

    w_count = w_step = None
    if facts.dims.is_spectral:
        # prefer the Navigator Lambda axis (id 9) over the detector lambda (5)
        for dim_id, size_key in ((_DIM_BIG_LAMBDA, "Λ"), (_DIM_LAMBDA, "λ")):
            if facts.sizes.get(size_key, 0) > 1:
                w = facts.axis(dim_id)
                w_count, w_step = w.count, _rescale(w.step, w.unit, "nm")
                break

    return NominalDimensions(
        x_size_px=x.count,
        y_size_px=y.count,
        xy_step_um=(x_step + y_step) / 2,
        z_size_px=z_count,
        z_step_um=z_step,
        t_size_px=t_count,
        t_step_ms=t_step,
        w_size_px=w_count,
        w_step_nm=w_step,
    )


def _measured_coordinates(facts: _ImageFacts) -> MeasuredDimensions:
    """Recorded coordinates per axis, with the acquisition-type-dependent
    Lambda paths and the Z-priority rule (reference leica.py:725-824)."""
    xs = ys = zs = ts = ws = None

    if facts.dims.is_montage:
        tiles = _as_list(facts.image.attrs.get("TileScanInfo", {}).get("Tile", {}))
        meters_to_um = _rescale(1, "m", "um")
        xs = meters_to_um * np.array([float(t.get("PosX", 0.0)) for t in tiles])
        ys = meters_to_um * np.array([float(t.get("PosY", 0.0)) for t in tiles])
        zs = meters_to_um * np.array([float(t.get("PosZ", 0.0)) for t in tiles])
        # stage positions are absolute; report them relative to the mosaic center
        xs = xs - xs.mean()
        ys = ys - ys.mean()
        zs = zs - zs.mean()

    if facts.dims.is_zstack:
        # the stack's own focus coordinates beat the per-tile Z positions
        z = facts.axis(_DIM_Z)
        zs = _rescale(1, z.unit, "um") * facts.image.coords["Z"]

    if facts.dims.is_timelapse:
        t = facts.axis(_DIM_T)
        ts = _rescale(1, t.unit, "ms") * facts.image.coords["T"]

    if facts.dims.is_spectral:
        ws = _lambda_wavelengths(facts)

    return MeasuredDimensions(
        x_values_um=xs, y_values_um=ys, z_values_um=zs, t_values_ms=ts, w_values_nm=ws
    )


def _lambda_wavelengths(facts: _ImageFacts) -> Float64Array:
    """Per-step excitation wavelengths of a Lambda scan.

    Ordinary scans store per-step laser values; Navigator-driven scans (and
    'merged' mosaics) only store the scan definition, from which the steps
    are reconstructed as a linspace.
    """
    if not facts.dims.is_montage and "merged" not in facts.name.lower():
        steps = _as_list(
            facts.image.attrs.get("LaserValues", {})
            .get("Laser", {})
            .get("StagePosition", {})
            .get("LaserValues", {})
        )
        return np.array([float(s.get("Wavelength", 0.0)) for s in steps])

    definition = (
        facts.image.attrs.get("HardwareSetting", {})
        .get("ATLConfocalSettingDefinition", {})
        .get("LambdaDefinition", {})
        .get("LambdaExcitation", {})
    )
    begin = float(definition.get("LambdaExcitationBeginDouble", np.nan))
    end = float(definition.get("LambdaExcitationEndDouble", np.nan))
    steps = int(definition.get("LambdaExcitationStepCount", 0))
    return np.linspace(begin, end, steps)


# -- settings ------------------------------------------------------------------------


def _capture_settings(facts: _ImageFacts) -> AcquisitionSettings:
    """Scanner settings; exposure totals every pass over every pixel."""
    block = facts.confocal

    dwell_s = float(block.get("PixelDwellTime", np.nan))
    line_avg = int(block.get("LineAverage", 1))
    line_acc = int(block.get("Line_Accumulation", 1))
    frame_avg = int(block.get("FrameAverage", 1))
    frame_acc = int(block.get("FrameAccumulation", 1))

    total_exposure_s = (
        dwell_s
        * facts.sizes["X"]
        * facts.sizes["Y"]
        * line_avg
        * line_acc
        * frame_avg
        * frame_acc
    )

    return AcquisitionSettings(
        exposure_time_s=total_exposure_s,
        zoom=float(block.get("Zoom", np.nan)),
        binning=None,
        pixel_dwell_time_us=1e6 * dwell_s,
        line_scan_speed_hz=float(block.get("ScanSpeed", np.nan)),
        line_averaging=line_avg,
        line_accumulation=line_acc,
        frame_averaging=frame_avg,
        frame_accumulation=frame_acc,
    )


def _optical_train(facts: _ImageFacts) -> MicroscopeConfig:
    """Objective identity from the confocal hardware block."""
    block = facts.confocal
    return MicroscopeConfig(
        magnification=int(block.get("Magnification", 0)),
        numerical_aperture=float(block.get("NumericalAperture", np.nan)),
        objective=block.get("ObjectiveName", "").strip(),
    )
