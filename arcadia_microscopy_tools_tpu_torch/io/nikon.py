"""Nikon ND2 ingest: pixel load + metadata interpretation.

Sits on top of the from-scratch binary reader in `io.nd2` (the reference
delegates to the `nd2` PyPI package, `src/arcadia_microscopy_tools/
nikon.py:25-479`; this module reproduces that layer's *interpretation* of
what the reader returns). The quirks the golden-metadata tests pin down:

- optical-config names resolve exact-first, then via Nikon aliases
  ("Mono" -> BRIGHTFIELD, "GFP" -> FITC), then by longest-substring match;
- unrecognized configs synthesize a Channel from the file's color and
  ex/em wavelengths, with a MetadataWarning;
- acquisition timestamps use NIS-Elements' "%m/%d/%Y %I:%M:%S %p" format;
- the lateral pixel pitch is the mean of the X and Y calibrations;
- measured Z comes from whichever hardware column actually varies (three
  candidate column names), centered on the Z-Series zero plane;
- measured time is re-zeroed to the first frame and reported in ms;
- exposure and binning are scraped from the "Sample N:" blocks of the
  capture description text.

Organized as pure functions over a small `_FileFacts` snapshot rather than a
stateful parser class; each function maps one metadata record.
"""

from __future__ import annotations

import re
import warnings
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Any

import numpy as np
import pandas as pd

from ..core.channels import BRIGHTFIELD, CHANNELS, FITC, Channel
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
from . import nd2

__all__ = ["load_nd2"]

_TIMESTAMP_FORMAT = "%m/%d/%Y %I:%M:%S %p"  # NIS-Elements date strings

# Nikon optical-config substrings that imply a predefined channel
_CONFIG_ALIASES: tuple[tuple[str, Channel], ...] = (
    ("MONO", BRIGHTFIELD),
    ("GFP", FITC),
)

# hardware Z columns, in preference order; whichever varies wins
_Z_COLUMN_CANDIDATES = (
    "Z Coord [µm]",
    "Ti2 ZDrive [µm]",
    "NIDAQ Piezo Z (name: Piezo Z) [µm]",
)

_SECONDS_PER_UNIT = {"min": 60.0, "s": 1.0, "ms": 1e-3, "us": 1e-6, "µs": 1e-6}


def load_nd2(
    nd2_path: Path,
    channels: list[Channel] | None = None,
) -> tuple[UInt16Array, InstrumentMetadata]:
    """Read an ND2 file's pixels and interpreted metadata in one pass.

    Args:
        nd2_path: The .nd2 file.
        channels: Explicit channel identities (one per file channel, in
            order) to use instead of name-based inference.

    Returns:
        (intensity array, InstrumentMetadata) - shapes follow the file's
        axis table, so `MicroscopyImage` accepts them directly.
    """
    with nd2.ND2File(nd2_path) as handle:
        pixels = handle.asarray()
        meta = _interpret(handle, nd2_path, channels)
    return pixels, meta


def _resolve_optical_config(optical_config: str) -> Channel | None:
    """Map a Nikon optical-configuration name onto a predefined Channel.

    Tries, in order: case-insensitive exact name; alias substrings
    (`_CONFIG_ALIASES`); the LONGEST predefined channel name occurring as a
    substring. None means nothing matched (caller synthesizes a channel).
    """
    name = optical_config.upper()
    if name in CHANNELS:
        return CHANNELS[name]
    for fragment, channel in _CONFIG_ALIASES:
        if fragment in name:
            return channel
    embedded = [known for known in CHANNELS if known in name]
    if embedded:
        return CHANNELS[max(embedded, key=len)]
    return None


@dataclass(frozen=True)
class _FileFacts:
    """Once-per-file snapshot shared by every per-channel parse step."""

    path: Path
    sizes: dict[str, int]
    text_info: dict[str, str]
    events: list[dict[str, Any]]
    dims: DimensionFlags
    stamp: datetime


def _interpret(
    handle: nd2.ND2File, path: Path, channels: list[Channel] | None
) -> InstrumentMetadata:
    """Interpret one opened file into an InstrumentMetadata tree."""
    facts = _FileFacts(
        path=path,
        sizes=dict(handle.sizes),
        text_info=dict(handle.text_info),
        events=handle.events(),
        dims=_axis_flags(dict(handle.sizes)),
        stamp=_acquisition_timestamp(dict(handle.text_info)),
    )

    contents = handle.metadata.contents
    if contents is None:
        raise ValueError(f"No metadata contents available in {path}")
    count = contents.channelCount
    if channels is not None and len(channels) != count:
        raise ValueError(
            f"Expected {count} channels but got {len(channels)} in channels list"
        )

    records = []
    for index in range(count):
        given = channels[index] if channels else None
        records.append(_channel_record(handle, facts, index, given))
    return InstrumentMetadata(facts.sizes, records)


def _channel_record(
    handle: nd2.ND2File, facts: _FileFacts, index: int, given: Channel | None
) -> ChannelMetadata:
    """Everything known about one channel, as a ChannelMetadata."""
    structs = handle.metadata.channels
    if structs is None:
        raise ValueError("No channel metadata available")
    struct = structs[index]

    identity = given
    if identity is None:
        identity = _resolve_optical_config(struct.channel.name)
    if identity is None:
        identity = _synthesize_channel(struct.channel)

    return ChannelMetadata(
        channel=identity,
        timestamp=facts.stamp,
        dimensions=facts.dims,
        resolution=_nominal_geometry(struct, facts),
        measured=_measured_coordinates(facts),
        acquisition=_capture_settings(struct, facts, index),
        optics=_optical_train(struct),
    )


def _synthesize_channel(meta: nd2.ChannelMeta) -> Channel:
    """Fallback Channel for an optical config no predefined name matches,
    built from the file's display color and recorded wavelengths."""
    if meta.color:
        rgb = meta.color
        hex_color = f"#{rgb.r:02X}{rgb.g:02X}{rgb.b:02X}"
    else:
        hex_color = "#FFFFFF"

    warnings.warn(
        f"Optical configuration '{meta.name}' did not match a predefined "
        "channel; synthesizing a channel from ND2 metadata. Pass a Channel instance "
        "to prevent this warning.",
        MetadataWarning,
        stacklevel=2,
    )
    return Channel(
        name=meta.name,
        color=hex_color,
        excitation_nm=meta.excitationLambdaNm or None,
        emission_nm=meta.emissionLambdaNm or None,
    )


def _axis_flags(sizes: dict[str, int]) -> DimensionFlags:
    """Flags from the file's axis table; an axis counts only when its extent
    exceeds one frame."""
    flag_by_axis = {
        "T": DimensionFlags.TIMELAPSE,
        "Z": DimensionFlags.Z_STACK,
        "S": DimensionFlags.RGB,
        "P": DimensionFlags.MONTAGE,
        "W": DimensionFlags.SPECTRAL,
    }
    flags = DimensionFlags(0)
    for axis, flag in flag_by_axis.items():
        if sizes.get(axis, 0) > 1:
            flags |= flag
    return flags


def _acquisition_timestamp(text_info: dict[str, str]) -> datetime:
    """The acquisition date from the file's free-text block."""
    if "date" not in text_info:
        raise ValueError("Missing 'date' field in text_info")
    return datetime.strptime(text_info["date"], _TIMESTAMP_FORMAT)


def _nominal_geometry(struct: nd2.ChannelStruct, facts: _FileFacts) -> NominalDimensions:
    """Nominal grid geometry from the channel's volume calibration."""
    nx, ny, nz = struct.volume.voxelCount
    sx, sy, sz = struct.volume.axesCalibration
    lateral = (sx + sy) / 2  # NIS calibrates X and Y separately; average

    frames = interval_ms = None
    if facts.events:
        frames = facts.sizes.get("T")
        interval_ms = facts.events[0].get("Exposure Time [ms]")

    w_count = w_step = None
    if facts.dims.is_spectral:
        w_count = facts.sizes.get("W")
        steps = [
            e["Wavelength [nm]"] for e in facts.events if "Wavelength [nm]" in e
        ]
        unique = sorted(set(steps))
        if len(unique) > 1:
            w_step = float(np.median(np.diff(unique)))

    zstack = facts.dims.is_zstack
    lapse = facts.dims.is_timelapse
    return NominalDimensions(
        x_size_px=nx,
        y_size_px=ny,
        xy_step_um=lateral,
        z_size_px=nz if zstack else None,
        z_step_um=sz if zstack else None,
        t_size_px=frames if lapse else None,
        t_step_ms=interval_ms if lapse else None,
        w_size_px=w_count,
        w_step_nm=w_step,
    )


def _measured_coordinates(facts: _FileFacts) -> MeasuredDimensions:
    """Recorded per-frame coordinates from the acquisition event log."""
    table = pd.DataFrame(facts.events)
    if len(table) < 2:
        return MeasuredDimensions()

    xs = ys = zs = ts = ws = None
    if facts.dims.is_montage:
        xs, ys = _stage_positions(table)
    if facts.dims.is_zstack:
        zs = _z_positions(table)
    if facts.dims.is_timelapse:
        ts = _frame_times(table)
    if facts.dims.is_spectral:
        ws = _spectral_wavelengths(table)
    return MeasuredDimensions(
        x_values_um=xs, y_values_um=ys, z_values_um=zs, t_values_ms=ts, w_values_nm=ws
    )


def _stage_positions(table: pd.DataFrame) -> tuple[Float64Array, Float64Array]:
    """Per-frame stage coordinates for tiled (montage) acquisitions,
    mean-centered so the montage midpoint is the origin — the same convention
    the Leica path uses for mosaic tiles. Goes beyond the reference, which
    raises NotImplementedError here (nikon.py:287-296); the columns come from
    the XYPosLoop's point table (io/nd2.py events synthesis) or from recorded
    stage-coordinate CustomData traces."""
    for x_col, y_col in (("X Coord [µm]", "Y Coord [µm]"), ("X Pos [µm]", "Y Pos [µm]")):
        if x_col in table.columns and y_col in table.columns:
            xs = table[x_col].to_numpy(dtype=float)
            ys = table[y_col].to_numpy(dtype=float)
            return xs - xs.mean(), ys - ys.mean()
    raise ValueError("No stage-coordinate columns found in events for tiled imaging")


def _z_positions(table: pd.DataFrame) -> Float64Array:
    """Focus positions per plane, centered so the Z-Series zero plane is 0.

    Different Nikon stands log Z under different column names; the one whose
    values actually vary across the stack is the drive that moved.
    """
    moving = next(
        (
            col
            for col in _Z_COLUMN_CANDIDATES
            if col in table.columns and table[col].nunique() > 1
        ),
        None,
    )
    if moving is None:
        raise ValueError("No varying Z coordinate column found in events")
    if "Z-Series" not in table.columns:
        raise ValueError("Missing 'Z-Series' column in events metadata")

    height = table[moving].to_numpy(dtype=float, copy=True)
    midplane = table.loc[table["Z-Series"].abs().idxmin(), moving]
    return height - midplane


def _frame_times(table: pd.DataFrame) -> Float64Array:
    """Per-frame wall-clock times in ms, zeroed at the first frame."""
    if "Time [s]" not in table.columns:
        raise ValueError("Missing 'Time [s]' column in events metadata")
    seconds = table["Time [s]"].to_numpy(dtype=float)
    return 1e3 * (seconds - seconds.min())


def _spectral_wavelengths(table: pd.DataFrame) -> Float64Array:
    """Per-frame sampling wavelengths (nm) for spectral acquisitions. Goes
    beyond the reference, which raises NotImplementedError here
    (nikon.py:338-345); the column is synthesized from the spectral loop's
    per-step wavelength table by the reader (io/nd2.py)."""
    if "Wavelength [nm]" not in table.columns:
        raise ValueError("No wavelength column found in events for spectral imaging")
    return table["Wavelength [nm]"].to_numpy(dtype=float)


def _capture_settings(
    struct: nd2.ChannelStruct, facts: _FileFacts, index: int
) -> AcquisitionSettings:
    """Detector settings scraped from this channel's 'Sample N:' text block."""
    block = _text_block(facts, "capturing", "Sample", index)
    return AcquisitionSettings(
        exposure_time_s=_exposure_seconds(block),
        zoom=struct.microscope.zoomMagnification,
        binning=_binning_label(block),
    )


def _optical_train(struct: nd2.ChannelStruct) -> MicroscopeConfig:
    """Objective identity from the channel's microscope record."""
    mag = struct.microscope.objectiveMagnification
    return MicroscopeConfig(
        magnification=int(mag) if mag is not None else 0,
        numerical_aperture=struct.microscope.objectiveNumericalAperture or 0.0,
        objective=struct.microscope.objectiveName,
    )


def _text_block(facts: _FileFacts, field: str, marker: str, index: int) -> str:
    """The per-channel section of a NIS free-text field.

    NIS concatenates per-channel settings as "Sample 1: ... Sample 2: ..."
    (or "Plane #1: ..." in the description field); this slices out channel
    `index`'s section, falling back to the whole field when unsectioned.
    """
    if field not in facts.text_info:
        raise ValueError(f"Missing '{field}' field in text_info")
    text = facts.text_info[field]
    tag = f"{marker} #{index + 1}:" if marker == "Plane" else f"{marker} {index + 1}:"
    pattern = re.escape(tag).replace(r"\ ", " ") + r"[\s\S]*?(?=" + marker + r" #?\d|$)"
    found = re.search(pattern, text)
    return found.group(0) if found else text


def _binning_label(block: str) -> str | None:
    """The camera binning setting (e.g. '2x2') if the block records one."""
    for line in block.splitlines():
        if "Binning" in line:
            return line.split(":")[1].strip()
    return None


def _exposure_seconds(block: str) -> float | None:
    """The exposure time in seconds, whatever unit the block used."""
    for line in block.splitlines():
        if "Exposure" not in line:
            continue
        found = re.search(r"Exposure: (\d+(?:\.\d+)?) (\w+)", line)
        if found:
            value, unit = found.groups()
            return _to_seconds(value, unit)
    return None


def _to_seconds(value: str | float, unit: str) -> float:
    """Convert a (value, unit) pair to seconds; hours spelled any way."""
    number = float(value)
    if "h" in unit:
        return 3600.0 * number
    if unit in _SECONDS_PER_UNIT:
        return number * _SECONDS_PER_UNIT[unit]
    raise ValueError(f"Unknown unit of time: {unit}")
