"""Synthesize spec-conformant Nikon ND2 v3 containers (the benchmark's
frozen copy of the repository's test writer, so that a change to the
program's tests cannot change the files the ND2 cells decode).

Encodes the Lim-variant metadata chunks, frame chunks, and the trailing
chunk map. Only the features a reader consumes are emitted: image
attributes, text info, per-channel picture metadata (names, colors,
calibration, objective), an optional time loop with acquisition-time
events, and raw uint16 frames.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_CHUNK_MAGIC = 0x0ABECEDA
_CHUNKMAP_SIGNATURE = b"ND2 CHUNK MAP SIGNATURE 0000001!"


# -- Lim variant encoding -------------------------------------------------------


def _entry(dtype: int, name: str, payload: bytes) -> bytes:
    name_utf16 = (name + "\x00").encode("utf-16-le")
    return bytes([dtype, len(name_utf16) // 2]) + name_utf16 + payload


def encode_value(name: str, value) -> bytes:
    """One Lim-variant entry for a Python value (dict = compound)."""
    if isinstance(value, bool):
        return _entry(1, name, bytes([1 if value else 0]))
    if isinstance(value, int):
        if 0 <= value < 2**31:
            return _entry(3, name, struct.pack("<I", value))
        return _entry(4, name, struct.pack("<q", value))
    if isinstance(value, float):
        return _entry(6, name, struct.pack("<d", value))
    if isinstance(value, str):
        return _entry(8, name, (value + "\x00").encode("utf-16-le"))
    if isinstance(value, bytes):
        return _entry(9, name, struct.pack("<Q", len(value)) + value)
    if isinstance(value, dict):
        children = b"".join(encode_value(k, v) for k, v in value.items())
        count = len(value)
        header = bytes([11, len(name) + 1]) + (name + "\x00").encode("utf-16-le")
        size = len(header) + 12 + len(children)
        body = struct.pack("<IQ", count, size) + children
        offsets = struct.pack(f"<{count}Q", *([0] * count)) if count else b""
        return header + body + offsets
    raise TypeError(f"Cannot encode {type(value)} for {name!r}")


def encode_variant(root: dict) -> bytes:
    return b"".join(encode_value(k, v) for k, v in root.items())


# -- container assembly ------------------------------------------------------------


class ND2Builder:
    """Accumulate chunks, then write a valid container with a chunk map."""

    def __init__(self) -> None:
        self._chunks: list[tuple[str, bytes]] = []

    def add(self, name: str, data: bytes) -> None:
        self._chunks.append((name, data))

    def add_variant(self, name: str, root: dict) -> None:
        self.add(name, encode_variant(root))

    def write(self, path: Path) -> None:
        blob = bytearray()
        offsets: dict[str, int] = {}
        for name, data in self._chunks:
            offsets[name] = len(blob)
            encoded_name = name.encode("ascii")
            blob += struct.pack("<IIQ", _CHUNK_MAGIC, len(encoded_name), len(data))
            blob += encoded_name + data

        # chunk map: name! pos u64 len u64 records, terminated by the signature
        records = b""
        for name, data in self._chunks:
            records += name.encode("ascii") + struct.pack(
                "<QQ", offsets[name], len(data)
            )
        records += _CHUNKMAP_SIGNATURE + struct.pack("<QQ", 0, 0)

        map_pos = len(blob)
        map_name = _CHUNKMAP_SIGNATURE
        blob += struct.pack("<IIQ", _CHUNK_MAGIC, len(map_name), len(records))
        blob += map_name + records

        # 40-byte tail: signature + chunk-map offset
        blob += _CHUNKMAP_SIGNATURE + struct.pack("<Q", map_pos)
        Path(path).write_bytes(bytes(blob))


def _plane(description: str, color: int, ex_nm: float, em_nm: float) -> dict:
    spectrum = lambda wl: {"pPoint": {"Point0": {"dWavelength": wl}}}  # noqa: E731
    return {
        "sDescription": description,
        "uiColor": color,
        "pFluorescentProbe": {
            "m_ExcitationSpectrum": spectrum(ex_nm),
            "m_EmissionSpectrum": spectrum(em_nm),
        },
    }


def write_nd2(
    path: Path,
    frames: np.ndarray,  # (loops..., C, Y, X) or (C, Y, X) or (T, Y, X) uint16
    channel_names: list[str] | None = None,
    calibration_um: float = 0.325,
    date: str = "1/15/2024 10:30:00 AM",
    time_loop: bool = False,
    t_interval_ms: float = 500.0,
    magnification: float = 20.0,
    numerical_aperture: float = 0.75,
    objective: str = "Plan Apo 20x",
    exposure_line: str = "  Exposure: 100 ms",
    xy_positions: list[tuple[float, float]] | None = None,
    wavelengths_nm: list[float] | None = None,
    rgb_samples: int = 1,
) -> Path:
    """Write one ND2 file around a uint16 frame array.

    Shapes: (C, Y, X) = one multichannel frame; with `time_loop`,
    (T, C, Y, X) or (T, Y, X) = a timelapse (acquisition-time events are
    emitted so the parser's timelapse path engages). `xy_positions` adds an
    XYPos (montage) loop outermost, `wavelengths_nm` a spectral loop
    innermost; the leading frame axes must then match (P, T, W) in order.
    `rgb_samples > 1` writes an RGB-camera layout: each channel carries that
    many interleaved samples, so the trailing frame axes become
    (C, S, Y, X) — pass frames shaped accordingly.
    """
    frames = np.asarray(frames, dtype=np.uint16)
    if frames.ndim == 2:
        frames = frames[None]
    if time_loop and frames.ndim == 3 and not xy_positions and not wavelengths_nm:
        frames = frames[:, None]  # (T, 1, Y, X)

    # loop axes, outer -> inner: P (montage), T (time), W (spectral)
    loop_counts = []
    if xy_positions:
        loop_counts.append(len(xy_positions))
    if time_loop:
        loop_counts.append(frames.shape[len(loop_counts)])
    if wavelengths_nm:
        loop_counts.append(len(wavelengths_nm))
    n_loops = len(loop_counts)

    expected_ndim = n_loops + 3 + (1 if rgb_samples > 1 else 0)
    if frames.ndim != expected_ndim:
        raise ValueError(
            f"expected {expected_ndim}D frames for {n_loops} loop(s)"
            f"{' + RGB samples' if rgb_samples > 1 else ''}, got {frames.ndim}D"
        )
    if list(frames.shape[:n_loops]) != loop_counts:
        raise ValueError(
            f"leading frame axes {frames.shape[:n_loops]} do not match "
            f"loop counts {tuple(loop_counts)}"
        )

    if rgb_samples > 1:
        n_channels, samples, height, width = frames.shape[n_loops:]
        if samples != rgb_samples:
            raise ValueError("frames sample axis must equal rgb_samples")
        # fold samples into the component axis: components on disk are
        # channel-major interleaved triplets
        frames = frames.reshape(frames.shape[:n_loops] + (n_channels * samples, height, width))
    else:
        n_channels, height, width = frames.shape[n_loops:]

    t_count = int(np.prod(loop_counts)) if loop_counts else 1
    per_frame = frames.reshape((t_count,) + frames.shape[n_loops:])

    names = channel_names or [f"Channel {i}" for i in range(n_channels)]
    colors = [0xFF0000, 0x00FF00, 0x0000FF, 0x00FFFF, 0xFF00FF, 0xFFFF00]
    wavelengths = [(405.0, 450.0), (488.0, 520.0), (561.0, 590.0), (640.0, 670.0)]

    builder = ND2Builder()
    builder.add_variant(
        "ImageAttributesLV!",
        {
            "SLxImageAttributes": {
                "uiWidth": width,
                "uiHeight": height,
                "uiComp": n_channels * rgb_samples,
                "uiBpcInMemory": 16,
                "uiBpcSignificant": 16,
                "uiWidthBytes": width * n_channels * rgb_samples * 2,
                "uiSequenceCount": t_count,
            }
        },
    )

    text_items = {
        "TextInfoItem_5": "Synthetic plate well",
        "TextInfoItem_6": "\n".join(
            f"Sample {i + 1}:\n{exposure_line}\n  Binning: 1x1" for i in range(n_channels)
        ),
        "TextInfoItem_9": date,
    }
    builder.add_variant("ImageTextInfoLV!", {"SLxImageTextInfo": text_items})

    loop_specs = []  # (eType, uLoopPars), outer -> inner
    if xy_positions:
        points = {
            f"p{i}": {"dPosX": float(x), "dPosY": float(y), "dPosZ": 0.0}
            for i, (x, y) in enumerate(xy_positions)
        }
        loop_specs.append((2, {"uiCount": len(xy_positions), "Points": points}))
    if time_loop:
        t_loop_count = loop_counts[1] if xy_positions else loop_counts[0]
        loop_specs.append((1, {"uiCount": t_loop_count, "dPeriod": t_interval_ms}))
    if wavelengths_nm:
        points = {
            f"p{i}": {"dWavelength": float(w)} for i, w in enumerate(wavelengths_nm)
        }
        loop_specs.append((6, {"uiCount": len(wavelengths_nm), "Points": points}))

    if loop_specs:
        experiment: dict = {}
        node = experiment
        for level, (etype, pars) in enumerate(loop_specs):
            node["eType"] = etype
            node["uLoopPars"] = pars
            if level + 1 < len(loop_specs):
                child: dict = {}
                node["ppNextLevelEx"] = {"i0000000000": child}
                node = child
        builder.add_variant("ImageMetadataLV!", {"SLxExperiment": experiment})

    planes = {
        f"a{i}": _plane(
            names[i],
            colors[i % len(colors)],
            *wavelengths[i % len(wavelengths)],
        )
        for i in range(n_channels)
    }
    samples = {
        f"a{i}": {
            "pObjectiveSetting": {
                "dObjectiveMag": magnification,
                "dObjectiveNA": numerical_aperture,
                "wsObjectiveName": objective,
            }
        }
        for i in range(n_channels)
    }
    builder.add_variant(
        "ImageMetadataSeqLV|0!",
        {
            "SLxPictureMetadata": {
                "dCalibration": calibration_um,
                "dAspect": 1.0,
                "dZoom": 1.0,
                "wsObjectiveName": objective,
                "dObjectiveMag": magnification,
                "dObjectiveNA": numerical_aperture,
                "sPicturePlanes": {
                    "uiCount": n_channels,
                    "sPlaneNew": planes,
                    "sSampleSetting": samples,
                },
            }
        },
    )

    if time_loop:
        times_ms = (np.arange(t_count, dtype="<f8") * t_interval_ms)
        builder.add("CustomData|AcqTimesCache!", times_ms.tobytes())
        builder.add_variant(
            "CustomDataVar|CustomDataV2_0!",
            {
                "CustomTagDescription_v1.0": {
                    "Tag0": {
                        "ID": "ExposureTime",
                        "Type": 3,
                        "Size": t_count,
                        "Desc": "Exposure Time",
                        "Unit": "ms",
                    }
                }
            },
        )
        builder.add(
            "CustomData|ExposureTime!",
            (np.full(t_count, 100.0, dtype="<f8")).tobytes(),
        )

    for t in range(t_count):
        interleaved = np.ascontiguousarray(
            np.moveaxis(per_frame[t], 0, -1)
        )  # (Y, X, C)
        payload = struct.pack("<d", t * t_interval_ms) + interleaved.tobytes()
        builder.add(f"ImageDataSeq|{t}!", payload)

    builder.write(path)
    return path
