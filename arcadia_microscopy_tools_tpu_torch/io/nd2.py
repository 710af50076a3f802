"""From-scratch Nikon ND2 (v3 "Lim") file reader.

The environment has no `nd2` package, so this is a clean-room reader of the
modern ND2 container, reverse-engineered from the on-disk layout of the golden
test files (the same files the reference's tier-1 golden tests use). It
implements exactly the surface the metadata parser needs (the reference
consumes the `nd2` package at `src/arcadia_microscopy_tools/nikon.py:40-43,
107-109`): pixel data, sizes, structured per-channel metadata, text_info, and
per-frame acquisition events.

Container layout (little-endian):
- Every chunk: 16-byte header ``magic=0x0ABECEDA (u32), name_len (u32),
  data_len (u64)`` + padded name (terminated by ``!``) + data.
- The final 40 bytes name the chunk map ("ND2 CHUNK MAP SIGNATURE 0000001!")
  and give its offset; the map is a sequence of ``name! offset u64 length
  u64`` records.
- Metadata chunks ("...LV") hold a tagged binary format ("Lim variant"):
  each entry is ``type u8, name_chars u8, UTF-16LE name, value``, with type
  codes 1=bool, 2=i32, 3=u32, 4=i64, 5=u64, 6=f64, 8=UTF-16 string,
  9=bytes (u64 length prefix), 11=compound (child_count u32 + byte_size u64,
  children, then child_count trailing u64 offsets).
- ``ImageDataSeq|N`` chunks hold an f64 timestamp followed by raw uint16
  scanlines with components interleaved, row stride = uiWidthBytes.
- Per-frame event traces live in ``CustomData|<ID>`` chunks (f8 or i4
  buffers) described by the ``CustomDataVar|CustomDataV2_0`` XML descriptor
  (ID, Type, Size, Desc, Unit).
"""

from __future__ import annotations

import mmap

import struct
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np

# multi-component frames planarized by each route, for callers that report
# which one ran (the C++ kernel of `_native`, or the numpy transpose)
planarize_counts = {"native": 0, "numpy": 0}

_CHUNK_MAGIC = 0x0ABECEDA
_CHUNKMAP_SIGNATURE = b"ND2 CHUNK MAP SIGNATURE 0000001!"

# SLxImageTextInfo stores its fields as TextInfoItem_<i>; this is the field
# order of the Nikon SDK struct (matching the `nd2` package's text_info keys).
_TEXTINFO_FIELDS = [
    "imageId",
    "type",
    "group",
    "sampleName",
    "author",
    "description",
    "capturing",
    "sampling",
    "location",
    "date",
    "conclusion",
    "info1",
    "info2",
    "optics",
]

# Experiment loop type codes (SLxExperiment.eType)
_LOOP_TIME = 1
_LOOP_XYPOS = 2
_LOOP_ZSTACK = 4
_LOOP_SPECTRAL = 6
_LOOP_NETIME = 8


class ND2ParseError(ValueError):
    """Raised when an ND2 file cannot be parsed."""


# -- Lim variant decoding --------------------------------------------------------


def _decode_variant_entry(buf: bytes, pos: int, end: int) -> tuple[tuple[str, Any], int]:
    start = pos
    dtype = buf[pos]
    name_chars = buf[pos + 1]
    pos += 2
    name = buf[pos : pos + 2 * name_chars].decode("utf-16-le", errors="replace").rstrip("\x00")
    pos += 2 * name_chars
    if dtype == 1:
        return (name, bool(buf[pos])), pos + 1
    if dtype == 2:
        return (name, struct.unpack_from("<i", buf, pos)[0]), pos + 4
    if dtype == 3:
        return (name, struct.unpack_from("<I", buf, pos)[0]), pos + 4
    if dtype == 4:
        return (name, struct.unpack_from("<q", buf, pos)[0]), pos + 8
    if dtype == 5:
        return (name, struct.unpack_from("<Q", buf, pos)[0]), pos + 8
    if dtype == 6:
        return (name, struct.unpack_from("<d", buf, pos)[0]), pos + 8
    if dtype == 8:
        s = pos
        while s < end and buf[s : s + 2] != b"\x00\x00":
            s += 2
        return (name, buf[pos:s].decode("utf-16-le", errors="replace")), s + 2
    if dtype == 9:
        ln = struct.unpack_from("<Q", buf, pos)[0]
        pos += 8
        return (name, bytes(buf[pos : pos + ln])), pos + ln
    if dtype == 11:
        count, size = struct.unpack_from("<IQ", buf, pos)
        pos += 12
        value: dict[str, Any] = {}
        child_pos = pos
        for _ in range(count):
            try:
                (key, sub), child_pos = _decode_variant_entry(buf, child_pos, end)
            except (IndexError, struct.error):
                break
            if key in value:
                i = 1
                while f"{key}_{i}" in value:
                    i += 1
                key = f"{key}_{i}"
            value[key] = sub
        # children are followed by `count` u64 child offsets; `size` counts
        # from the entry start to the end of the children.
        return (name, value), start + size + count * 8
    raise ND2ParseError(f"Unknown Lim-variant type code {dtype} for entry {name!r}")


def decode_variant(buf: bytes) -> dict[str, Any]:
    """Decode a Lim-variant metadata chunk to a nested dict.

    The root is usually a single compound entry (e.g. "SLxImageAttributes");
    its children are returned directly. XML-flavored chunks (starting with
    ``<?xml``) are decoded to a nested dict as well.
    """
    if buf[:5] == b"<?xml":
        return _xml_to_dict(ET.fromstring(buf.decode("utf-8", errors="replace")))
    (name, value), _ = _decode_variant_entry(buf, 0, len(buf))
    if isinstance(value, dict):
        return {name: value} if name else value
    return {name: value}


def _xml_to_dict(elem: ET.Element) -> dict[str, Any]:
    """Decode Nikon's CLxVariant XML flavor (runtype-annotated elements)."""
    runtype = elem.get("runtype", "")
    if runtype in ("lx_int32", "lx_int64"):
        return int(elem.get("value", "0"))  # type: ignore[return-value]
    if runtype in ("double", "lx_double"):
        return float(elem.get("value", "nan"))  # type: ignore[return-value]
    if runtype == "bool":
        return elem.get("value", "false").lower() == "true"  # type: ignore[return-value]
    if runtype == "CLxStringW":
        return elem.get("value", "")  # type: ignore[return-value]
    out: dict[str, Any] = {}
    for child in elem:
        out[child.tag] = _xml_to_dict(child)
    if not out and elem.get("value") is not None:
        return elem.get("value")  # type: ignore[return-value]
    return out


# -- Structured metadata surface (mirrors the nd2 package's dataclasses) ---------


@dataclass(frozen=True)
class Color:
    r: int
    g: int
    b: int

    @classmethod
    def from_uicolor(cls, value: int) -> "Color":
        return cls(r=value & 0xFF, g=(value >> 8) & 0xFF, b=(value >> 16) & 0xFF)


@dataclass(frozen=True)
class ChannelMeta:
    name: str
    color: Color | None
    excitationLambdaNm: float | None = None
    emissionLambdaNm: float | None = None


@dataclass(frozen=True)
class VolumeInfo:
    voxelCount: tuple[int, int, int]
    axesCalibration: tuple[float, float, float]


@dataclass(frozen=True)
class MicroscopeInfo:
    zoomMagnification: float | None
    objectiveMagnification: float | None
    objectiveNumericalAperture: float | None
    objectiveName: str | None


@dataclass(frozen=True)
class ChannelStruct:
    channel: ChannelMeta
    volume: VolumeInfo
    microscope: MicroscopeInfo


@dataclass(frozen=True)
class Contents:
    channelCount: int
    frameCount: int


@dataclass(frozen=True)
class Metadata:
    contents: Contents | None
    channels: list[ChannelStruct] | None


@dataclass
class LoopInfo:
    kind: str  # 'T', 'P', 'Z'
    count: int
    parameters: dict[str, Any] = field(default_factory=dict)


class ND2File:
    """Minimal ND2 reader with the `nd2.ND2File`-compatible surface used by
    the Nikon metadata parser: sizes, asarray(), metadata, text_info, events().
    """

    def __init__(self, path: str | Path):
        self._path = Path(path)
        self._fh = open(self._path, "rb")
        try:
            self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        except Exception:
            self._fh.close()
            raise
        try:
            header = bytes(self._mm[:16])
            if len(header) < 16 or struct.unpack("<I", header[:4])[0] != _CHUNK_MAGIC:
                raise ND2ParseError(f"{self._path} is not an ND2 v3 file")
            self._chunks = self._read_chunkmap()
            self._attributes = self._decoded("ImageAttributesLV!")["SLxImageAttributes"]
            self._experiment = (
                self._decoded("ImageMetadataLV!").get("SLxExperiment")
                if "ImageMetadataLV!" in self._chunks
                else None
            )
            self._picture_metadata = (
                self._decoded("ImageMetadataSeqLV|0!").get("SLxPictureMetadata", {})
                if "ImageMetadataSeqLV|0!" in self._chunks
                else {}
            )
            self._loops = self._parse_loops()
            self._events_cache: list[dict[str, Any]] | None = None
            self._text_info_cache: dict[str, str] | None = None
            self._metadata_cache: Metadata | None = None
        except Exception:
            # a corrupt file must not leak the handle/mapping: the caller
            # never gets an object to close()
            self.close()
            raise

    # -- container plumbing ------------------------------------------------------

    def _read_chunkmap(self) -> dict[str, tuple[int, int]]:
        mm = self._mm
        tail = bytes(mm[-40:])
        if _CHUNKMAP_SIGNATURE not in tail:
            raise ND2ParseError("Missing ND2 chunk map signature")
        cm_pos = struct.unpack("<Q", tail[-8:])[0]
        payload = self._chunk_data_at(cm_pos)
        chunks: dict[str, tuple[int, int]] = {}
        i = 0
        while i < len(payload):
            j = payload.index(b"!", i)
            name = payload[i : j + 1]
            if name == _CHUNKMAP_SIGNATURE:
                break
            pos, ln = struct.unpack_from("<QQ", payload, j + 1)
            chunks[name.decode("ascii", errors="replace")] = (pos, ln)
            i = j + 17
        return chunks

    def _chunk_data_at(self, pos: int) -> bytes:
        magic, name_len, data_len = struct.unpack_from("<IIQ", self._mm, pos)
        if magic != _CHUNK_MAGIC:
            raise ND2ParseError(f"Bad chunk magic at offset {pos}")
        start = pos + 16 + name_len
        if start + data_len > len(self._mm):
            # mmap slicing would silently shorten the chunk; fail loudly so a
            # truncated container cannot decode into garbage frames
            raise ND2ParseError(
                f"Truncated ND2: chunk at {pos} claims {data_len} bytes but "
                f"only {len(self._mm) - start} remain"
            )
        return bytes(self._mm[start : start + data_len])

    def read_chunk(self, name: str) -> bytes:
        pos, _ = self._chunks[name]
        return self._chunk_data_at(pos)

    def _decoded(self, name: str) -> dict[str, Any]:
        return decode_variant(self.read_chunk(name))

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._fh.close()
            self._mm = None  # type: ignore[assignment]

    def __enter__(self) -> "ND2File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- shape / sizes ------------------------------------------------------------

    def _parse_loops(self) -> list[LoopInfo]:
        loops: list[LoopInfo] = []

        def visit(exp: dict[str, Any]) -> None:
            etype = exp.get("eType")
            pars = exp.get("uLoopPars", {}) or {}
            count = pars.get("uiCount", 0)
            if etype in (_LOOP_TIME, _LOOP_NETIME) and count:
                loops.append(LoopInfo("T", int(count), pars))
            elif etype == _LOOP_XYPOS and count:
                loops.append(LoopInfo("P", int(count), pars))
            elif etype == _LOOP_ZSTACK and count:
                loops.append(LoopInfo("Z", int(count), pars))
            elif etype == _LOOP_SPECTRAL and count:
                loops.append(LoopInfo("W", int(count), pars))
            for sub in (exp.get("ppNextLevelEx", {}) or {}).values():
                if isinstance(sub, dict):
                    visit(sub)

        if self._experiment:
            visit(self._experiment)

        # Reconcile with the frames actually written: an aborted acquisition
        # stores fewer ImageDataSeq chunks than the experiment's nominal loop
        # counts. uiSequenceCount is the primary truth; when the attribute is
        # absent, the written ImageDataSeq chunks in the chunk map are the
        # ground truth instead (a nominal T-loop of N with no sequence count
        # must NOT collapse to a single frame just because the attribute
        # defaulted). Shrink the OUTERMOST loop to what completed; if the
        # frame count does not factor over the inner loops at all, fall back
        # to one flat T loop so the file stays readable (matching the nd2
        # package's partial-file behavior).
        seq_attr = self._attributes.get("uiSequenceCount")
        n_written = sum(
            1 for name in self._chunks if name.startswith("ImageDataSeq|")
        )
        if seq_attr is not None:
            seq_count = int(seq_attr)
        elif n_written:
            seq_count = n_written
        else:
            seq_count = 1
        self._seq_count = seq_count
        nominal = 1
        for lp in loops:
            nominal *= lp.count
        have_truth = seq_attr is not None or n_written > 0
        if loops and nominal != seq_count and have_truth:
            inner = 1
            for lp in loops[1:]:
                inner *= lp.count
            if inner > 0 and seq_count % inner == 0 and seq_count >= inner:
                loops[0] = LoopInfo(
                    loops[0].kind, seq_count // inner, loops[0].parameters
                )
            else:
                loops = [LoopInfo("T", seq_count, {})]
        if not loops and seq_count > 1:
            loops = [LoopInfo("T", seq_count, {})]
        return loops

    @property
    def attributes(self) -> dict[str, Any]:
        return self._attributes

    @property
    def sizes(self) -> dict[str, int]:
        """Dimension sizes ordered (loops outer->inner), C, Y, X."""
        sizes: dict[str, int] = {}
        for loop in self._loops:
            sizes[loop.kind] = loop.count
        n_comp = int(self._attributes.get("uiComp", 1))
        n_true_channels = self._channel_count()
        if n_true_channels > 1:
            sizes["C"] = n_true_channels
        if n_comp > n_true_channels and n_comp % max(n_true_channels, 1) == 0:
            samples = n_comp // max(n_true_channels, 1)
            if samples > 1:
                sizes["S"] = samples  # RGB cameras: samples per channel
        sizes["Y"] = int(self._attributes["uiHeight"])
        sizes["X"] = int(self._attributes["uiWidth"])
        return sizes

    def _channel_count(self) -> int:
        planes = self._picture_metadata.get("sPicturePlanes", {})
        count = planes.get("uiCount")
        if count:
            return int(count)
        return int(self._attributes.get("uiComp", 1))

    # -- pixel data ----------------------------------------------------------------

    def frame_timestamp_ms(self, index: int) -> float:
        pos, _ = self._chunks[f"ImageDataSeq|{index}!"]
        magic, name_len, _ = struct.unpack_from("<IIQ", self._mm, pos)
        return struct.unpack_from("<d", self._mm, pos + 16 + name_len)[0]

    def _read_frame(self, index: int) -> np.ndarray:
        """One frame as (Y, X, C) uint16 (components interleaved on disk)."""
        data = self.read_chunk(f"ImageDataSeq|{index}!")
        height = int(self._attributes["uiHeight"])
        width = int(self._attributes["uiWidth"])
        n_comp = int(self._attributes.get("uiComp", 1))
        bpc = int(self._attributes.get("uiBpcInMemory", 16))
        if bpc == 16:
            dtype = np.dtype("<u2")
        elif bpc == 8:
            dtype = np.dtype("u1")
        elif bpc == 32:
            dtype = np.dtype("<f4") if self._attributes.get("ePixelType") == 2 else np.dtype("<u4")
        else:
            raise ND2ParseError(f"Unsupported bits-per-component: {bpc}")
        stride = int(self._attributes.get("uiWidthBytes", width * n_comp * dtype.itemsize))
        pixels = np.frombuffer(data, dtype=np.uint8, offset=8)
        row_bytes = width * n_comp * dtype.itemsize
        if stride == row_bytes:
            # tight rows: one zero-copy view of the chunk buffer
            frame_bytes = pixels[: height * row_bytes]
        else:
            rows = pixels[: height * stride].reshape(height, stride)
            frame_bytes = np.ascontiguousarray(rows[:, :row_bytes]).reshape(-1)
        return frame_bytes.view(dtype).reshape(height, width, n_comp)

    def asarray(self) -> np.ndarray:
        """Full dataset shaped per `sizes` (loops..., [C], Y, X).

        One allocation + one pass: each frame's interleaved (Y, X, C) view is
        transposed directly into the planar output (numpy assignment handles
        the de-interleave), instead of stack + moveaxis + ascontiguousarray
        (three full copies at 2048^2 x 4 channels).
        """
        seq_count = self._seq_count
        sizes = self.sizes
        height, width = sizes["Y"], sizes["X"]
        first = self._read_frame(0)
        n_comp = first.shape[-1]

        loop_shape = tuple(loop.count for loop in self._loops)
        comp_axis = (n_comp,) if n_comp > 1 else ()
        out = np.empty(loop_shape + comp_axis + (height, width), first.dtype)
        flat = out.reshape((seq_count,) + out.shape[len(loop_shape) :])

        native = None
        if n_comp > 1 and first.dtype == np.uint16:
            from .. import _native

            native = _native if _native.available() else None

        for i in range(seq_count):
            frame = first if i == 0 else self._read_frame(i)
            if n_comp == 1:
                flat[i] = frame[..., 0]
            elif native is not None and frame.flags.c_contiguous:
                # C++ planarize: one sequential read pass scattering to
                # n_comp sequential write streams (the numpy transpose
                # assignment strides the source n_comp-fold)
                native.deinterleave_u16(
                    frame.reshape(-1), height * width, n_comp, flat[i].reshape(-1)
                )
                planarize_counts["native"] += 1
            else:
                flat[i] = frame.transpose(2, 0, 1)
                planarize_counts["numpy"] += 1
        expected = tuple(sizes.values())
        return out.reshape(expected)

    # -- text info -------------------------------------------------------------------

    @property
    def text_info(self) -> dict[str, str]:
        if self._text_info_cache is not None:
            return self._text_info_cache
        raw = self._decoded("ImageTextInfoLV!").get("SLxImageTextInfo", {})
        out: dict[str, str] = {}
        for i, key in enumerate(_TEXTINFO_FIELDS):
            value = raw.get(f"TextInfoItem_{i}", "")
            if value:
                out[key] = value
        self._text_info_cache = out
        return out

    # -- structured metadata -----------------------------------------------------------

    @property
    def metadata(self) -> Metadata:
        if self._metadata_cache is not None:
            return self._metadata_cache
        planes = self._picture_metadata.get("sPicturePlanes", {})
        plane_items = planes.get("sPlaneNew", {}) or {}
        sample_items = planes.get("sSampleSetting", {}) or {}
        n_channels = self._channel_count()

        z_count = 1
        z_step = 1.0
        for loop in self._loops:
            if loop.kind == "Z":
                z_count = loop.count
                z_step = float(loop.parameters.get("dZStep", 1.0)) or 1.0

        xy_cal = float(self._picture_metadata.get("dCalibration", 0.0))
        aspect = float(self._picture_metadata.get("dAspect", 1.0)) or 1.0
        volume = VolumeInfo(
            voxelCount=(
                int(self._attributes["uiWidth"]),
                int(self._attributes["uiHeight"]),
                z_count,
            ),
            axesCalibration=(xy_cal, xy_cal * aspect, z_step),
        )

        zoom = self._picture_metadata.get("dZoom")
        objective_name = self._picture_metadata.get("wsObjectiveName") or None
        obj_mag = self._picture_metadata.get("dObjectiveMag")
        obj_na = self._picture_metadata.get("dObjectiveNA")

        channels: list[ChannelStruct] = []
        for i in range(n_channels):
            plane = plane_items.get(f"a{i}", {}) if isinstance(plane_items, dict) else {}
            sample = sample_items.get(f"a{i}", {}) if isinstance(sample_items, dict) else {}

            objective = sample.get("pObjectiveSetting", {}) or {}
            mag = objective.get("dObjectiveMag")
            if mag is None or mag <= 0:
                mag = obj_mag if obj_mag and obj_mag > 0 else None
            na = objective.get("dObjectiveNA")
            if na is None or na <= 0:
                na = obj_na if obj_na and obj_na > 0 else None
            name = objective.get("wsObjectiveName") or objective_name

            ex, em = self._plane_wavelengths(plane)
            color_val = plane.get("uiColor")
            channels.append(
                ChannelStruct(
                    channel=ChannelMeta(
                        name=str(plane.get("sDescription", "") or f"Channel {i}"),
                        color=Color.from_uicolor(int(color_val)) if color_val is not None else None,
                        excitationLambdaNm=ex,
                        emissionLambdaNm=em,
                    ),
                    volume=volume,
                    microscope=MicroscopeInfo(
                        zoomMagnification=zoom,
                        objectiveMagnification=mag,
                        objectiveNumericalAperture=na,
                        objectiveName=name,
                    ),
                )
            )

        contents = Contents(
            channelCount=n_channels,
            frameCount=self._seq_count,
        )
        self._metadata_cache = Metadata(contents=contents, channels=channels)
        return self._metadata_cache

    @staticmethod
    def _plane_wavelengths(plane: dict[str, Any]) -> tuple[float | None, float | None]:
        """Excitation/emission from the fluorescent probe or the filter path."""

        def spectrum_peak(spectrum: dict[str, Any]) -> float | None:
            points = spectrum.get("pPoint", {}) or {}
            for point in points.values():
                if isinstance(point, dict):
                    wl = point.get("dWavelength", 0.0)
                    if wl:
                        return float(wl)
            return None

        probe = plane.get("pFluorescentProbe", {}) or {}
        ex = spectrum_peak(probe.get("m_ExcitationSpectrum", {}) or {})
        em = spectrum_peak(probe.get("m_EmissionSpectrum", {}) or {})
        if ex is None or em is None:
            filters = (plane.get("pFilterPath", {}) or {}).get("m_pFilter", {}) or {}
            for filt in filters.values():
                if not isinstance(filt, dict):
                    continue
                ex = ex or spectrum_peak(filt.get("m_ExcitationSpectrum", {}) or {})
                em = em or spectrum_peak(filt.get("m_EmissionSpectrum", {}) or {})
        return ex, em

    # -- events --------------------------------------------------------------------------

    def events(self) -> list[dict[str, Any]]:
        """Per-frame acquisition events.

        Columns come from the recorded CustomData traces (named
        "<Desc> [<Unit>]"), plus 'Time [s]' from the acquisition-times cache
        and the synthesized 'Z-Series' index for Z stacks (the columns the
        reference parser reads at nikon.py:304-336).
        """
        if self._events_cache is not None:
            return self._events_cache

        seq_count = self._seq_count
        columns: dict[str, np.ndarray] = {}

        if "CustomData|AcqTimesCache!" in self._chunks:
            times_ms = np.frombuffer(self.read_chunk("CustomData|AcqTimesCache!"), "<f8")
            columns["Time [s]"] = times_ms[:seq_count] / 1e3

        descriptor_key = "CustomDataVar|CustomDataV2_0!"
        if descriptor_key in self._chunks:
            desc = self._decoded(descriptor_key)
            tags = desc.get("CustomTagDescription_v1.0", {}) or {}
            for tag in tags.values():
                if not isinstance(tag, dict):
                    continue
                tag_id = tag.get("ID")
                chunk_name = f"CustomData|{tag_id}!"
                if not tag_id or chunk_name not in self._chunks:
                    continue
                dtype = "<f8" if int(tag.get("Type", 3)) == 3 else "<i4"
                values = np.frombuffer(self.read_chunk(chunk_name), dtype)
                label = str(tag.get("Desc") or tag_id)
                unit = str(tag.get("Unit") or "")
                column = f"{label} [{unit}]" if unit else label
                columns[column] = values[:seq_count]

        for loop in self._loops:
            if loop.kind == "Z":
                pars = loop.parameters
                step = float(pars.get("dZStep", 0.0)) or 1.0
                span = float(pars.get("dZHome", 0.0)) - float(pars.get("dZLow", 0.0))
                home = round(span / step)
                indices = self._loop_indices(loop)
                columns["Z-Series"] = (indices - home).astype(float)
            elif loop.kind == "P":
                points = self._loop_points(loop)
                if points:
                    indices = self._loop_indices(loop)
                    xs = np.array([float(p.get("dPosX", 0.0)) for p in points])
                    ys = np.array([float(p.get("dPosY", 0.0)) for p in points])
                    columns["X Coord [µm]"] = xs[np.minimum(indices, len(points) - 1)]
                    columns["Y Coord [µm]"] = ys[np.minimum(indices, len(points) - 1)]
            elif loop.kind == "W":
                steps = self._spectral_steps(loop)
                if steps is not None:
                    indices = self._loop_indices(loop)
                    columns["Wavelength [nm]"] = steps[
                        np.minimum(indices, len(steps) - 1)
                    ]

        events: list[dict[str, Any]] = []
        for i in range(seq_count):
            row: dict[str, Any] = {"Index": i}
            for column, values in columns.items():
                if i < len(values):
                    row[column] = values[i].item() if hasattr(values[i], "item") else values[i]
            events.append(row)
        self._events_cache = events
        return events

    @staticmethod
    def _loop_points(loop: LoopInfo) -> list[dict[str, Any]]:
        """The ordered per-iteration point records of a position loop."""
        raw = loop.parameters.get("Points", {}) or {}
        return [p for p in raw.values() if isinstance(p, dict)]

    def _spectral_steps(self, loop: LoopInfo) -> np.ndarray | None:
        """Per-step wavelengths (nm) of a spectral loop.

        Prefers explicit per-plane wavelengths recorded in the loop's point
        table; falls back to a uniform ramp when the loop records only
        (start, step). None when the file gives neither.
        """
        points = self._loop_points(loop)
        # membership, not truthiness: a legitimate dWavelength of 0.0 must
        # not silently drop the explicit list; require every point to carry
        # the field before trusting it
        explicit = [p.get("dWavelength") for p in points]
        if (
            explicit
            and len(explicit) == loop.count
            and all(wl is not None for wl in explicit)
        ):
            return np.asarray(explicit, dtype=float)
        pars = loop.parameters
        start = pars.get("dWavelengthStart")
        step = pars.get("dWavelengthStep")
        if start is not None and step is not None:
            return float(start) + float(step) * np.arange(loop.count, dtype=float)
        return None

    def _loop_indices(self, target: LoopInfo) -> np.ndarray:
        """Per-frame index within `target`, given outer->inner loop nesting."""
        seq_count = self._seq_count
        inner = 1
        seen = False
        for loop in reversed(self._loops):
            if loop is target:
                seen = True
                break
            inner *= loop.count
        if not seen:
            return np.zeros(seq_count, dtype=int)
        return (np.arange(seq_count) // inner) % target.count


def imread(path: str | Path) -> np.ndarray:
    """Read the full pixel array of an ND2 file."""
    with ND2File(path) as f:
        return f.asarray()
