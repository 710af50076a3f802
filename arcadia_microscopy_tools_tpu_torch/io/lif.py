"""From-scratch Leica LIF (Leica Image Format) reader.

The port's own copy of `arcadia_microscopy_tools_tpu/io/lif.py` (host
NumPy, no JAX): the same classes, errors and cache, with two copies of the
pixels taken out of the decode. The parser keeps each memory block as a
view of the file's bytes instead of a copy, and `LifImage.asarray` reads
the block through one strided view of the image's own dtype at the
declared byte strides and first channel offset, so one copy makes the
array, for every geometry. The checks run before the view, where the
reference runs them.

This is a clean-room implementation of the public LIF v2 container format
(there is no `liffile` package here), exposing the surface
the Leica metadata parser needs (the reference consumes `liffile` at
`src/arcadia_microscopy_tools/leica.py:48,78,372-380`): image list by name,
pixel data, sizes, per-dimension coordinates, timestamps, the image's XML
element, and attachment attributes (HardwareSetting / TileScanInfo /
LaserValues).

Container layout (little-endian):
- Header block: u32 0x70, u32 length, u8 0x2A, u32 nchars, UTF-16LE XML
  document (an <LMSDataContainerHeader> tree of <Element>s).
- Memory blocks: u32 0x70, u32 length, u8 0x2A, u64 memory_size (v2; u32 in
  v1), u8 0x2A, u32 nchars, UTF-16LE block id ("MemBlock_xx"), then
  memory_size raw bytes.
- Pixel geometry is fully described by <ChannelDescription BytesInc=...> and
  <DimensionDescription DimID= NumberOfElements= BytesInc=...>, so frames are
  reconstructed with stride tricks rather than format-specific loops.

Dimension ID legend (LAS X): 1=X, 2=Y, 3=Z, 4=T, 5=lambda(em), 6=Rotation,
7=XT, 8=TSlice, 9=Lambda(exc), 10=Mosaic.
"""

from __future__ import annotations

import os
import struct
import threading
import xml.etree.ElementTree as ET
from collections import OrderedDict
from datetime import datetime, timedelta, timezone
from pathlib import Path
from typing import Any

import numpy as np

_DIM_LABELS = {
    1: "X",
    2: "Y",
    3: "Z",
    4: "T",
    5: "λ",
    6: "A",
    7: "N",
    8: "Q",
    9: "Λ",
    10: "M",
}

# Windows FILETIME epoch (1601-01-01) for <TimeStamp> HighInteger/LowInteger
_FILETIME_EPOCH = datetime(1601, 1, 1, tzinfo=timezone.utc)


class LifParseError(ValueError):
    """Raised when a LIF file cannot be parsed."""


def _xml_element_to_attrs(elem: ET.Element) -> Any:
    """Convert an XML element to the nested dict/list shape the parsers
    expect: attributes become keys; repeated child tags become lists."""
    children: dict[str, Any] = {}
    for child in elem:
        value = _xml_element_to_attrs(child)
        if child.tag in children:
            existing = children[child.tag]
            if isinstance(existing, list):
                existing.append(value)
            else:
                children[child.tag] = [existing, value]
        else:
            children[child.tag] = value
    out: dict[str, Any] = dict(elem.attrib)
    out.update(children)
    return out


class LifImage:
    """One image inside a LIF file."""

    def __init__(self, lif: "LifFile", element: ET.Element, path: str):
        self._lif = lif
        self.xml_element = element
        self.name = element.get("Name", "")
        self.path = path

        data = element.find("./Data/Image")
        if data is None:
            raise LifParseError(f"Element {self.name!r} has no image data")
        desc = data.find("ImageDescription")
        if desc is None:
            raise LifParseError(f"Image {self.name!r} missing ImageDescription")
        self._description = desc

        memory = data.find("Memory")
        self.memory_block_id = memory.get("MemoryBlockID") if memory is not None else None
        self.memory_size = int(memory.get("Size", "0")) if memory is not None else 0

        self._channels = desc.findall("./Channels/ChannelDescription")
        self._dimensions = desc.findall("./Dimensions/DimensionDescription")

    # -- geometry -----------------------------------------------------------------

    @property
    def num_channels(self) -> int:
        return max(len(self._channels), 1)

    def _dim_records(self) -> list[dict[str, Any]]:
        records = []
        for d in self._dimensions:
            records.append(
                {
                    "dim_id": int(d.get("DimID", "0")),
                    "label": _DIM_LABELS.get(int(d.get("DimID", "0")), f"D{d.get('DimID')}"),
                    "n": int(d.get("NumberOfElements", "1")),
                    "origin": float(d.get("Origin", "0") or 0),
                    "length": float(d.get("Length", "0") or 0),
                    "unit": d.get("Unit", ""),
                    "bytes_inc": int(d.get("BytesInc", "0")),
                }
            )
        return records

    def _axes(self) -> list[tuple[int, str, int]]:
        """(byte stride, label, extent) per axis, slowest-varying first.

        The single source of truth for both `sizes` and `asarray` - the two
        must agree or consumers pairing them get mismatched shapes. The
        channel axis stride is the spacing between per-channel BytesInc.
        """
        axes: list[tuple[int, str, int]] = [
            (d["bytes_inc"], d["label"], d["n"])
            for d in self._dim_records()
            if d["n"] > 1 or d["label"] in ("X", "Y")
        ]
        if len(self._channels) > 1:
            incs = sorted(int(c.get("BytesInc", "0")) for c in self._channels)
            ch_stride = incs[1] - incs[0] if len(incs) > 1 else 0
            axes.append((ch_stride, "C", len(self._channels)))
        axes.sort(key=lambda t: -t[0])
        return axes

    @property
    def sizes(self) -> dict[str, int]:
        """Dimension sizes ordered slowest-varying first (descending byte
        stride), with the channel axis placed by the channel BytesInc."""
        return {label: n for _, label, n in self._axes()}

    @property
    def dtype(self) -> np.dtype:
        res = int(self._channels[0].get("Resolution", "16")) if self._channels else 16
        return np.dtype("<u2") if res > 8 else np.dtype("u1")

    def asarray(self) -> np.ndarray:
        """Decode the image's memory block into an array shaped per `sizes`."""
        if self.memory_block_id is None:
            raise LifParseError(f"Image {self.name!r} has no memory block")
        raw = self._lif._memory_blocks.get(self.memory_block_id)
        if raw is None:
            raise LifParseError(f"Memory block {self.memory_block_id!r} not found")

        dtype = self.dtype
        axes = self._axes()
        first_inc = int(self._channels[0].get("BytesInc", "0")) if self._channels else 0

        shape = tuple(n for _, _, n in axes)
        strides = tuple(s for s, _, _ in axes)
        last_byte = first_inc + sum(
            (n - 1) * s for s, _, n in axes
        ) + np.dtype(dtype).itemsize
        if last_byte > len(raw):
            raise LifParseError(
                f"Image {self.name!r}: memory block holds {len(raw)} bytes "
                f"but the declared geometry needs {last_byte}"
            )
        # one strided view of the image's own dtype (NumPy allows it unaligned,
        # at any byte stride); one copy makes the array
        return np.ndarray(shape, dtype, buffer=raw, offset=first_inc, strides=strides).copy()

    # -- physical coordinates -------------------------------------------------------

    @property
    def coords(self) -> dict[str, np.ndarray]:
        """Per-dimension coordinate arrays in each dimension's raw unit:
        origin + step * index, with step = length / number_of_elements - the
        convention the reference's `_LifDimension.step` uses
        (src/arcadia_microscopy_tools/leica.py:194-196), which downstream
        nominal-dimension parity tests pin."""
        out = {}
        for d in self._dim_records():
            if d["n"] > 1:
                step = d["length"] / d["n"]
                out[d["label"]] = d["origin"] + step * np.arange(d["n"])
        return out

    @property
    def timestamps(self) -> list[datetime]:
        """Frame timestamps from the TimeStampList (FILETIME ticks)."""
        stamps: list[datetime] = []
        tsl = self.xml_element.find("./Data/Image/TimeStampList")
        if tsl is None:
            return stamps
        if tsl.text and tsl.text.strip():
            # modern format: space-separated hex FILETIME values
            for tok in tsl.text.split():
                try:
                    ticks = int(tok, 16)
                except ValueError:
                    continue
                stamps.append(_FILETIME_EPOCH + timedelta(microseconds=ticks / 10))
        else:
            for ts in tsl.findall("TimeStamp"):
                high = int(ts.get("HighInteger", "0"))
                low = int(ts.get("LowInteger", "0"))
                ticks = (high << 32) + low
                stamps.append(_FILETIME_EPOCH + timedelta(microseconds=ticks / 10))
        return stamps

    @property
    def attrs(self) -> dict[str, Any]:
        """Attachment metadata (HardwareSetting, TileScanInfo, LaserValues,
        ...) as nested dicts of XML attributes, lists for repeated tags."""
        out: dict[str, Any] = {}
        for attachment in self.xml_element.findall("./Data/Image/Attachment"):
            name = attachment.get("Name", "")
            if name:
                out[name] = _xml_element_to_attrs(attachment)
        return out


class LifFile:
    """Minimal LIF reader with the `liffile.LifFile`-compatible surface used
    by the Leica metadata parser."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        with open(self.path, "rb") as fh:
            data = fh.read()
        self._xml, self._memory_blocks = self._parse_container(data)
        self._images = self._collect_images()

    @staticmethod
    def _parse_container(data: bytes) -> tuple[ET.Element, dict[str, memoryview]]:
        if len(data) < 13 or struct.unpack_from("<I", data, 0)[0] != 0x70:
            raise LifParseError("Not a LIF file (bad magic)")
        try:
            return LifFile._parse_container_unchecked(data)
        except (struct.error, IndexError, UnicodeDecodeError) as e:
            # a container truncated mid-header must fail loudly as a parse
            # error, not leak struct/index internals
            raise LifParseError(f"Truncated LIF container: {e}") from None
        except ET.ParseError as e:
            raise LifParseError(f"Malformed LIF XML header: {e}") from None

    @staticmethod
    def _parse_container_unchecked(data: bytes) -> tuple[ET.Element, dict[str, memoryview]]:
        pos = 0
        view = memoryview(data)

        def read_u32(p):
            return struct.unpack_from("<I", data, p)[0], p + 4

        def read_u64(p):
            return struct.unpack_from("<Q", data, p)[0], p + 8

        # header block
        magic, pos = read_u32(pos)
        _size, pos = read_u32(pos)
        if data[pos] != 0x2A:
            raise LifParseError("Bad LIF header test byte")
        pos += 1
        nchars, pos = read_u32(pos)
        xml_text = data[pos : pos + 2 * nchars].decode("utf-16-le")
        pos += 2 * nchars
        root = ET.fromstring(xml_text)
        version = int(root.get("Version", "2"))

        blocks: dict[str, memoryview] = {}
        while pos + 13 <= len(data):
            magic, pos = read_u32(pos)
            if magic != 0x70:
                raise LifParseError(f"Bad block magic at {pos - 4}")
            _blen, pos = read_u32(pos)
            if data[pos] != 0x2A:
                raise LifParseError("Bad block test byte")
            pos += 1
            if version >= 2:
                mem_size, pos = read_u64(pos)
            else:
                mem_size, pos = read_u32(pos)
            if data[pos] != 0x2A:
                raise LifParseError("Bad block description test byte")
            pos += 1
            nchars, pos = read_u32(pos)
            block_id = data[pos : pos + 2 * nchars].decode("utf-16-le")
            pos += 2 * nchars
            if pos + mem_size > len(data):
                # Python slicing would silently shorten the block, and a
                # strided view over a short buffer reads out of bounds
                raise LifParseError(
                    f"Truncated LIF: memory block {block_id!r} claims "
                    f"{mem_size} bytes but only {len(data) - pos} remain"
                )
            blocks[block_id] = view[pos : pos + mem_size]  # a view, not a copy
            pos += mem_size
        return root, blocks

    def _collect_images(self) -> list[LifImage]:
        images: list[LifImage] = []

        def visit(elem: ET.Element, prefix: str) -> None:
            for child in elem.findall("./Children/Element") + (
                elem.findall("./Element") if elem.tag == "LMSDataContainerHeader" else []
            ):
                name = child.get("Name", "")
                path = f"{prefix}/{name}" if prefix else name
                if child.find("./Data/Image") is not None:
                    images.append(LifImage(self, child, path))
                visit(child, path)

        visit(self._xml, "")
        return images

    @property
    def images(self) -> "_ImageList":
        return _ImageList(self._images)

    def close(self) -> None:
        pass

    def __enter__(self) -> "LifFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- container cache ----------------------------------------------------------------
#
# Plate workflows read many images out of the SAME .lif container (one image
# per well); re-reading and re-parsing the container header costs ~39 ms of
# stdlib XML parse plus the full-file read per well (the reference pays the
# same per-call open, src/arcadia_microscopy_tools/leica.py:52-80). A parsed
# LifFile is immutable after construction (asarray returns fresh copies), so
# one instance per (path, size, mtime) is shared across the plate
# prefetcher's worker threads. LRU-bounded; mutation detected via stat.

_CACHE_LOCK = threading.Lock()
_CONTAINER_CACHE: "OrderedDict[tuple[str, int, int], LifFile]" = OrderedDict()
_CACHE_MAX = max(1, int(os.environ.get("AMT_LIF_CACHE_CONTAINERS", "4")))


def open_cached(path: str | Path) -> LifFile:
    """A shared parsed `LifFile` for `path`, re-parsed only when the file
    changes (size or mtime_ns). Thread-safe; the instance must be treated
    as read-only (LifFile already is). `close()` on it is a no-op."""
    p = Path(path)
    st = p.stat()
    key = (str(p.resolve()), st.st_size, st.st_mtime_ns)
    with _CACHE_LOCK:
        hit = _CONTAINER_CACHE.get(key)
        if hit is not None:
            _CONTAINER_CACHE.move_to_end(key)
            return hit
        # parse under the lock: duplicated parses from racing threads would
        # cost more than the brief serialization (~40 ms header parse)
        container = LifFile(p)
        # stale entries for the same path (older size/mtime) get evicted by
        # the LRU bound; drop them eagerly so an edited file can't pin memory
        for k in [k for k in _CONTAINER_CACHE if k[0] == key[0]]:
            del _CONTAINER_CACHE[k]
        _CONTAINER_CACHE[key] = container
        while len(_CONTAINER_CACHE) > _CACHE_MAX:
            _CONTAINER_CACHE.popitem(last=False)
        return container


def clear_container_cache() -> None:
    with _CACHE_LOCK:
        _CONTAINER_CACHE.clear()


class _ImageList:
    """List-like with name lookup (liffile.images semantics)."""

    def __init__(self, images: list[LifImage]):
        self._images = images

    def __iter__(self):
        return iter(self._images)

    def __len__(self):
        return len(self._images)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self._images[key]
        for img in self._images:
            if img.name == key or img.path == key:
                return img
        raise KeyError(key)
