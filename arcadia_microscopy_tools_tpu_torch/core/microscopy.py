"""Core image data model.

A `MicroscopyImage` pairs one intensity array with the metadata tree
describing how it was acquired. The shape contract is strict: the array's
axes must line up, in order, with `metadata.instrument.sizes` (e.g.
``{'T': 100, 'C': 2, 'Y': 512, 'X': 512}`` demands a (100, 2, 512, 512)
array), and non-uint16 data triggers a `MetadataWarning` because the
downstream dtype contracts assume 16-bit detector counts. Behavior and API
match the reference model (`src/arcadia_microscopy_tools/microscopy.py:17-308`),
including name-based channel extraction and the pipeline bridge.

Counterpart of `arcadia_microscopy_tools_tpu/core/microscopy.py`:
intensities may be host (NumPy) or device (torch) resident, and
`device_intensities()` copies them to a device once per device - every
later channel slice reuses the cached tensor instead of re-crossing the
host->device boundary. The device is the CUDA card unless the caller names
another; without a card it raises unless the caller passes "cpu".
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from functools import cached_property
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..exceptions import MetadataWarning
from ..typing import AnyArray, ScalarArray, UInt16Array
from ..utils import resolve_device
from .channels import Channel
from .metadata_structures import ChannelMetadata, DimensionFlags

__all__ = ["InstrumentMetadata", "Metadata", "MicroscopyImage"]


@dataclass
class InstrumentMetadata:
    """Acquisition metadata for every channel of one image.

    Attributes:
        sizes: Ordered axis-name -> extent mapping; its order defines the
            intensity array's axis order.
        channel_metadata_list: One `ChannelMetadata` per channel, in the
            channel axis order.
    """

    sizes: dict[str, int]  # axis order == intensity array axis order
    channel_metadata_list: list[ChannelMetadata]

    def __post_init__(self) -> None:
        """Cross-check the axis table against the per-channel records."""
        for axis in ("X", "Y"):
            if axis not in self.sizes:
                msg = f"sizes must contain '{axis}' dimension, got keys: {list(self.sizes.keys())}"
                raise ValueError(msg)

        declared = self.sizes.get("C", 1)
        described = len(self.channel_metadata_list)
        if described != declared:
            msg = (
                f"Number of channel metadata entries ({described}) does not match "
                f"the channel dimension size ({declared}) in sizes"
            )
            raise ValueError(msg)

    @property
    def channel_axis(self) -> int | None:
        """Position of the 'C' axis in the array, or None without one."""
        keys = list(self.sizes)
        return keys.index("C") if "C" in self.sizes else None

    @cached_property
    def dimensions(self) -> DimensionFlags:
        """Axis flags for the whole image: the OR over all channels' flags,
        plus MULTICHANNEL whenever more than one channel exists."""
        combined = DimensionFlags(0)
        for record in self.channel_metadata_list:
            combined |= record.dimensions
        if len(self.channel_metadata_list) > 1:
            combined |= DimensionFlags.MULTICHANNEL
        return combined


@dataclass
class Metadata:
    """The full metadata attached to an image: instrument + sample.

    Attributes:
        instrument: What the microscope recorded (axes, channels, optics).
        sample: Free-form experimenter annotations, or None.
    """

    instrument: InstrumentMetadata  # parsed from the file
    sample: dict[str, Any] | None = None  # experimenter-supplied

    def __repr__(self) -> str:
        names = [record.channel.name for record in self.instrument.channel_metadata_list]
        tail = f", sample={self.sample}" if self.sample else ""
        return f"<Metadata sizes={self.instrument.sizes}, channels={names}{tail}>"


@dataclass
class MicroscopyImage:
    """An intensity array plus the metadata that makes it interpretable.

    Attributes:
        intensities: The pixel data; axis order follows
            `metadata.instrument.sizes` (e.g. (T, C, Y, X) for a
            multichannel timelapse). NumPy or torch resident.
        metadata: Instrument + sample metadata; validated against the array
            shape on construction.
    """

    intensities: UInt16Array  # uint16 detector counts, axes per sizes
    metadata: Metadata  # validated against the array on construction

    def __post_init__(self) -> None:
        """Fail fast on a shape/metadata mismatch; warn on non-uint16 data."""
        declared_shape = tuple(self.metadata.instrument.sizes.values())
        if tuple(self.intensities.shape) != declared_shape:
            msg = (
                f"Intensities shape {tuple(self.intensities.shape)} does not match"
                f" metadata sizes {self.metadata.instrument.sizes}"
                f" (expected shape {declared_shape})"
            )
            raise ValueError(msg)
        if self.intensities.dtype not in (np.uint16, torch.uint16):
            note = (
                f"Expected uint16 intensities, got {self.intensities.dtype}."
                " Some operations may behave unexpectedly."
            )
            warnings.warn(note, MetadataWarning, stacklevel=2)

    def __repr__(self) -> str:
        data = self.intensities
        flat = (data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)).ravel()
        if flat.size <= 10:
            preview = f"intensities={flat.tolist()}"
        else:
            head = ", ".join(str(v) for v in flat[:3])
            tail = ", ".join(str(v) for v in flat[-3:])
            preview = f"intensities=[{head}, ..., {tail}]"
        names = [ch.name for ch in self.channels]
        return (
            f"<MicroscopyImage sizes={self.sizes}, channels={names}, "
            f"{preview}, dtype={self.intensities.dtype}>"
        )

    # -- constructors ------------------------------------------------------------

    @classmethod
    def from_nd2_path(
        cls,
        nd2_path: Path,
        channels: list[Channel] | None = None,
        sample_metadata: dict[str, Any] | None = None,
    ) -> MicroscopyImage:
        """Load a Nikon ND2 file (decode + metadata parse in `io.nikon`).

        Args:
            nd2_path: The .nd2 file to read.
            channels: Override the automatic channel identification (one
                Channel per file channel, in order).
            sample_metadata: Experimenter annotations to attach.
        """
        from ..io.nikon import load_nd2

        pixels, instrument = load_nd2(nd2_path, channels)
        return cls(pixels, Metadata(instrument, sample_metadata))

    @classmethod
    def from_lif_path(
        cls,
        lif_path: Path,
        image_name: str,
        channels: list[Channel] | None = None,
        sample_metadata: dict[str, Any] | None = None,
    ) -> MicroscopyImage:
        """Load one image from a Leica LIF container (see `io.leica`).

        Args:
            lif_path: The .lif file to read.
            image_name: Which image in the container (LIF files hold many);
                see `io.leica.list_image_names`.
            channels: Override the automatic channel identification.
            sample_metadata: Experimenter annotations to attach.
        """
        from ..io.leica import load_lif_image

        pixels, instrument = load_lif_image(lif_path, image_name, channels)
        return cls(pixels, Metadata(instrument, sample_metadata))

    # -- shape / channel introspection ---------------------------------------------

    @property
    def shape(self) -> tuple[int, ...]:
        """The intensity array's shape."""
        return tuple(self.intensities.shape)

    @property
    def sizes(self) -> dict[str, int]:
        """Axis-name -> extent mapping (defines the axis order)."""
        return self.metadata.instrument.sizes

    @property
    def dimensions(self) -> DimensionFlags:
        """Axis flags for the image (OR over channels)."""
        return self.metadata.instrument.dimensions

    @property
    def channels(self) -> list[Channel]:
        """Channel identities, in channel-axis order."""
        return [record.channel for record in self.metadata.instrument.channel_metadata_list]

    @property
    def channel_axis(self) -> int | None:
        """Position of the channel axis, or None for single-channel data."""
        return self.metadata.instrument.channel_axis

    @property
    def num_channels(self) -> int:
        """How many channels the image holds."""
        return len(self.metadata.instrument.channel_metadata_list)

    # -- device residency ------------------------------------------------------------

    def device_intensities(self, device: str | torch.device | None = None) -> torch.Tensor:
        """The intensity array as a cached tensor on `device` (None: the
        CUDA card, raising when there is none; pass "cpu" for the CPU).

        The first call per device pays one host->device copy; later calls
        (and the channel slices taken from them) reuse the same tensor. On
        the card a uint16 tensor supports little beyond copies and casts:
        convert it before computing on it.
        """
        dev = resolve_device(device)
        cache = self.__dict__.setdefault("_device_intensities", {})
        buffer = cache.get(str(dev))
        if buffer is None:
            data = self.intensities
            if not isinstance(data, torch.Tensor):
                data = np.asarray(data)
            buffer = torch.as_tensor(data, device=dev)
            cache[str(dev)] = buffer
        return buffer

    # -- channel extraction ------------------------------------------------------------

    def get_channel_intensities(
        self, channel: str | Channel, *, device: bool | str | torch.device = False
    ) -> AnyArray:
        """All intensity data belonging to one channel.

        The non-channel axes are preserved: a (T, C, Y, X) timelapse yields
        (T, Y, X) for the chosen channel; single-channel images return the
        whole array.

        Args:
            channel: Channel object or channel name to extract.
            device: False for the host array; True for a slice of the cached
                copy on the CUDA card (raises without one); a device name or
                `torch.device` for a slice of the cached copy there.

        Raises:
            ValueError: For a channel name the image does not contain.
        """
        wanted = channel if isinstance(channel, str) else channel.name
        names = [ch.name for ch in self.channels]
        if wanted not in names:
            msg = f"Channel '{wanted}' not found in image. Available channels: {names}"
            raise ValueError(msg)

        if device is False:
            data = self.intensities
        else:
            data = self.device_intensities(None if device is True else device)
        if self.num_channels == 1:
            return data

        axis = self.channel_axis
        if axis is None:
            raise ValueError("Channel axis not found in metadata")
        index: list[slice | int] = [slice(None)] * len(data.shape)
        index[axis] = names.index(wanted)
        return data[tuple(index)]

    def apply_pipeline(self, pipeline, channel: str | Channel) -> ScalarArray:
        """Run a `Pipeline` on one channel's intensities.

        Equivalent to ``pipeline(image.get_channel_intensities(channel))``.

        Args:
            pipeline: The port's `Pipeline` (or any callable on arrays) to
                apply; it runs on its own device.
            channel: Which channel's data to process.
        """
        return pipeline(self.get_channel_intensities(channel))
