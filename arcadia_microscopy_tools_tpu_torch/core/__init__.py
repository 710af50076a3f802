"""Core data model: channels, metadata structures, the MicroscopyImage
container, and microplate layouts."""

from .channels import CHANNELS, Channel, wavelength_to_hex
from .metadata_structures import (
    AcquisitionSettings,
    ChannelMetadata,
    DimensionFlags,
    MeasuredDimensions,
    MicroscopeConfig,
    NominalDimensions,
)
from .microplate import MicroplateLayout, Well
from .microscopy import InstrumentMetadata, Metadata, MicroscopyImage

__all__ = [
    "AcquisitionSettings",
    "CHANNELS",
    "Channel",
    "ChannelMetadata",
    "DimensionFlags",
    "InstrumentMetadata",
    "MeasuredDimensions",
    "Metadata",
    "MicroplateLayout",
    "MicroscopeConfig",
    "MicroscopyImage",
    "NominalDimensions",
    "Well",
    "wavelength_to_hex",
]
