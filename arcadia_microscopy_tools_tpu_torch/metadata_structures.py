"""Metadata structures facade (reference module parity:
`src/arcadia_microscopy_tools/metadata_structures.py`)."""

from .core.metadata_structures import (
    AcquisitionSettings,
    ChannelMetadata,
    DimensionFlags,
    DimensionValidatorMixin,
    MeasuredDimensions,
    MicroscopeConfig,
    NominalDimensions,
    dimension_field,
)

__all__ = [
    "AcquisitionSettings", "ChannelMetadata", "DimensionFlags",
    "DimensionValidatorMixin", "MeasuredDimensions", "MicroscopeConfig",
    "NominalDimensions", "dimension_field",
]
