"""Microscopy facade (reference module parity:
`src/arcadia_microscopy_tools/microscopy.py`)."""

from .core.microscopy import InstrumentMetadata, Metadata, MicroscopyImage

__all__ = ["InstrumentMetadata", "Metadata", "MicroscopyImage"]
