"""Microplate facade (reference module parity:
`src/arcadia_microscopy_tools/microplate.py`)."""

from .core.microplate import MicroplateLayout, Well

__all__ = ["MicroplateLayout", "Well"]
