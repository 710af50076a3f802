"""Nikon facade (reference module parity:
`src/arcadia_microscopy_tools/nikon.py`)."""

from .io.nikon import load_nd2, _resolve_optical_config  # noqa: F401

__all__ = ["load_nd2"]
