"""Channels facade (reference module parity:
`src/arcadia_microscopy_tools/channels.py`)."""

from .core.channels import (
    BRIGHTFIELD,
    CHANNELS,
    CY5,
    DAPI,
    DIC,
    E_CARS,
    E_SHG,
    F_CARS,
    F_SHG,
    FITC,
    PHASE,
    SRS,
    TRITC,
    Channel,
    wavelength_to_hex,
)

__all__ = [
    "BRIGHTFIELD", "CHANNELS", "CY5", "DAPI", "DIC", "E_CARS", "E_SHG",
    "F_CARS", "F_SHG", "FITC", "PHASE", "SRS", "TRITC", "Channel",
    "wavelength_to_hex",
]
