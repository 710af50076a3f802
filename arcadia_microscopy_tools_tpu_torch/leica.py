"""Leica facade (reference module parity:
`src/arcadia_microscopy_tools/leica.py`; counterpart of the JAX package's
`leica.py`)."""

from .io.leica import (  # noqa: F401
    CRS_STOKES_WAVELENGTH_NM,
    calculate_antistokes_wavelength,
    calculate_raman_shift,
    list_image_names,
    load_lif_image,
)

__all__ = [
    "CRS_STOKES_WAVELENGTH_NM",
    "calculate_antistokes_wavelength",
    "calculate_raman_shift",
    "list_image_names",
    "load_lif_image",
]
