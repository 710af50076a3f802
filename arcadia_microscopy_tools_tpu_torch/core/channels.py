"""Microscopy channel definitions and wavelength-to-color utilities.

Same data model and predefined-channel registry as the reference
(`src/arcadia_microscopy_tools/channels.py:35-117`), but with a
zero-dependency colorimetry path: instead of the `colour-science` package we
use the Wyman-Sloan-Shirley (2013) analytic approximation of the CIE 1931
2-degree color matching functions, which is accurate to ~1% over the visible
range - more than enough to pick a display color for a channel.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

_HEX_RE = re.compile(r"^#(?:[0-9a-fA-F]{3}){1,2}$")


def _piecewise_gaussian(x: float, mu: float, s1: float, s2: float) -> float:
    """Asymmetric Gaussian lobe used by the analytic CIE CMF fit."""
    t = (x - mu) * (s1 if x < mu else s2)
    return float(np.exp(-0.5 * t * t))


def _wavelength_to_xyz(wavelength_nm: float) -> np.ndarray:
    """CIE 1931 2-degree XYZ tristimulus values for a monochromatic stimulus.

    Analytic multi-lobe Gaussian fit (Wyman, Sloan & Shirley, JCGT 2013).
    """
    w = float(wavelength_nm)
    x = (
        0.362 * _piecewise_gaussian(w, 442.0, 0.0624, 0.0374)
        + 1.056 * _piecewise_gaussian(w, 599.8, 0.0264, 0.0323)
        - 0.065 * _piecewise_gaussian(w, 501.1, 0.0490, 0.0382)
    )
    y = 0.821 * _piecewise_gaussian(w, 568.8, 0.0213, 0.0247) + 0.286 * _piecewise_gaussian(
        w, 530.9, 0.0613, 0.0322
    )
    z = 1.217 * _piecewise_gaussian(w, 437.0, 0.0845, 0.0278) + 0.681 * _piecewise_gaussian(
        w, 459.0, 0.0385, 0.0725
    )
    return np.array([x, y, z], dtype=np.float64)


# sRGB (IEC 61966-2-1) XYZ -> linear-RGB matrix, D65 white point.
_XYZ_TO_SRGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    dtype=np.float64,
)


def _srgb_encode(linear: np.ndarray) -> np.ndarray:
    """Apply the sRGB opto-electronic transfer function."""
    return np.where(
        linear <= 0.0031308,
        12.92 * linear,
        1.055 * np.power(np.clip(linear, 0.0, None), 1.0 / 2.4) - 0.055,
    )


_VISIBLE_NM = (360.0, 780.0)


def wavelength_to_hex(wavelength_nm: float) -> str:
    """Display color (``"#RRGGBB"``) for a monochromatic visible wavelength.

    The wavelength is mapped through the analytic CIE XYZ fit above, the
    sRGB primaries matrix, and the sRGB transfer curve, then quantised to
    8 bits per component. Raises ValueError outside 360-780 nm.
    """
    lo, hi = _VISIBLE_NM
    if not lo <= wavelength_nm <= hi:
        raise ValueError(
            f"Wavelength must be in the visible range ({lo:.0f}-{hi:.0f} nm), "
            f"got {wavelength_nm} nm"
        )
    rgb = np.clip(_srgb_encode(_XYZ_TO_SRGB @ _wavelength_to_xyz(wavelength_nm)), 0, 1)
    # truncation (not rounding) matches the reference's (rgb * 255).astype(int)
    return "#" + "".join(f"{int(float(v) * 255):02X}" for v in rgb)


@dataclass(frozen=True)
class Channel:
    """One imaging channel: a display name + color, and (for fluorescence
    modalities) the excitation/emission wavelengths in nanometers. Instances
    are frozen and hashable so they can key intensity-image dicts."""

    name: str
    color: str
    excitation_nm: float | None = None
    emission_nm: float | None = None

    def __post_init__(self) -> None:
        if not _HEX_RE.match(self.color):
            raise ValueError(f"color must be a hex code like '#FF0000', got '{self.color}'")
        for attr in ("excitation_nm", "emission_nm"):
            value = getattr(self, attr)
            if value is not None and value <= 0:
                raise ValueError(f"{attr} must be positive")

    @classmethod
    def from_wavelength(
        cls,
        wavelength_nm: float,
        *,
        name: str | None = None,
        is_excitation: bool = True,
    ) -> Channel:
        """Synthesize a channel for a laser line / emission band at
        ``wavelength_nm``, coloring it by that wavelength's apparent hue.
        The wavelength lands in the excitation slot by default, or the
        emission slot when ``is_excitation=False``."""
        rounded = round(wavelength_nm, 1)
        slots = {"excitation_nm": rounded} if is_excitation else {"emission_nm": rounded}
        return cls(
            name=name if name is not None else f"{wavelength_nm:.0f}nm",
            color=wavelength_to_hex(wavelength_nm),
            **slots,
        )

    def rgb(self) -> tuple[float, float, float]:
        """The channel color as float (r, g, b) components in [0, 1]."""
        digits = self.color[1:]
        if len(digits) == 3:
            digits = "".join(2 * d for d in digits)
        r, g, b = (int(digits[k : k + 2], 16) / 255.0 for k in (0, 2, 4))
        return (r, g, b)


# Predefined registry: (name, hex color, excitation nm, emission nm) rows,
# values matching the reference's channel set (channels.py:88-117). Names with
# '-' get module constants with '_' (E-CARS -> E_CARS).
_PREDEFINED: list[tuple[str, str, float | None, float | None]] = [
    ("BRIGHTFIELD", "#FFFFFF", None, None),
    ("DIC", "#FFFFFF", None, None),
    ("PHASE", "#DDDDDD", None, None),
    ("DAPI", "#0033FF", 405, 450),
    ("FITC", "#07FF00", 488, 512),
    ("TRITC", "#FFBF00", 561, 595),
    ("CY5", "#A30000", 640, 665),
    ("SRS", "#E63535", None, None),
    ("E-CARS", "#AB1299", None, None),
    ("F-CARS", "#AB1299", None, None),
    ("E-SHG", "#F29B4F", None, None),
    ("F-SHG", "#F29B4F", None, None),
]

CHANNELS: dict[str, Channel] = {
    name: Channel(name, color, excitation_nm=ex, emission_nm=em)
    for name, color, ex, em in _PREDEFINED
}

# Module-level constants for each registry entry ('-' becomes '_').
BRIGHTFIELD: Channel = CHANNELS["BRIGHTFIELD"]
DIC: Channel = CHANNELS["DIC"]
PHASE: Channel = CHANNELS["PHASE"]
DAPI: Channel = CHANNELS["DAPI"]
FITC: Channel = CHANNELS["FITC"]
TRITC: Channel = CHANNELS["TRITC"]
CY5: Channel = CHANNELS["CY5"]
SRS: Channel = CHANNELS["SRS"]
E_CARS: Channel = CHANNELS["E-CARS"]
F_CARS: Channel = CHANNELS["F-CARS"]
E_SHG: Channel = CHANNELS["E-SHG"]
F_SHG: Channel = CHANNELS["F-SHG"]
