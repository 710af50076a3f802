"""Fluorescence overlay rendering as tensor arithmetic on the device.

Counterpart of `arcadia_microscopy_tools_tpu/viz/blending.py`: `BlendMode`,
`Layer`, `overlay_channels`, `create_overlay`, plus the internal blend
helpers its tests exercise. The reference's two-stop colormap is a closed
form linear interpolation between the zero anchor and the channel color,
evaluated continuously in float32, as the JAX package computes it.

A NumPy background runs on `device=` (the CUDA card unless the caller names
another) and comes back as float64 NumPy; a tensor background stays on its
device and comes back as a float32 tensor.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from enum import Enum
from functools import lru_cache

import numpy as np
import torch

from ..core.channels import Channel
from ..typing import Float64Array
from ..utils import resolve_device

__all__ = ["BlendMode", "Layer", "create_overlay", "overlay_channels"]


class BlendMode(Enum):
    """Compositing rule for putting one layer onto the canvas.

    ``ALPHA`` is the classic "over" operator — each layer partially replaces
    what is underneath it, so the stacking order of layers is significant.
    ``ADDITIVE`` sums light instead of replacing it (then clips to [0, 1]),
    which matches the physics of fluorescence imaging where every fluorophore
    emits independently; with this mode the layer order is irrelevant.
    """

    ALPHA = "alpha"
    ADDITIVE = "additive"


def _hex_to_rgb(color: str) -> tuple[float, float, float]:
    hex_color = color.lstrip("#")
    if len(hex_color) == 3:
        hex_color = "".join(c * 2 for c in hex_color)
    return tuple(int(hex_color[i : i + 2], 16) / 255.0 for i in (0, 2, 4))  # type: ignore


def _clipped_unit_range(values, what: str):
    """Warn when *values* (a NumPy array or a tensor) stray outside [0, 1]
    and clip them back in, keeping their type."""
    if isinstance(values, torch.Tensor):
        lo, hi = (float(v) for v in torch.aminmax(values))
    else:
        lo, hi = float(values.min()), float(values.max())
    if lo < 0.0 or hi > 1.0:
        warnings.warn(
            f"{what} outside [0, 1] (min={lo:.4g}, max={hi:.4g}). Values will "
            f"be clipped, which may indicate missing normalization.",
            stacklevel=3,
        )
        values = values.clamp(0.0, 1.0) if isinstance(values, torch.Tensor) else np.clip(
            values, 0.0, 1.0
        )
    return values


@dataclass
class Layer:
    """One channel's contribution to an overlay: intensities in [0, 1] plus
    the rendering knobs for that channel.

    ``zero_transparent=True`` ramps from fully transparent at zero intensity
    up to the channel color; ``False`` ramps from opaque black instead (a
    classic LUT look, no transparency). ``opacity`` scales the whole layer's
    alpha. Out-of-range intensities are clipped with a warning.
    """

    channel: Channel
    intensities: Float64Array | torch.Tensor
    opacity: float = 1.0
    zero_transparent: bool = True
    blend_mode: BlendMode = BlendMode.ALPHA

    def __post_init__(self) -> None:
        if self.intensities.ndim != 2:
            raise ValueError(f"Expected 2D intensities array, got shape {self.intensities.shape}")
        if not 0 <= self.opacity <= 1:
            raise ValueError(f"Opacity must be in [0, 1], got {self.opacity}")
        self.intensities = _clipped_unit_range(
            self.intensities, f"Layer '{self.channel.name}' has intensity values"
        )


class _TwoStopColormap:
    """Closed-form two-stop colormap: rgba(t) = lerp(anchor, color, t), for
    t clipped into [0, 1], in float32."""

    def __init__(self, color: str, zero_transparent: bool):
        self.color = color
        self.zero_transparent = zero_transparent
        r, g, b = _hex_to_rgb(color)
        if zero_transparent:
            self.start = (0.5, 0.5, 0.5, 0.0)
        else:
            self.start = (0.0, 0.0, 0.0, 1.0)
        self.stop = (r, g, b, 1.0)

    def __call__(self, intensities: torch.Tensor) -> torch.Tensor:
        t = intensities.to(torch.float32).clamp(0.0, 1.0)[..., None]
        start = torch.tensor(self.start, dtype=torch.float32, device=t.device)
        stop = torch.tensor(self.stop, dtype=torch.float32, device=t.device)
        return start + t * (stop - start)


@lru_cache(maxsize=64)
def _build_colormap(color: str, zero_transparent: bool) -> _TwoStopColormap:
    """Return the two-stop colormap for *color*, with LRU caching.

    When *zero_transparent* is True the zero-point is a fully-transparent
    neutral gray (0.5, 0.5, 0.5, 0); otherwise it is opaque black (0, 0, 0, 1),
    giving a classic LUT-style ramp (matching the reference's anchors).
    """
    return _TwoStopColormap(color, zero_transparent)


def _gray_to_rgb(image: torch.Tensor) -> torch.Tensor:
    """Broadcast a single-channel 2D image to (H, W, 3)."""
    return image[:, :, None].expand(-1, -1, 3)


def _blend_alpha(background, foreground, alpha):
    """Porter-Duff 'over' compositing."""
    return (alpha * foreground + (1 - alpha) * background).clamp(0.0, 1.0)


def _blend_additive(background, foreground, alpha):
    """Additive (screen-like) compositing - contributions accumulate."""
    return (background + alpha * foreground).clamp(0.0, 1.0)


def _composite(background, foreground, alpha, mode: BlendMode):
    """Composite *foreground* onto *background* using the given blend mode."""
    if mode is BlendMode.ADDITIVE:
        return _blend_additive(background, foreground, alpha)
    return _blend_alpha(background, foreground, alpha)


def overlay_channels(
    background: Float64Array | torch.Tensor,
    channel_intensities: dict[Channel, Float64Array | torch.Tensor],
    *,
    opacity: float = 1.0,
    zero_transparent: bool = True,
    blend_mode: BlendMode = BlendMode.ALPHA,
    device: str | torch.device | None = None,
) -> Float64Array | torch.Tensor:
    """Composite every channel onto *background* with shared settings.

    Thin wrapper that wraps each (channel, intensities) pair in a
    :class:`Layer` with the same opacity / transparency / blend mode and
    hands the stack to :func:`create_overlay`; build the Layer list yourself
    when channels need individual settings.
    """
    layers = [
        Layer(channel, intensities, opacity, zero_transparent, blend_mode)
        for channel, intensities in channel_intensities.items()
    ]
    return create_overlay(background, layers, device=device)


def create_overlay(
    background: Float64Array | torch.Tensor,
    layers: list[Layer],
    device: str | torch.device | None = None,
) -> Float64Array | torch.Tensor:
    """Render *layers* onto a 2D grayscale background, returning (H, W, 3).

    A NumPy background is rendered on `device` (None means the CUDA card,
    and raises when there is none) and comes back as float64 NumPy; a
    tensor background is rendered on its own device and stays there. Raises
    ValueError for a non-2D background or a layer whose shape disagrees with
    it; out-of-range background values are clipped with a warning.
    """
    if background.ndim != 2:
        raise ValueError(f"Expected 2D background array, got shape {background.shape}")

    background = _clipped_unit_range(background, "Background has values")

    mismatched = [l for l in layers if tuple(l.intensities.shape) != tuple(background.shape)]
    if mismatched:
        bad = mismatched[0]
        raise ValueError(
            f"Layer '{bad.channel.name}' has shape {tuple(bad.intensities.shape)}, "
            f"but background has shape {tuple(background.shape)}."
        )

    on_host = isinstance(background, np.ndarray)
    dev = resolve_device(device) if on_host else background.device

    def upload(x) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        return x.to(device=dev, dtype=torch.float32)

    canvas = _gray_to_rgb(upload(background).clamp(0.0, 1.0))
    for layer in layers:
        rgba = _build_colormap(layer.channel.color, bool(layer.zero_transparent))(
            upload(layer.intensities)
        )
        alpha = float(layer.opacity) * rgba[..., 3:4]
        canvas = _composite(canvas, rgba[..., :3], alpha, layer.blend_mode)
    canvas = canvas.contiguous()

    if on_host:
        return canvas.cpu().numpy().astype(np.float64)
    return canvas
