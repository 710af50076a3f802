"""Blending facade (module parity with the JAX package's `blending.py`)."""

from .viz.blending import (  # noqa: F401 - test-visible helpers re-exported
    BlendMode,
    Layer,
    _blend_additive,
    _blend_alpha,
    _build_colormap,
    _composite,
    _gray_to_rgb,
    create_overlay,
    overlay_channels,
)

__all__ = ["BlendMode", "Layer", "create_overlay", "overlay_channels"]
