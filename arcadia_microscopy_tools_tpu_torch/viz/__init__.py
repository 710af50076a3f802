"""Visualization: fluorescence overlays and compositing."""

from .blending import BlendMode, Layer, create_overlay, overlay_channels

__all__ = ["BlendMode", "Layer", "create_overlay", "overlay_channels"]
