"""Ingest layer: the from-scratch ND2 and LIF readers, their metadata
parsers, and the tile feed (counterpart of the JAX package's `io/`)."""

from .leica import list_image_names, load_lif_image
from .nikon import load_nd2

__all__ = ["list_image_names", "load_lif_image", "load_nd2"]
