"""Ingest layer: the from-scratch ND2 reader, its metadata parser, and the
tile feed (counterpart of the JAX package's `io/`; LIF is not ported yet)."""

from .nikon import load_nd2

__all__ = ["load_nd2"]
