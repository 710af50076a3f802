"""Pipeline facade (the JAX package's `pipeline.py`)."""

from .ops.pipeline import ImageOperation, Pipeline

__all__ = ["ImageOperation", "Pipeline"]
