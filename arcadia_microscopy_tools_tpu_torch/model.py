"""Model facade (module parity with the JAX package's `model.py`)."""

import logging

from .models.segmentation import (
    SegmentationModel,
    SegmentationParams,
    find_best_available_device,
)

logger = logging.getLogger(__name__)

# Name kept for drop-in compatibility with reference call sites
CellposeParams = SegmentationParams

__all__ = ["SegmentationModel", "SegmentationParams", "find_best_available_device"]
