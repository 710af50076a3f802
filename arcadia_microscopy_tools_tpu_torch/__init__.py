"""arcadia_microscopy_tools_tpu_torch: the PyTorch / CUDA port of
arcadia_microscopy_tools_tpu.

This package runs the classical plate path - DoG, percentile rescale and a
histogram threshold, two-phase connected components, foreground compaction,
per-cell measurement - in PyTorch, with the connected-components tile
sweeps as hand-written CUDA kernels for Hopper (`csrc/cc_local.cu`). Entry
points run on the CUDA card unless the caller passes `device="cpu"`; on CPU
tensors the kernels' plain PyTorch versions run instead.

The layout mirrors the JAX package (`core/`, `ops/`, `parallel/`). The
package imports neither JAX nor the JAX package.
"""

from .core.channels import Channel
from .core.microplate import MicroplateLayout
from .exceptions import MetadataWarning, SegmentationWarning
from .ops.fused import fused_classical_mask
from .ops.labeling import component_roots, label
from .ops.regionprops import measure_compacted
from .parallel.plate import PlateResults, PlateRunConfig, PlateRunner

__version__ = "0.4.0"

__all__ = [
    "Channel",
    "MetadataWarning",
    "MicroplateLayout",
    "PlateResults",
    "PlateRunConfig",
    "PlateRunner",
    "SegmentationWarning",
    "component_roots",
    "fused_classical_mask",
    "label",
    "measure_compacted",
]
