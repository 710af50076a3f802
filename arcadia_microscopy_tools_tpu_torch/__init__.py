"""arcadia_microscopy_tools_tpu_torch: the PyTorch / CUDA port of
arcadia_microscopy_tools_tpu.

This package runs these paths in PyTorch:

- ND2 ingest: `load_nd2` and `MicroscopyImage.from_nd2_path` (host code,
  with the repository's C++ planarize where `_native.build()` built it);
- Leica LIF ingest: `list_image_names`, `load_lif_image` and
  `MicroscopyImage.from_lif_path` (host code);
- the plate runner, `PlateRunner.run` from wells to per-cell tables, by
  either method: "classical" - DoG, percentile rescale and a histogram
  threshold, two-phase connected components, foreground compaction,
  per-cell measurement - with the connected-components tile sweeps as
  hand-written CUDA kernels for Hopper (`csrc/cc_local.cu`); or "unet" -
  the U-Net forward and mask reconstruction in the compact domain, measured
  directly on the listed pixels;
- the deep segmentation path, `SegmentationModel.segment` /
  `batch_segment` - U-Net forward, flow tracking and flow-error QC - with the
  fused 3x3 conv (`csrc/conv3x3_fused.cu`), GroupNorm moments
  (`csrc/gn_moments.cu`) and QC diffusion (`csrc/diffuse.cu`) as CUDA
  kernels, and the CC kernels again in the sink labeling;
- the preprocessing and classical-segmentation ops composed by `Pipeline`
  of `ImageOperation`s - Gaussian, median and rank filters, rolling ball,
  global and local thresholds, binary morphology, labeling - with the
  rank selection of median / rank filters over windows above 9 as a CUDA
  kernel (`csrc/rank_select.cu`);
- per-cell analysis of a user's mask, `masks.SegmentationMask` - labeling
  with the CC kernels, border clearing, relabeling, and the morphology and
  intensity measurements on the device; outlines, hulls and moments on the
  host (`measure.py`);
- fluorescence overlays, `create_overlay` and `overlay_channels`, as
  float32 tensor arithmetic on the device;
- the U-Net trainer, `models.train` (`python -m
  arcadia_microscopy_tools_tpu_torch.models.train`): synthetic batches,
  flow targets on the QC diffusion kernel, and a differentiable PyTorch
  forward under autograd.

Entry points run on the CUDA card unless the caller passes `device="cpu"`;
on CPU tensors the kernels' plain PyTorch versions run instead.

The layout mirrors the JAX package (`core/`, `ops/`, `models/`,
`parallel/`). The package imports neither JAX nor the JAX package.
"""

from .core.channels import Channel
from .core.microplate import MicroplateLayout
from .core.microscopy import MicroscopyImage
from .exceptions import MetadataWarning, SegmentationWarning
from .models.segmentation import SegmentationModel
from .ops.fused import fused_classical_mask
from .ops.labeling import component_roots, label
from .ops.pipeline import ImageOperation, Pipeline
from .ops.regionprops import measure_compacted
from .parallel.plate import PlateResults, PlateRunConfig, PlateRunner
from .viz.blending import BlendMode, Layer, create_overlay, overlay_channels

__version__ = "0.4.0"

__all__ = [
    "BlendMode",
    "Channel",
    "ImageOperation",
    "Layer",
    "MetadataWarning",
    "MicroplateLayout",
    "MicroscopyImage",
    "Pipeline",
    "PlateResults",
    "PlateRunConfig",
    "PlateRunner",
    "SegmentationModel",
    "SegmentationWarning",
    "component_roots",
    "create_overlay",
    "fused_classical_mask",
    "label",
    "measure_compacted",
    "overlay_channels",
]
