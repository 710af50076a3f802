"""The deep segmentation path: U-Net forward (models/unet.py) on the fused
conv and GroupNorm-moments kernels, flow tracking and flow-error QC
(models/flows.py) on the diffusion kernel, the `SegmentationModel`
wrapper, synthetic cell images (models/synthetic.py), and the trainer
(models/train.py, not imported here)."""

from .segmentation import SegmentationModel
from .synthetic import synthesize_cells

__all__ = ["SegmentationModel", "synthesize_cells"]
