"""The deep segmentation path: U-Net forward (models/unet.py) on the fused
conv and GroupNorm-moments kernels, flow tracking and flow-error QC
(models/flows.py) on the diffusion kernel, and the `SegmentationModel`
wrapper."""
