"""The deep segmentation path: U-Net forward (models/unet.py) on the fused
conv, GroupNorm-moments and block-tail kernels, flow tracking and flow-error QC
(models/flows.py) on the diffusion kernel, the `SegmentationModel`
wrapper, synthetic cell images (models/synthetic.py), the trainer
(models/train.py) and the space-to-depth forward (models/unet_s2d.py;
neither imported here). Cellpose-SAM (`SegmentationModel(network="cpsam")`)
is models/vit_sam.py on Cellpose's tiles (models/sam_tiles.py) with its
attention kernel (models/sam_attention.py).

The JAX package's functional U-Net names map to the `UNet` module:
`init_unet(key, config)` is `UNet(config, generator=...)` (its parameters
keep `init_unet`'s names), `apply_unet(params, x)` is `UNet.forward(x)`
(NHWC in and out), and `count_params(params)` is
`sum(p.numel() for p in net.parameters())`. `apply_unet_s2d(sparams, x,
config, out_s2d)` is `unet_s2d.UNetS2D(sparams, config)(x, out_s2d)`."""

from .flows import compute_masks, flow_error, follow_flows, masks_to_flows
from .segmentation import SegmentationModel, find_best_available_device
from .synthetic import synthesize_cells
from .unet import UNet, UNetConfig

__all__ = [
    "SegmentationModel",
    "UNet",
    "UNetConfig",
    "compute_masks",
    "find_best_available_device",
    "flow_error",
    "follow_flows",
    "masks_to_flows",
    "synthesize_cells",
]
