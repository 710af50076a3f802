"""The traced call's share of the card's bf16 peak: the U-Net forward's
model operations (the benchmark's own count from the widths and the image
shape) for every image the call segmented, over the traced window, in %."""

from benchmark.readers import unet_mfu as read  # noqa: F401
