"""The traced plate's share of the card's bf16 peak: the U-Net forward's
model operations (the benchmark's own count from the widths and the well
shape) for every well the plate finished, over the traced window, in %."""

from benchmark.readers import unet_mfu as read  # noqa: F401
