"""The yardstick's arithmetic: the card's published peaks and the
operations and bytes of the work the rooflines and utilisations divide by.

Counted from the configuration's widths and the input shape alone, never
from how the program implements them, so that a change to the program
cannot move what it is measured against.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W
# limit; the result line carries the card's own limit beside them
H100_BF16_FLOP_PER_S = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


def unet_forward_shapes(height: int, width: int, widths=(32, 64, 128, 256), in_ch: int = 3):
    """Every 3x3 conv of one Cellpose-style U-Net forward on a height x width
    image: (name, C, Co, H, W). Each down level runs two convs, each up level
    one on the upsampled deeper features, one on the skip and one more."""
    convs = []
    h, w = height, width
    c_in = in_ch
    for i, co in enumerate(widths):
        convs.append((f"down{i}.conv1", c_in, co, h, w))
        convs.append((f"down{i}.conv2", co, co, h, w))
        c_in = co
        h, w = h // 2, w // 2
    for i, lv in enumerate(reversed(range(len(widths) - 1))):
        h, w = height >> lv, width >> lv
        c_up, co = widths[lv + 1], widths[lv]
        convs.append((f"up{i}.conv1_up", c_up, co, h, w))
        convs.append((f"up{i}.conv1_skip", co, co, h, w))
        convs.append((f"up{i}.conv2", co, co, h, w))
    return convs


def unet_forward_projections(height: int, width: int, widths=(32, 64, 128, 256),
                             in_ch: int = 3, out_ch: int = 3):
    """Every 1x1 conv of one forward: (name, C, Co, H, W). Each residual
    block projects its input to its width; the head maps the top width to
    the output maps."""
    convs = []
    c_in = in_ch
    for i, co in enumerate(widths):
        convs.append((f"down{i}.proj", c_in, co, height >> i, width >> i))
        c_in = co
    for i, lv in enumerate(reversed(range(len(widths) - 1))):
        convs.append((f"up{i}.proj", widths[lv + 1] + widths[lv], widths[lv], height >> lv,
                      width >> lv))
    convs.append(("head", widths[0], out_ch, height, width))
    return convs


def unet_forward_flop(height: int, width: int, widths=(32, 64, 128, 256), in_ch: int = 3,
                      out_ch: int = 3) -> float:
    """Model operations of one U-Net forward per image: 2 * 9 * C * Co per
    pixel of each 3x3 conv and 2 * C * Co per pixel of each 1x1 conv (the
    seven block projections and the head). The style vector's dense layers
    (under 3e5 operations) are left out."""
    flop = sum(2.0 * 9 * c * co * h * w for _, c, co, h, w in
               unet_forward_shapes(height, width, widths, in_ch))
    return flop + sum(2.0 * c * co * h * w for _, c, co, h, w in
                      unet_forward_projections(height, width, widths, in_ch, out_ch))


def conv3x3_calls(batch: int, size: int, widths=(32, 64, 128, 256)):
    """The 3x3 convs that the roofline of `conv3x3` covers, for a batch of
    size x size images: every conv of the forward but the 3-channel stem
    (which runs as a float32 matrix product): (name, C, Co, pixels, accum),
    where accum marks the skip conv that adds into the up conv's output."""
    calls = []
    for name, c, co, h, w in unet_forward_shapes(size, size, widths):
        if name == "down0.conv1":
            continue
        calls.append((name, c, co, batch * h * w, name.endswith("conv1_skip")))
    return calls


def conv3x3_bound_s(batch: int, size: int, widths=(32, 64, 128, 256)) -> float:
    """Least time of those convs on the card: per call the larger of bf16
    operations over the tensor-core peak and bytes over the memory rate,
    counting each input, accumulator and output byte once and the weights
    once."""
    total = 0.0
    for _, c, co, px, acc in conv3x3_calls(batch, size, widths):
        nbytes = 2 * px * (c + co + (co if acc else 0)) + 2 * 9 * c * co
        flop = 2 * 9 * c * co * px
        total += max(nbytes / H100_HBM_BYTES_PER_S, flop / H100_BF16_FLOP_PER_S)
    return total
