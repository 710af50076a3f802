"""The forward's 3x3 convs (widths 32-256, the 3-channel stem left out)
against their roofline in the traced plate, in %: the benchmark's bound
time of those convs for every batch of the plate, over the device time of
the kernels whose names match PATTERNS (the port's conv kernel and cuDNN /
CUTLASS convolutions, so the reading follows the convs whatever runs
them; a cuDNN stem adds its time too, so the share reads low, never high)."""

import math

from benchmark import arithmetic

PATTERNS = [r"conv3x3_kernel", r"amt_conv3x3", r"cudnn", r"cutlass.*conv", r"xmma_fprop",
            r"implicit_gemm", r"conv2d"]


def read(run):
    t = run.trace
    if t is None or run.device.type != "cuda" or not run.traced_done:
        return None
    conv_s = t.op_seconds(PATTERNS)
    if conv_s <= 0:
        return None
    well = run.traffic["well"]
    batch = run.entry.batch
    batches = math.ceil(run.traced_done / batch)
    bound = batches * arithmetic.conv3x3_bound_s(batch, well["height"],
                                                 tuple(run.config["base_channels"]))
    return 100.0 * bound / conv_s
