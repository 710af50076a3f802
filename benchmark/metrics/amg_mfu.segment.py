"""The traced call's share of the card's bf16 peak, in %: Segment
Anything's model operations per field (`sam_amg_arithmetic.field_flop`:
the encoder and 1024 point prompts through the decoder, block 0's shared
image side once, 5.72e12 at the published sizes on a 2048 x 2048 field)
times the fields the call finished, over the traced window."""

from benchmark import sam_amg_arithmetic
from benchmark.arithmetic import H100_BF16_FLOP_PER_S


def read(run):
    t = run.trace
    if (t is None or run.device.type != "cuda" or not run.traced_done
            or "points_per_side" not in run.config):
        return None
    flop = sam_amg_arithmetic.field_flop(run.config) * run.traced_done
    return 100.0 * flop / (t.window_s * H100_BF16_FLOP_PER_S)
