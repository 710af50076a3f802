"""The traced call's share of the card's bf16 peak, in %: Cellpose-SAM's
model operations per tile (`sam_arithmetic.tile_flop`, 0.727e12 at the
published sizes) times the tiles of the images the call finished (Cellpose's
tiling of the traffic's image shape, never the program's counter), over the
traced window."""

from benchmark import sam_arithmetic
from benchmark.arithmetic import H100_BF16_FLOP_PER_S


def read(run):
    t = run.trace
    if t is None or run.device.type != "cuda" or not run.traced_done or "tile" not in run.config:
        return None
    well = run.traffic["well"]
    tiles = run.traced_done * sam_arithmetic.tiles_per_image(well["height"], well["width"],
                                                             run.config)
    flop = sam_arithmetic.tile_flop(run.config) * tiles
    return 100.0 * flop / (t.window_s * H100_BF16_FLOP_PER_S)
