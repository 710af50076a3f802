"""Cellpose-SAM's attention against its roofline in the traced call, in %:
the benchmark's bound of the attention of every block (`sam_arithmetic`:
operations of Q K^T, P V and the relative-position terms at the bf16 peak;
4.478 us per tile and block at the published sizes) for the tiles of the
images the call finished, over the device time of the kernels whose names
match PATTERNS (the port's kernel 8 and common attention kernels, so the
reading follows the same work whatever runs it)."""

from benchmark import sam_arithmetic

PATTERNS = [r"sam_attention", r"attention", r"fmha", r"flash"]


def read(run):
    t = run.trace
    if t is None or run.device.type != "cuda" or not run.traced_done or "tile" not in run.config:
        return None
    attn_s = t.op_seconds(PATTERNS)
    if attn_s <= 0:
        return None
    well = run.traffic["well"]
    tiles = run.traced_done * sam_arithmetic.tiles_per_image(well["height"], well["width"],
                                                             run.config)
    bound = tiles * run.config["depth"] * sam_arithmetic.attention_bound_s(run.config)
    return 100.0 * bound / attn_s
