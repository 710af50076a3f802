"""SAM's windowed attention against its roofline in the traced call, in %:
the benchmark's bound of every windowed block's attention
(`sam_amg_arithmetic.attention_bound_s`: the 4096 real tokens in 25
windows of 196 keys, bytes bound at the published sizes, 10.0 us per field
and block) for the fields
the call finished, over the device time of the kernels that run it: kernel
8's window form by its name, and any library attention (flash, fmha, SDPA
kernels), which cannot be told apart from a global block's and so counts in
both this share and the global one."""

from benchmark import sam_amg_arithmetic

OURS = r"sam_window_kernel"
LIBRARY = [r"fmha", r"flash", r"scaled_dot_product", r"efficient_attention"]


def read(run):
    t = run.trace
    if (t is None or run.device.type != "cuda" or not run.traced_done
            or "window" not in run.config):
        return None
    seconds = t.op_seconds([OURS] + LIBRARY)
    if seconds <= 0:
        return None
    windowed, _ = sam_amg_arithmetic.blocks(run.config)
    bound = run.traced_done * windowed * sam_amg_arithmetic.attention_bound_s(run.config, True)
    return 100.0 * bound / seconds
