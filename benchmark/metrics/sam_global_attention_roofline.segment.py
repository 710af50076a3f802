"""SAM's global attention against its roofline in the traced call, in %:
the benchmark's bound of every global block's attention
(`sam_amg_arithmetic.attention_bound_s`: 4096 tokens, operations bound at
the published sizes, 70.6 us per field and block) for the fields the call
finished, over the device time of the kernels that run it: kernel 8's
64 x 64 instance by its name, and any library attention (flash, fmha, SDPA
kernels), which counts in both this share and the windowed one."""

from benchmark import sam_amg_arithmetic

OURS = r"sam_attention_kernel<64"
LIBRARY = [r"fmha", r"flash", r"scaled_dot_product", r"efficient_attention"]


def read(run):
    t = run.trace
    if (t is None or run.device.type != "cuda" or not run.traced_done
            or "window" not in run.config):
        return None
    seconds = t.op_seconds([OURS] + LIBRARY)
    if seconds <= 0:
        return None
    _, n_global = sam_amg_arithmetic.blocks(run.config)
    bound = run.traced_done * n_global * sam_amg_arithmetic.attention_bound_s(run.config, False)
    return 100.0 * bound / seconds
