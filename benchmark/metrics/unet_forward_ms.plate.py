"""Device milliseconds of the runner's U-Net forward on the window's first
batch, stretched as the runner stretches it: warmed, then the union of the
kernel and copy intervals of its calls in a profiler trace, after the
window."""

from benchmark.readers import device_ms


def read(run):
    if run.device.type != "cuda" or run.config["plate"]["method"] != "unet":
        return None
    import torch
    from arcadia_microscopy_tools_tpu_torch.parallel.plate import _normalised

    network = run.entry.runner.network
    seg = run.entry.staged_batch()[:, run.config["plate"]["seg_channel_index"]]
    x = _normalised(seg.to(torch.float32))[..., None].expand(-1, -1, -1, 3)
    return device_ms(run, lambda: network(x))
