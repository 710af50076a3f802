"""Device milliseconds of the classical mask (DoG, percentile rescale,
threshold: `ops.fused.fused_classical_mask`) on the window's first batch,
staged as the runner stages it: warmed, then the union of the kernel and
copy intervals of its calls in a profiler trace, after the window."""

from benchmark.readers import device_ms


def read(run):
    if run.device.type != "cuda" or run.config["plate"]["method"] != "classical":
        return None
    from arcadia_microscopy_tools_tpu_torch.ops.filters import to_float
    from arcadia_microscopy_tools_tpu_torch.ops.fused import fused_classical_mask

    cfg = run.config["plate"]
    seg = to_float(run.entry.staged_batch()[:, cfg["seg_channel_index"]])
    return device_ms(run, lambda: fused_classical_mask(
        seg, low_sigma=cfg["low_sigma"], high_sigma=cfg["high_sigma"],
        percentile_range=tuple(run.config["percentile_range"]), method=cfg["threshold_method"]))
