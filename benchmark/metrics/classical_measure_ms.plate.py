"""Device milliseconds of the per-cell measurement
(`ops.regionprops.measure_compacted`) of the window's first batch, on that
batch's `component_roots` / `compact_by_root` outputs: warmed, then the
union of the kernel and copy intervals of its calls in a profiler trace,
after the window."""

import torch

from benchmark.readers import device_ms


def read(run):
    if run.device.type != "cuda" or run.config["plate"]["method"] != "classical":
        return None
    from arcadia_microscopy_tools_tpu_torch.ops.compaction import compact_by_root
    from arcadia_microscopy_tools_tpu_torch.ops.filters import to_float
    from arcadia_microscopy_tools_tpu_torch.ops.fused import fused_classical_mask
    from arcadia_microscopy_tools_tpu_torch.ops.labeling import component_roots
    from arcadia_microscopy_tools_tpu_torch.ops.regionprops import measure_compacted
    from arcadia_microscopy_tools_tpu_torch.parallel.plate import foreground_capacity

    cfg = run.config["plate"]
    plate_cfg = run.entry.plate_config
    batch = run.entry.staged_batch()
    h, w = batch.shape[-2:]
    mask = fused_classical_mask(
        to_float(batch[:, cfg["seg_channel_index"]]), low_sigma=cfg["low_sigma"],
        high_sigma=cfg["high_sigma"], percentile_range=tuple(run.config["percentile_range"]),
        method=cfg["threshold_method"])
    roots, _ = component_roots(mask, pair_cap=plate_cfg.pair_cap)
    comp = compact_by_root(roots, foreground_capacity(plate_cfg, h, w))
    stack = batch.to(torch.int32)  # as the well program widens the wells
    return device_ms(run, lambda: measure_compacted(comp.seg, comp.idx, roots, stack,
                                                    plate_cfg.max_cells, w))

