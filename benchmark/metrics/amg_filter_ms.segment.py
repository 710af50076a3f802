"""Host milliseconds per prompt batch of the AMG's filters: the model's
`segment.amg_filter` span (the IoU filter, the upsampling of its survivors
to the field's size, the stability score and filter, the masks and boxes;
it waits for the device), total over calls, over the window's calls. None
where the model keeps no such span."""


def read(run):
    stages = getattr(getattr(run.entry, "model", None), "stages", None)
    if stages is None or not stages.counts.get("segment.amg_filter"):
        return None
    return stages.totals["segment.amg_filter"] * 1e3 / stages.counts["segment.amg_filter"]
