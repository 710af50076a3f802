"""Host milliseconds per image of `SegmentationModel._prepare_image` (the
float32 cast, the percentile stretch, the pad): the model's `stages` counter
of its `segment.prepare` range, over every image the model prepared, the
warm-up's included. None where the model keeps no such counter."""


def read(run):
    stages = getattr(getattr(run.entry, "model", None), "stages", None)
    if stages is None or not stages.counts.get("segment.prepare"):
        return None
    return stages.totals["segment.prepare"] * 1e3 / stages.counts["segment.prepare"]
