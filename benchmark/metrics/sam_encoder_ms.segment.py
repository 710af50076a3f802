"""Host milliseconds per tile of Cellpose-SAM's encoder: the model's
`segment.encoder` span (one per micro-batch of tiles, closed only once its
maps are done, so its total is the encoder's time) over its
`segment.encoder.tiles` counter, over the window's calls (the entry starts
the counters after its warm-up). None where the model keeps no such span."""


def read(run):
    stages = getattr(getattr(run.entry, "model", None), "stages", None)
    if stages is None or not stages.counts.get("segment.encoder.tiles"):
        return None
    return stages.totals["segment.encoder"] * 1e3 / stages.counts["segment.encoder.tiles"]
