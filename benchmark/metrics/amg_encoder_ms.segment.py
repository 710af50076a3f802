"""Host milliseconds per field of SAM's image encoder: the model's
`segment.encoder` span (one per micro-batch of images, closed only once its
embeddings are done) over its `segment.encoder.images` counter, over the
window's calls (the entry starts the counters after its warm-up). None where
the model keeps no such counter."""


def read(run):
    stages = getattr(getattr(run.entry, "model", None), "stages", None)
    if stages is None or not stages.counts.get("segment.encoder.images"):
        return None
    return stages.totals["segment.encoder"] * 1e3 / stages.counts["segment.encoder.images"]
