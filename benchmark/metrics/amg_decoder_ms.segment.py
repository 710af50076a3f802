"""Host milliseconds per prompt batch of SAM's mask decoder (64 points, 192
candidate masks): the model's `segment.decoder` span, which waits for the
batch's logits, total over calls, over the window's calls. None where the
model keeps no such span."""


def read(run):
    stages = getattr(getattr(run.entry, "model", None), "stages", None)
    if stages is None or not stages.counts.get("segment.decoder"):
        return None
    return stages.totals["segment.decoder"] * 1e3 / stages.counts["segment.decoder"]
