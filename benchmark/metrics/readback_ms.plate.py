"""Host milliseconds per well that the runner's main thread spends in its
`plate.readback` range, where it waits for and copies each batch's packed
columns and health back to the host (`.cpu()`): its `timings["readback_s"]`
counter, over the window. None where the runner has no such counter."""


def read(run):
    if not run.done or "readback_s" not in run.timings:
        return None
    return run.timings["readback_s"] * 1e3 / run.done
