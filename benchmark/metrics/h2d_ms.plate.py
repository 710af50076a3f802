"""Host milliseconds per well that the runner's main thread spends in its
`plate.h2d` range, where it copies each staged batch to the card
(`.to(device)`, which waits behind the stream's earlier work for pageable
memory): its `timings["h2d_s"]` counter, over the window. None where the
runner has no such counter."""


def read(run):
    if not run.done or "h2d_s" not in run.timings:
        return None
    return run.timings["h2d_s"] * 1e3 / run.done
