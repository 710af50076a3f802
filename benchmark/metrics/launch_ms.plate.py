"""Host milliseconds per well that the runner's main thread spends in its
`plate.launch` range, where it builds and enqueues the well program, with
the program's own host waits: its `timings["launch_s"]` counter, over the
window. None where the runner has no such counter."""


def read(run):
    if not run.done or "launch_s" not in run.timings:
        return None
    return run.timings["launch_s"] * 1e3 / run.done
