"""Share of the runner's dispatches over the window that were uploaded from
a page-locked staging slot a prefetch worker had filled: its
`timings["pinned_batches"]` over `timings["batches"]`. Batches of several
shapes and capacity retries are stacked on the main thread instead. None
where the runner has no such counters."""


def read(run):
    batches = run.timings.get("batches")
    if not batches or "pinned_batches" not in run.timings:
        return None
    return run.timings["pinned_batches"] / batches
