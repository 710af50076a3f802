"""Host milliseconds per well that the runner's main thread spends in its
`plate.stage` range, where it stacks each batch's wells into one host
staging array (`np.stack`): its `timings["stage_s"]` counter, over the
window. None where the runner has no such counter."""


def read(run):
    if not run.done or "stage_s" not in run.timings:
        return None
    return run.timings["stage_s"] * 1e3 / run.done
