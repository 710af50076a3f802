"""Device-busy milliseconds per well in the traced plate: the union of
kernel, memcpy and memset intervals over the wells that plate finished."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or not run.traced_done or run.device.type != "cuda":
        return None
    return t.busy_s * 1e3 / run.traced_done
