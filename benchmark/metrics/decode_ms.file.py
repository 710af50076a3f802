"""Wall milliseconds per well of ND2 decode on the runner's prefetch
threads (its own `decode_s` / `decode_wells` counters), over the window."""


def read(run):
    wells = run.timings.get("decode_wells", 0)
    return run.timings["decode_s"] * 1e3 / wells if wells else None
