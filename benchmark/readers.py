"""What several per-layer or end-to-end metrics read alike; each metric's
own file under `metrics/` names one of these as its `read`, or reads by
itself. Every reader returns None where it finds nothing to read."""

from __future__ import annotations

import torch

from benchmark import arithmetic, devtrace


def rate(run):
    """Units whose answers came back over the whole window: from its start
    to the end of the last step, steps back to back."""
    return run.done / run.window_s


def assemble_ms(run):
    """Host milliseconds per well that the runner spends turning read-back
    columns into tables (its own `assemble_s` counter), over the window."""
    if not run.done or "assemble_s" not in run.timings:
        return None
    return run.timings["assemble_s"] * 1e3 / run.done


def idle_share(run):
    """Share of the traced step in which no kernel, memcpy or memset ran on
    the card: 1 - the union of their intervals / the traced window."""
    t = run.trace
    if t is None or t.busy_s <= 0 or run.device.type != "cuda":
        return None
    return 1.0 - t.busy_s / t.window_s


def unet_mfu(run):
    """The traced step's share of the card's bf16 peak, in %: the U-Net
    forward's model operations (the benchmark's own count from the widths
    and the well shape) for every well or image the step finished, over the
    traced window."""
    t = run.trace
    if t is None or run.device.type != "cuda" or not run.traced_done:
        return None
    well = run.traffic["well"]
    flop = arithmetic.unet_forward_flop(well["height"], well["width"],
                                        tuple(run.config["base_channels"]))
    return 100.0 * flop * run.traced_done / (t.window_s * arithmetic.H100_BF16_FLOP_PER_S)


def device_ms(run, fn, reps: int = 5, warmup: int = 2) -> float:
    """Device milliseconds per call of `fn`, from a `torch.profiler` trace of
    `reps` calls after `warmup`: the union of the kernel, memcpy and memset
    intervals they launch, so the host's waits inside a call do not count.
    Measured after the window, on its first batch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(run.device)

    def calls():
        for _ in range(reps):
            fn()

    _, trace = devtrace.profiled(calls, run.device, run.workdir)
    return trace.busy_s * 1e3 / reps
