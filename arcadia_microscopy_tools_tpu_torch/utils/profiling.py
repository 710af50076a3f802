"""Tracing and profiling utilities.

Counterpart of `arcadia_microscopy_tools_tpu/utils/profiling.py`: a
per-stage wall-clock timer that can wait for the CUDA device, and a
`torch.profiler` trace of a block of work, written as a Chrome trace
(readable in Perfetto). Every stage of a `StageTimer` is also a named
`torch.profiler.record_function` range, so any profiler trace taken around
the program names its host time by stage; with no profiler active a range
costs only the profiler's check.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from collections.abc import Mapping
from dataclasses import dataclass, field
from pathlib import Path

import torch

logger = logging.getLogger(__name__)

__all__ = ["StageTimer", "device_trace"]


def _cuda_devices(obj) -> set[torch.device]:
    """The CUDA devices of every tensor in a nest of tensors, lists, tuples
    and mappings."""
    if isinstance(obj, torch.Tensor):
        return {obj.device} if obj.is_cuda else set()
    if isinstance(obj, Mapping):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return set().union(*(_cuda_devices(x) for x in obj))
    return set()


@dataclass
class StageTimer:
    """Accumulates wall-clock per named stage; waits for the device when
    asked.

    Usage:
        timer = StageTimer()
        with timer.stage("decode"):
            ...
        with timer.stage("device", block=result):   # waits for the card
            result = program(batch)
        print(timer.report())

    `block` is any tensor or nest of tensors (lists, tuples, mappings); at
    the end of the stage, each CUDA device they lie on is synchronised.

    Each stage is a `torch.profiler.record_function(name, args)` range that
    closes after that wait. `args` (a string, such as "batch 3") also names
    a zero-length range "name (args)" at the stage's start, which a Chrome
    trace shows (it drops a range's own args), so the stages of one item
    can be joined in the trace.
    """

    totals: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, block=None, args: str | None = None):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name, args):
            if args is not None:
                with torch.profiler.record_function(f"{name} ({args})"):
                    pass
            try:
                yield
            finally:
                for device in _cuda_devices(block):
                    torch.cuda.synchronize(device)
                dt = time.perf_counter() - t0
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:20s} {total:8.3f}s  ({n} calls, {total / n * 1e3:7.1f} ms/call)")
        return "\n".join(lines)

    def as_dict(self) -> dict[str, float]:
        return dict(self.totals)

    def dump(self, path: str | Path) -> None:
        payload = {"totals_s": self.totals, "counts": self.counts}
        Path(path).write_text(json.dumps(payload, indent=1))


@contextlib.contextmanager
def device_trace(log_dir: str | Path):
    """Capture a `torch.profiler` trace of the block (the CPU, and the CUDA
    device where there is one) into log_dir/trace.json, a Chrome trace that
    Perfetto reads.

    with device_trace("traces/run1"):
        program(batch)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))
    logger.info(f"torch.profiler trace written to {out / 'trace.json'}")
