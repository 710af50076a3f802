"""A `torch.profiler` window over part of a run, reduced to what the
per-layer metrics and the result line read: the device's busy time (the
union of kernel, memcpy and memset intervals), the window's length, time by
kernel name, and the idle gaps (between busy spans, and before the first and
after the last) by what the host was doing: the innermost profiled CPU range
that encloses each gap's midpoint."""

from __future__ import annotations

import bisect
import json
import os
import re
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "python_function"}
NO_RANGE = "host outside any profiled op (Python, numpy, pandas)"


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    ops: dict[str, float] = field(default_factory=dict)  # seconds by device op name
    gaps: dict[str, float] = field(default_factory=dict)  # idle seconds by host range

    def op_seconds(self, patterns: list[str]) -> float:
        """Device seconds of the ops whose names match any regex of `patterns`."""
        rx = [re.compile(p) for p in patterns]
        return sum(s for name, s in self.ops.items() if any(r.search(name) for r in rx))

    def breakdown(self, top: int = 10) -> dict:
        def largest(d):
            return [[_short(k), v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": largest(self.ops), "idle_gaps": largest(self.gaps)}


def _short(name: str, limit: int = 160) -> str:
    """A kernel's name cut to `limit` characters (templated names run to
    thousands)."""
    return name if len(name) <= limit else name[: limit - 3] + "..."


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _innermost(starts: list[float], host: list[tuple[float, float, str]], t: float) -> str:
    """The enclosing host range that started last (the innermost, as ranges
    nest); a bounded look back, since ranges that ended before `t` lie in
    between."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 4096, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return NO_RANGE


def reduce_events(events: list[dict], window_s: float) -> DeviceTrace:
    """A chrome-trace event list (microseconds) -> DeviceTrace."""
    dev = [(e["name"], e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6) for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = sorted((e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6, e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS)
    trace = DeviceTrace(window_s=window_s, busy_s=0.0)
    for name, a, b in dev:
        trace.ops[name] = trace.ops.get(name, 0.0) + (b - a)
    busy = _union([(a, b) for _, a, b in dev])
    trace.busy_s = sum(b - a for a, b in busy)
    starts = [a for a, _, _ in host]
    # the gaps between busy spans, and before the first and after the last
    # one within the profiled host activity
    first = min([a for a, _, _ in host] + [a for _, a, _ in dev], default=0.0)
    last = max([b for _, b, _ in host] + [b for _, _, b in dev], default=0.0)
    edges = [(first, first)] + busy + [(last, last)]
    for (_, b0), (a1, _) in zip(edges, edges[1:]):
        if a1 > b0:
            label = _innermost(starts, host, (b0 + a1) / 2)
            trace.gaps[label] = trace.gaps.get(label, 0.0) + (a1 - b0)
    return trace


def profiled(fn, device: torch.device, workdir: Path):
    """Run `fn()` under `torch.profiler` and return (its result, DeviceTrace).
    The trace file goes to `workdir` and is deleted once read."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    path = Path(workdir) / "profile_trace.json"
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text()).get("traceEvents", [])
    finally:
        os.unlink(path)
    return out, reduce_events(events, window_s)
