"""One run of one cell: set-up, the measured window, the traced window's
reduction, the check against the plain reference, and the result line.

`run_cell` takes the device and everything else as arguments, so the CPU
tests drive it at a small size with the kernels' plain versions; `run.py`
refuses to start without a CUDA card and calls it on the card.
"""

from __future__ import annotations

import gc
import math
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from benchmark import devtrace, manifest
from benchmark import traffic as gen

# top-level module names that may not be loaded in a run: JAX and the JAX
# package the port was made from (compared whole: the port's own name
# begins with the JAX package's)
FORBIDDEN_MODULES = {"jax", "jaxlib", "flax", "arcadia_microscopy_tools_tpu"}


@dataclass
class Run:
    """What the metric readers read: the run's clocks, counts, the runner's
    own timings, the traced window and the entry that served the cell."""

    device: torch.device
    config: dict
    traffic: dict
    entry: object
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    done: int = 0
    timings: dict = field(default_factory=dict)
    trace: devtrace.DeviceTrace | None = None
    traced_done: int = 0
    workdir: Path | None = None  # the run's own directory under $TMPDIR


class _GcClock:
    """A `gc.callbacks` entry that adds up the host time of collections."""

    def __init__(self):
        self.seconds, self.collections, self._t = 0.0, 0, 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t
            self.collections += 1


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN_MODULES)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _read(metrics: list[dict], run: Run, root: Path) -> dict:
    out = {}
    for m in metrics:
        value = manifest.load_module("metrics", m["name"], root).read(run)
        if value is not None:  # a reader that finds nothing to read returns None
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Whether the compared numbers are each within their limit: the
    comparison that decides `correct` once every answer came back."""
    return set(numbers) == set(limits) and all(
        math.isfinite(v) and v <= limits[k] for k, v in numbers.items())


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device: torch.device,
             started: float, bench: dict | None = None, traffic: dict | None = None,
             root: Path = manifest.HERE) -> dict:
    """Run one cell; returns its result line, the compared numbers with
    their limits last, under `checks`.

    `started` is the host clock (time.perf_counter) at process start, from
    which `setup_s` counts; `bench` and `traffic` replace BENCHMARK.json and
    the cell's traffic file (the tests shrink the traffic)."""
    bench = bench or manifest.load()
    cell = manifest.cell(bench, cell_name)
    config = manifest.config(bench, cell["config"])
    traffic = traffic or manifest.traffic(cell["traffic"], root)
    entry_mod = manifest.load_module("entries", traffic["entry"], root)
    reference = manifest.load_module("references", config["reference"][traffic["entry"]], root)

    with tempfile.TemporaryDirectory(prefix="bench_") as tmp:  # under $TMPDIR
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t_pool = time.perf_counter()
        pool = gen.make_pool(traffic, seed, device)
        t_entry = time.perf_counter()
        entry = entry_mod.Entry(config, traffic, pool, device, Path(tmp))
        _sync(device)
        print(f"setup: imports {t_pool - started:.2f} s, inputs {t_entry - t_pool:.2f} s, "
              f"entry and warm-up {time.perf_counter() - t_entry:.2f} s", file=sys.stderr)
        run = Run(device=device, config=config, traffic=traffic, entry=entry, workdir=Path(tmp))

        gc_spent = _GcClock()
        gc.callbacks.append(gc_spent)
        t0 = time.perf_counter()
        run.setup_s = t0 - started
        steps = []
        while True:
            if trace and run.trace is None:
                (a, d), run.trace = devtrace.profiled(entry.step, device, Path(tmp))
                run.traced_done = d
            else:
                a, d = entry.step()
            run.attempted += a
            run.done += d
            steps.append(time.perf_counter() - t0)
            if steps[-1] >= seconds:
                break
        _sync(device)
        run.window_s = time.perf_counter() - t0
        gc.callbacks.remove(gc_spent)
        print("window: step ends at " + " ".join(f"{t:.3f}" for t in steps) + " s; "
              f"{gc_spent.collections} garbage collections took {gc_spent.seconds:.3f} s",
              file=sys.stderr)
        run.timings = dict(entry.timings)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

        kind = "per_layer" if trace else "end_to_end"
        metrics = _read(manifest.metrics(bench, cell_name, kind), run, root)

        outputs = entry.outputs()
        entry.close()
        run.entry = entry = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        refs = reference.reference_outputs(pool, config, device)
        numbers = reference.compare(outputs, refs, pool, config, device)

    limits = config["limits"][traffic["entry"]]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    failed = run.attempted - run.done
    correct = run.done > 0 and failed == 0 and judge(numbers, limits)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    line = {"correct": bool(correct), "attempted": run.attempted, "failed": failed,
            "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = checks
    return line
