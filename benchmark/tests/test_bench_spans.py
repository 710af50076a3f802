"""The readers of the program's own spans (`stage_ms.plate`, `h2d_ms.plate`,
`launch_ms.plate`, `readback_ms.plate`, `segment_prep_ms.segment`): numbers
in a tiny traced CPU run of each cell that lists them, None where the
program keeps no such counter (a program from before the spans)."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, manifest

from conftest import tiny_traffic

SPAN_METRICS = {"stage_ms.plate": "stage_s", "h2d_ms.plate": "h2d_s",
                "launch_ms.plate": "launch_s", "readback_ms.plate": "readback_s",
                "segment_prep_ms.segment": None}
CELLS = [("classical_plate_mem", "plate_mem"), ("unet_plate_mem", "plate_mem"),
         ("unet_segment", "segment_mem")]


def _listed(cell):
    return {m["name"] for m in manifest.metrics(manifest.load(), cell, "per_layer")
            if m["name"] in SPAN_METRICS}


@pytest.mark.parametrize("cell,traffic", CELLS)
def test_span_metrics_read_a_traced_run(cell, traffic):
    want = _listed(cell)
    assert want  # every cell lists some of them
    line = harness.run_cell(cell, 5, 0.0, True, torch.device("cpu"), time.perf_counter(),
                            traffic=tiny_traffic(traffic))
    assert line["correct"], line["checks"]
    for name in want:
        value = line["metrics"][name]["value"]
        assert value > 0, (name, value)


def _run(timings=None, entry=None):
    return SimpleNamespace(done=16, timings=timings or {}, entry=entry)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metrics_find_nothing_without_the_counters(name):
    read = manifest.load_module("metrics", name).read
    # the counters of a runner without spans: `device_s` in their place
    old = {"decode_s": 0.0, "device_s": 1.0, "assemble_s": 0.1, "capacity_retries": 0.0}
    assert read(_run(old, SimpleNamespace(model=SimpleNamespace()))) is None
    assert read(_run()) is None


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metrics_arithmetic(name):
    from arcadia_microscopy_tools_tpu_torch.utils.profiling import StageTimer

    read = manifest.load_module("metrics", name).read
    key = SPAN_METRICS[name]
    if key is not None:  # seconds over the window per well
        assert read(_run({key: 0.032})) == pytest.approx(2.0)
    else:  # seconds per prepared image, over the model's life
        stages = StageTimer(totals={"segment.prepare": 1.2}, counts={"segment.prepare": 3})
        assert read(_run(entry=SimpleNamespace(model=SimpleNamespace(stages=stages)))) == (
            pytest.approx(400.0))
