"""PyTorch port: the named host steps of `PlateRunner.run` and
`SegmentationModel.batch_segment` - their `StageTimer` counters and the
profiler ranges a trace of either shows."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu_torch import MicroplateLayout
from arcadia_microscopy_tools_tpu_torch.core.microplate import Well
from arcadia_microscopy_tools_tpu_torch.models.segmentation import SegmentationModel
from arcadia_microscopy_tools_tpu_torch.parallel import plate
from arcadia_microscopy_tools_tpu_torch.testing import synthetic_wells
from arcadia_microscopy_tools_tpu_torch.utils.profiling import device_trace

# one torch thread per test worker process (the suite runs several at once)
torch.set_num_threads(1)

RUN_KEYS = ("fetch_wait_s", "stage_s", "h2d_s", "launch_s", "readback_s", "gather_s",
            "assemble_s")
RUNNER_RANGES = {"plate.run", "plate.fetch_wait", "plate.stage", "plate.h2d", "plate.launch",
                 "plate.readback", "plate.gather", "plate.assemble", "well.measure",
                 "well.pack"}
METHOD_RANGES = {
    "classical": {"well.mask", "well.label", "well.compact"},
    "unet": {"well.forward", "well.masks"},
}


def _ranges(trace_dir) -> list[str]:
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("method", ["classical", "unet"])
@pytest.mark.parametrize("prefetch", [None, 0])
def test_plate_run_names_its_steps(method, prefetch, tmp_path):
    """Every main-thread step of a run is a float counter >= 0 in `timings`
    (and `device_s` is gone), and a range in a profiler trace of the run;
    the ranges of one batch carry its ordinal."""
    wells = synthetic_wells(3, 2, 96, 96, 4, seed=5)
    ids = ["A01", "A02", "A03"]
    config = plate.PlateRunConfig(method=method, max_cells=64, min_size=15, niter=20,
                                  batch_size=2)
    runner = plate.PlateRunner(config, device="cpu")
    with device_trace(tmp_path):
        results = runner.run(MicroplateLayout([Well(id=w) for w in ids]),
                             dict(zip(ids, wells)), prefetch=prefetch)
    assert results.failed_wells == []
    assert "device_s" not in results.timings
    for key in RUN_KEYS:
        assert isinstance(results.timings[key], float) and results.timings[key] >= 0, key
    assert results.timings["launch_s"] > 0 and results.timings["stage_s"] > 0
    names = _ranges(tmp_path)
    assert RUNNER_RANGES | METHOD_RANGES[method] <= set(names)
    assert names.count("plate.run") == 1
    assert names.count("plate.launch") == names.count("plate.readback") == 2  # 3 wells, batch 2
    for step in ("stage", "h2d", "launch", "readback"):
        assert {f"plate.{step} (batch {k})" for k in (0, 1)} <= set(names), step


def test_batch_segment_counts_its_steps(tmp_path):
    model = SegmentationModel(device="cpu", max_cells=64)
    images = list(synthetic_wells(3, 1, 64, 64, 2, seed=6)[:, 0].astype(np.float64))
    with device_trace(tmp_path):
        masks = model.batch_segment(images, num_iterations=10, batch_size=2,
                                    show_progress=False)
    assert all(m is not None and m.shape == (64, 64) for m in masks)
    counts = model.stages.counts
    assert counts["segment.prepare"] == 3 and counts["segment.finish"] == 3
    for step in ("stretch", "forward", "masks", "readback"):
        assert counts[f"segment.{step}"] == 2, step  # batches of 2 and 1
    assert "segment.upload" not in counts and "segment.prepare.host" not in counts
    assert set(_ranges(tmp_path)) >= {f"segment.{s}" for s in (
        "prepare", "stretch", "forward", "masks", "readback", "finish")}
    model.segment(images[0], num_iterations=10)
    assert model.stages.counts["segment.prepare"] == 4  # cumulative over the model's life
