"""The comparison that decides `correct`, on the CPU at a tiny size: the
program passes it, each control (the reference with one stage one
precision step below, in the program's place) fails it, and so does the timed path broken each way
a plate can break: the same answer for every batch (its state unchanged),
half of each batch left out, an answer altered where it is produced. The
harness runs end to end (set-up, window, reference, comparison) with only
its look for a card skipped; ND2 cells decode from files it writes (the
ND2 cell is held out of BENCHMARK.json, and tested from `benchmark/held/`)."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness, manifest
from benchmark.control import readings

from conftest import tiny_traffic, with_held

PLATE_CELLS = [("classical_plate_mem", "plate_mem"), ("classical_plate_nd2", "plate_nd2"),
               ("unet_plate_mem", "plate_mem")]
SEGMENT_CELL = ("unet_segment", "segment_mem")
CPU = torch.device("cpu")


def _bench():
    return with_held(manifest.load())


def _limits(cell):
    b = _bench()
    w = manifest.cell(b, cell)
    return manifest.config(b, w["config"])["limits"][manifest.traffic(w["traffic"])["entry"]]


def _run(cell, traffic, seed=5):
    return harness.run_cell(cell, seed, 0.0, False, CPU, time.perf_counter(), bench=_bench(),
                            traffic=tiny_traffic(traffic))


@pytest.mark.parametrize("cell,traffic", PLATE_CELLS + [SEGMENT_CELL])
def test_program_is_correct(cell, traffic):
    line = _run(cell, traffic)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 8 and line["failed"] == 0
    assert list(line)[-1] == "checks"


def _controls():
    out = []
    for cell, traffic in [c for c in PLATE_CELLS if "nd2" not in c[0]] + [SEGMENT_CELL]:
        b = manifest.load()
        config = manifest.config(b, manifest.cell(b, cell)["config"])
        ref = manifest.load_module("references",
                                   config["reference"][manifest.traffic(traffic)["entry"]])
        out += [(cell, traffic, name) for name in ref.CONTROLS]
    return out


@pytest.mark.parametrize("cell,traffic,control", _controls())
def test_control_fails(cell, traffic, control):
    got = readings(cell, 7, False, CPU, traffic=tiny_traffic(traffic, size=256, blobs=16),
                   controls=[control])
    numbers = got["control"][control]
    assert not numbers.pop("correct"), got
    limits = _limits(cell)
    assert any(v > limits[k] for k, v in numbers.items()), got


def _faulty(kind):
    """A well-program factory whose programs break the way `kind` says."""
    from arcadia_microscopy_tools_tpu_torch.parallel import plate

    build = plate._build_well_program
    first = {}

    def factory(*args, **kwargs):
        program = build(*args, **kwargs)

        def broken(img):
            packed, health = program(img)[:2]
            if kind == "unchanged":  # every batch gets the first batch's answer
                first.setdefault("out", (packed.clone(), health.clone()))
                packed, health = first["out"]
            elif kind == "half":  # the second half of the batch is never computed
                n, h = packed.shape[0], packed.shape[0] // 2
                packed = torch.cat([packed[:h], packed[: n - h]])
                health = torch.cat([health[:h], health[: n - h]])
            elif kind == "altered":  # one column of every cell altered as it is produced
                packed = packed.clone()
                packed[..., 3] += 0.75  # centroid_y
            return packed, health

        return broken

    return factory


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell,traffic", PLATE_CELLS)
def test_faults_fail(cell, traffic, kind, monkeypatch):
    from arcadia_microscopy_tools_tpu_torch.parallel import plate

    monkeypatch.setattr(plate, "_build_well_program", _faulty(kind))
    line = _run(cell, traffic)
    assert not line["correct"], line["checks"]


def _faulty_labels(kind):
    """A `SegmentationModel._labels_of` whose masks break the way `kind` says."""
    from arcadia_microscopy_tools_tpu_torch.models.segmentation import SegmentationModel

    labels_of = SegmentationModel._labels_of
    first = {}

    def broken(self, images, params):
        labels = labels_of(self, images, params)
        if kind == "unchanged":  # every call gets the first call's masks
            return first.setdefault("out", labels)
        if kind == "half":  # the second half of the call is never computed
            h = len(labels) // 2
            return list(labels[:h]) + list(labels[: len(labels) - h])
        return [np.roll(m, 1, axis=0) for m in labels]  # each mask altered as produced

    return broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_segment_faults_fail(kind, monkeypatch):
    from arcadia_microscopy_tools_tpu_torch.models.segmentation import SegmentationModel

    monkeypatch.setattr(SegmentationModel, "_labels_of", _faulty_labels(kind))
    line = _run(*SEGMENT_CELL)
    assert not line["correct"], line["checks"]
