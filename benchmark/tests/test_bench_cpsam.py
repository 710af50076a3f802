"""The Cellpose-SAM cell (`cpsam_segment`) on the CPU at a tiny size: the
program passes the comparison, the float8 forward control fails it, and so
do three faults of the timed path (the relative-position bias dropped, the
taper replaced by a flat mean, one tile's maps copied from its neighbour),
each by `map_gap`, and three of the mask tail (the flow-error QC skipped,
by `mask_gap`; the masks moved down a row, by `centroid_gap`; the masks
eroded, by `mask_gap`). The configuration keeps the 256-pixel tile, where the
taper matters, and narrows the network (width 64, 1 head, 2 blocks, the
second with the stored 127-row tables); the images are 300 x 300 (2 x 2
tiles)."""

import copy
import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness, manifest, sam_arithmetic
from benchmark.control import readings

from conftest import tiny_traffic

CELL, TRAFFIC = "cpsam_segment", "segment_sam_mem"
CPU = torch.device("cpu")
TINY = dict(width=64, depth=2, heads=1, mlp=256, neck=16, global_blocks=[1])


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """BENCHMARK.json with the cell's configuration narrowed (a copy of its
    file), also as control.py loads it, and the program's Cellpose-SAM
    narrowed alike (its sizes are private: the published ones)."""
    from arcadia_microscopy_tools_tpu_torch.models import segmentation, vit_sam

    post_init = segmentation.SegmentationModel.__post_init__

    def narrowed(self, network):
        post_init(self, network)
        self._sam_config = vit_sam.SamConfig(**{**TINY, "global_blocks": tuple(TINY["global_blocks"])})

    monkeypatch.setattr(segmentation.SegmentationModel, "__post_init__", narrowed)
    bench = manifest.load()
    entry = next(c for c in bench["configs"] if c["name"] == "cellpose_sam")
    cfg = json.loads((manifest.REPO / entry["file"]).read_text())
    cfg.update(TINY)
    path = tmp_path / "cellpose_sam_tiny.json"
    path.write_text(json.dumps(cfg))
    bench = copy.deepcopy(bench)
    next(c for c in bench["configs"] if c["name"] == "cellpose_sam")["file"] = str(path)
    monkeypatch.setattr(manifest, "load", lambda path=None: bench)
    return bench


def _traffic():
    return tiny_traffic(TRAFFIC, size=300, blobs=6, pool=3)


def _run(bench, trace=False):
    return harness.run_cell(CELL, 5, 0.0, trace, CPU, time.perf_counter(), bench=bench,
                            traffic=_traffic())


def test_program_is_correct(tiny_bench):
    line = _run(tiny_bench, trace=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] == 8 and line["failed"] == 0
    assert set(line["checks"]) == {"map_gap", "mask_gap", "centroid_gap"}
    # the span readers read the traced run; the device readers find no card
    assert line["metrics"]["sam_encoder_ms.segment"]["value"] > 0
    assert line["metrics"]["segment_prep_ms.segment"]["value"] > 0
    assert "sam_mfu.segment" not in line["metrics"]


def test_float8_forward_control_fails(tiny_bench):
    got = readings(CELL, 7, False, CPU, traffic=_traffic(), controls=["forward"])
    numbers = got["control"]["forward"]
    assert not numbers.pop("correct"), got
    limits = manifest.config(tiny_bench, "cellpose_sam")["limits"]["segment_sam"]
    assert numbers["map_gap"] > limits["map_gap"], got


def _faults():
    from arcadia_microscopy_tools_tpu_torch.models import segmentation, vit_sam

    real_attention, real_blend = vit_sam.sam_attention, segmentation.average_tiles

    def no_bias(qkv, rh, rw, heads, grid):
        return real_attention(qkv, torch.zeros_like(rh), torch.zeros_like(rw), heads, grid)

    def flat(y, n, h, w, *a, **kw):
        return real_blend(y, n, h, w, *a, **kw) * 0 + _mean_of_tiles(y, n, h, w)

    def copied(y, n, h, w, *a, **kw):
        y = y.clone()
        y[1] = y[0]  # the second tile's maps are its left neighbour's
        return real_blend(y, n, h, w, *a, **kw)

    return {"bias dropped": (vit_sam, "sam_attention", no_bias),
            "flat taper": (segmentation, "average_tiles", flat),
            "tile copied": (segmentation, "average_tiles", copied)}


def _mean_of_tiles(y, n, h, w):
    from arcadia_microscopy_tools_tpu_torch.models.sam_tiles import tile_starts

    _, c, b, _ = y.shape
    ys, xs = tile_starts(h, b), tile_starts(w, b)
    y = y.view(n, len(ys), len(xs), c, b, b)
    total = torch.zeros((n, c, h, w))
    count = torch.zeros((h, w))
    for j, y0 in enumerate(ys):
        for i, x0 in enumerate(xs):
            total[..., y0 : y0 + b, x0 : x0 + b] += y[:, j, i]
            count[y0 : y0 + b, x0 : x0 + b] += 1
    return total / count


@pytest.mark.parametrize("fault", ["bias dropped", "flat taper", "tile copied"])
def test_faults_fail_map_gap(tiny_bench, fault, monkeypatch):
    module, name, broken = _faults()[fault]
    monkeypatch.setattr(module, name, broken)
    line = _run(tiny_bench)
    assert not line["correct"], line["checks"]
    assert line["checks"]["map_gap"]["value"] > line["checks"]["map_gap"]["limit"]


def test_readers_find_nothing_without_the_program():
    """A program without the encoder's span, or a run with no card, reads
    None (what the parent of the Cellpose-SAM port gives)."""
    for name in ("sam_encoder_ms.segment", "sam_mfu.segment", "sam_attention_roofline.segment"):
        read = manifest.load_module("metrics", name).read
        run = SimpleNamespace(entry=SimpleNamespace(model=SimpleNamespace()), trace=None,
                              device=CPU, traced_done=8, config={}, traffic={})
        assert read(run) is None


def test_sam_arithmetic():
    cfg = manifest.config(manifest.load(), "cellpose_sam")
    # 0.727e12 per 256^2 tile: per block 25.77e9 of projections and MLP,
    # 4.295e9 of Q K^T and P V, 0.134e9 of relative-position terms
    assert abs(sam_arithmetic.tile_flop(cfg) / 1e12 - 0.72702) < 1e-5
    assert abs(sam_arithmetic.attention_flop(cfg) / 1e9 - 4.4292) < 1e-4
    assert sam_arithmetic.tiles_per_image(2048, 2048, cfg) == 100
    assert sam_arithmetic.tiles_per_image(200, 300, cfg) == 2
    # the attention is bound by operations: 4.478 us per tile and block,
    # 86.0 ms for a call of 8 images
    bound = sam_arithmetic.attention_bound_s(cfg)
    assert abs(bound * 1e6 - 4.4784) < 1e-3
    assert sam_arithmetic.attention_bytes(cfg) / 3.35e12 < bound
    assert abs(800 * cfg["depth"] * bound * 1e3 - 85.99) < 0.01


def test_skipped_qc_fails_mask_gap(tiny_bench, monkeypatch):
    from arcadia_microscopy_tools_tpu_torch.models import segmentation

    real = segmentation.compute_masks

    def no_qc(*args, **kwargs):
        return real(*args, **{**kwargs, "flow_threshold": 0.0})

    monkeypatch.setattr(segmentation, "compute_masks", no_qc)
    line = _run(tiny_bench)
    assert not line["correct"], line["checks"]
    assert line["checks"]["mask_gap"]["value"] > line["checks"]["mask_gap"]["limit"]


def _faulty_labels(kind):
    """A `SegmentationModel._labels_of` whose masks carry the reference
    module's planted fault `kind` (None: unchanged)."""
    from arcadia_microscopy_tools_tpu_torch.models.segmentation import SegmentationModel

    fault = manifest.load_module("references", "cpsam").FAULTS.get(kind, lambda m: m)
    labels_of = SegmentationModel._labels_of

    def broken(self, x, params, with_flows=False):
        got = labels_of(self, x, params, with_flows)
        labels, maps = got if with_flows else (got, None)
        labels = np.stack([fault(m) for m in labels])
        return (labels, maps) if with_flows else labels

    return broken


@pytest.mark.parametrize("kind, number", [(None, None), ("shifted", "centroid_gap"),
                                          ("eroded", "mask_gap")])
def test_mask_faults_fail(tiny_bench, kind, number, monkeypatch):
    """The QC leaves no cell of the tiny seeded maps (40-60 an image before
    it), so this runs with the QC off on both sides (flow threshold 0) to
    give the faults cells to move; unchanged, the program stays correct."""
    from arcadia_microscopy_tools_tpu_torch.models.segmentation import SegmentationModel

    entry = next(c for c in tiny_bench["configs"] if c["name"] == "cellpose_sam")
    cfg = json.loads(Path(entry["file"]).read_text())
    cfg["segment"]["flow_threshold"] = 0.0
    Path(entry["file"]).write_text(json.dumps(cfg))
    monkeypatch.setattr(SegmentationModel, "_labels_of", _faulty_labels(kind))
    line = _run(tiny_bench)
    if kind is None:
        assert line["correct"], line["checks"]
        return
    assert not line["correct"], line["checks"]
    assert line["checks"][number]["value"] > line["checks"][number]["limit"]
