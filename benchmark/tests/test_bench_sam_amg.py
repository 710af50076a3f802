"""The SAM automatic-mask-generator cell (`sam_amg_segment`) on the CPU at a
tiny size: the program passes the comparison, the float8 forward control
fails it, and so does each planted fault of the network (the windows' pad
keys masked, block 0's self-attention given a residual: by the continuous
gaps) and of the filters (the IoU filter at 0.95: by `decision_gap`; every
second survivor dropped: by `filter_errors`); the tail's (NMS at 0.5, the painting order reversed) fail `compare`
by `mask_gap` on candidates whose masks overlap. The configuration keeps
every kind of part and narrows the encoder: width 64, 4 heads, 4 blocks
(block 2 global), patch 16 on a 256^2 input (a 16 x 16 grid; 3 x 3 windows
of 6 x 6 over the grid padded to 18 x 18), the neck to the decoder's width; the
decoder keeps its published sizes, whose 128 positional features the
seeded weights need for masks that lie around their points; 8 x 8 points in
batches of 32; the images are 320 x 320. `sam_amg_arithmetic`'s counts are
held against a hand count at a smaller size."""

import copy
import json
import time

import numpy as np
import pytest
import torch

from benchmark import harness, manifest, sam_amg_arithmetic
from benchmark.control import readings

from conftest import tiny_traffic

CELL, TRAFFIC = "sam_amg_segment", "segment_amg_mem"
CPU = torch.device("cpu")
TINY = dict(width=64, depth=4, heads=4, mlp=256, patch=16, image=256, window=6,
            global_blocks=[2], neck=256, points_per_side=8, points_per_batch=32)


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """BENCHMARK.json with the cell's configuration narrowed (a copy of its
    file), also as control.py loads it, and the program's SAM narrowed alike
    (its sizes and AMG settings are private: the published ones)."""
    from arcadia_microscopy_tools_tpu_torch.models import (sam_amg, sam_decoder, segmentation,
                                                           vit_sam)

    post_init = segmentation.SegmentationModel.__post_init__

    def narrowed(self, network):
        post_init(self, network)
        self._sam_model_config = sam_decoder.SamModelConfig(
            vit_sam.SamConfig(width=64, depth=4, heads=4, mlp=256, patch=16, tile=256, neck=256,
                              global_blocks=(2,), sam_grid=16, sam_window=6, window=6))
        self._amg = sam_amg.AmgSettings(points_per_side=8, points_per_batch=32)

    monkeypatch.setattr(segmentation.SegmentationModel, "__post_init__", narrowed)
    bench = manifest.load()
    entry = next(c for c in bench["configs"] if c["name"] == "sam_vit_l_amg")
    cfg = json.loads((manifest.REPO / entry["file"]).read_text())
    cfg.update(copy.deepcopy(TINY))
    path = tmp_path / "sam_vit_l_amg_tiny.json"
    path.write_text(json.dumps(cfg))
    bench = copy.deepcopy(bench)
    next(c for c in bench["configs"] if c["name"] == "sam_vit_l_amg")["file"] = str(path)
    monkeypatch.setattr(manifest, "load", lambda path=None: bench)
    return bench


def _traffic():
    return tiny_traffic(TRAFFIC, size=320, blobs=6, pool=3)


def _limits(bench):
    return manifest.config(bench, "sam_vit_l_amg")["limits"]["segment_amg"]


def test_program_is_correct(tiny_bench):
    line = harness.run_cell(CELL, 5, 0.0, True, CPU, time.perf_counter(), bench=tiny_bench,
                            traffic=_traffic())
    assert line["correct"], line["checks"]
    assert line["attempted"] == 8 and line["failed"] == 0
    assert set(line["checks"]) == {"iou_gap", "stability_gap", "logit_gap", "filter_errors",
                                   "decision_gap", "mask_gap", "centroid_gap"}
    assert line["checks"]["filter_errors"]["value"] == 0
    metrics = line["metrics"]
    # the span readers read the traced run; the device readers find no card
    for name in ("amg_encoder_ms.segment", "amg_decoder_ms.segment", "amg_filter_ms.segment",
                 "segment_prep_ms.segment"):
        assert metrics[name]["value"] > 0, name
    for name in ("amg_mfu.segment", "sam_window_attention_roofline.segment",
                 "sam_global_attention_roofline.segment", "device_idle_share.segment"):
        assert name not in metrics


@pytest.mark.parametrize("control", ["forward", "pad_keys_masked", "block0_residual",
                                     "iou_thresh_0.95", "survivors_halved"])
def test_control_fails(tiny_bench, control):
    got = readings(CELL, 7, False, CPU, traffic=_traffic(), controls=[control])
    numbers = got["control"][control]
    assert not numbers.pop("correct"), got
    limits = _limits(tiny_bench)
    assert any(numbers[k] > limits[k] for k in limits), got
    # the filters' faults fail by the numbers that hold the filters
    held_by = {"iou_thresh_0.95": "decision_gap", "survivors_halved": "filter_errors"}
    if control in held_by:
        assert numbers[held_by[control]] > limits[held_by[control]], got


@pytest.mark.parametrize("fault", ["nms_0.5", "paint_reversed"])
def test_tail_fault_fails(fault):
    """The tail's planted faults, through `compare`, on candidates whose
    masks overlap (shifted discs; the tiny network's own survivors seldom
    overlap, the published one's do: the chip readings are in PERF.md)."""
    from benchmark.references import sam_amg as ref

    cfg = manifest.config(manifest.load(), "sam_vit_l_amg")
    cfg = dict(cfg, image=64, stability_score_thresh=0.5)
    h = w = 64
    yy, xx = np.mgrid[:h, :w]
    discs = [(20, 20, 12), (23, 22, 12), (28, 30, 9), (44, 44, 10), (40, 48, 6), (10, 50, 7)]
    low = torch.stack([torch.from_numpy(12.0 * (1 - np.hypot(yy - cy, xx - cx) / r))
                       for cy, cx, r in discs]).float()
    iou = torch.linspace(0.96, 0.90, len(discs))
    cand = {"iou_preds": iou.numpy(), "stability": np.full(len(discs), 0.9, np.float32),
            "kept": np.arange(len(discs)), "logits": low}
    refs = [{"iou_preds": iou, "stability": torch.full((len(discs),), 0.9), "logits": low}]
    pool = np.random.default_rng(0).integers(100, 200, size=(1, 4, h, w)).astype(np.uint16)
    right = ref.tail(low, iou, cfg, (h, w)).numpy()
    wrong = ref.tail(low, iou, cfg, (h, w), [fault]).numpy()
    limits = manifest.config(manifest.load(), "sam_vit_l_amg")["limits"]["segment_amg"]
    good = ref.compare([(0, (right, cand))], refs, pool, cfg, CPU)
    assert harness.judge(good, limits), good
    bad = ref.compare([(0, (wrong, cand))], refs, pool, cfg, CPU)
    assert bad["mask_gap"] > limits["mask_gap"] and not harness.judge(bad, limits), bad


def test_arithmetic_against_a_hand_count():
    cfg = dict(width=64, depth=4, heads=4, mlp=256, patch=16, image=128, window=3,
               global_blocks=[2], neck=32, points_per_side=4,
               decoder={"width": 32, "depth": 2, "heads": 2, "mlp": 64, "downsample": 2,
                        "iou_hidden": 32})
    # encoder: 64 tokens; patch 2*64*768*64; per block 2*64*64*(192+64+512);
    # 3 windowed blocks (the 64 real queries, each against the 9 keys of its
    # 3 x 3 window), 1 global block of 64 tokens
    d = 16
    patch = 2 * 64 * 768 * 64
    dense = 2 * 64 * 64 * (3 * 64 + 64 + 2 * 256)
    windowed = 4 * 64 * (4 * 9 * d + 4 * 3 * d)
    global_ = 4 * (4 * 64 * 64 * d + 4 * 64 * 8 * d)
    neck = 2 * 64 * 32 * (64 + 9 * 32)
    assert sam_amg_arithmetic.encoder_flop(cfg) == patch + 4 * dense + 3 * windowed + global_ + neck
    assert sam_amg_arithmetic.attention_flop(cfg, True) == windowed
    # bf16 bytes: q, k, v, o of the 64 real tokens, the tables, and in windows
    # the pad keys' k and v (the qkv bias rows)
    assert sam_amg_arithmetic.attention_bytes(cfg, True) == 2 * (4 * 64 * 64 + 2 * 64
                                                                 + 2 * 5 * d)
    assert sam_amg_arithmetic.attention_bytes(cfg, False) == 2 * (4 * 64 * 64 + 2 * 15 * d)
    # decoder, per prompt: width 32, cross attention at 16, 7 tokens, 64 image tokens
    c, ci, t, n = 32, 16, 7, 64

    def attn(lq, lk, i):
        return 2 * (lq * c * i + 2 * lk * c * i + lq * i * c) + 4 * lq * lk * i

    layer = attn(t, t, c) + attn(t, n, ci) + 4 * t * c * 64 + attn(n, t, ci)
    upscale = 2 * n * c * 8 * 4 + 2 * 4 * n * 8 * 4 * 4
    hyper = 4 * 2 * (2 * c * c + c * 4)
    masks = 2 * 4 * 4 * 16 * n
    iou = 2 * (c * 32 + 32 * 32 + 32 * 4)
    # block 0's image side, once per image: the token -> image attention's k
    # and v projections and the image -> token attention's q projection
    shared = 2 * (2 * n + n) * c * ci
    assert sam_amg_arithmetic.image_decoder_flop(cfg) == shared
    assert sam_amg_arithmetic.prompt_flop(cfg) == 2 * layer + attn(t, n, ci) + upscale + hyper \
        + masks + iou - shared
    assert sam_amg_arithmetic.field_flop(cfg) == (sam_amg_arithmetic.encoder_flop(cfg) + shared
                                                  + 16 * sam_amg_arithmetic.prompt_flop(cfg))


def test_published_counts():
    cfg = manifest.config(manifest.load(), "sam_vit_l_amg")
    assert sam_amg_arithmetic.encoder_flop(cfg) == pytest.approx(2.84e12, rel=0.01)
    assert sam_amg_arithmetic.image_decoder_flop(cfg) == pytest.approx(0.805e9, rel=0.01)
    assert sam_amg_arithmetic.prompt_flop(cfg) == pytest.approx(2.82e9, rel=0.01)
    assert sam_amg_arithmetic.field_flop(cfg) == pytest.approx(5.72e12, rel=0.01)
    assert sam_amg_arithmetic.attention_flop(cfg, False) == pytest.approx(69.8e9, rel=0.01)
    assert sam_amg_arithmetic.attention_flop(cfg, True) == pytest.approx(3.52e9, rel=0.01)
    assert sam_amg_arithmetic.attention_bound_s(cfg, True) == pytest.approx(10.0e-6, rel=0.01)
