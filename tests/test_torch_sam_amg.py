"""PyTorch port: Segment Anything's automatic mask generator
(`network="sam"`: models/sam_decoder.py, models/sam_amg.py, the windowed and
global forms of kernel 8's plain version) against the plain float32
reference `tests/reference_sam_amg.py`, on seeded weights at a small size
that keeps every kind of part: encoder width 64, 4 heads, 4 blocks (block 2
global), patch 16 on a 128^2 input (an 8 x 8 grid; windows of 3, so 3 x 3
windows over the grid zero-padded to 9 x 9, with pad tokens in every edge
window); decoder width 32, 2 heads, depth 2; 4 x 4 points in batches of 8.

Tolerances, each with its reason:
- float32 network: 1e-4 of the reference's largest |value|. The same
  equations in float32; only the order of sums differs (F.linear over
  unfolded patches against convolutions, the ConvTs as one product, block
  0's shared image-side projections); the readings are ~1e-6.
- bfloat16 network (what `batch_segment` runs): the 99.9th percentile of
  |program - reference| over the reference's spread below 0.1, and the IoU
  predictions within 0.05. Weights, activations and the residual stream are
  rounded to 8 bits of mantissa (~0.4% each) through 4 blocks and the
  decoder; the readings are ~0.01-0.03.
- kernel 10 on the card against its plain version: each mask within 2
  bfloat16 steps of its largest |logit| (`chip_smoke.py`'s gate for kernel
  8). It rounds where the plain version rounds but sums its products in
  another order and takes the LayerNorm's statistics in two passes; the
  readings are at most 1 step, with 99.99% of the logits bit for bit.
Each planted network fault (the pad keys masked, block 0's self-attention
given a residual) moves the float32 outputs 100 times past the float32
tolerance. The tail is held exactly: the labels of the float32 route equal
the reference's, and the reference's tail run on the bfloat16 route's own
survivors equals its labels.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import reference_sam_amg as ref
from arcadia_microscopy_tools_tpu_torch.models import (sam_amg, sam_attention, sam_decoder,
                                                       sam_upscale_cuda, vit_sam)
from arcadia_microscopy_tools_tpu_torch.models.segmentation import SegmentationModel
from arcadia_microscopy_tools_tpu_torch.models.stretch_cuda import percentile_stretch_plain
from arcadia_microscopy_tools_tpu_torch.utils.profiling import StageTimer

torch.set_num_threads(1)

IMAGE = vit_sam.SamConfig(width=64, depth=4, heads=4, mlp=256, patch=16, tile=128, neck=32,
                          global_blocks=(2,), sam_grid=8, sam_window=3, window=3)
DECODER = sam_decoder.DecoderConfig(width=32, depth=2, heads=2, mlp=64, downsample=2,
                                    iou_hidden=32)
CONFIG = sam_decoder.SamModelConfig(IMAGE, DECODER)
AMG = sam_amg.AmgSettings(points_per_side=4, points_per_batch=8)
# the reference's view of the same sizes and settings
REF = {"width": 64, "depth": 4, "heads": 4, "mlp": 256, "patch": 16, "image": 128, "window": 3,
       "global_blocks": [2], "neck": 32, "decoder": {"width": 32, "depth": 2, "heads": 2},
       "points_per_side": 4, "points_per_batch": 8, "pred_iou_thresh": AMG.pred_iou_thresh,
       "stability_score_thresh": AMG.stability_score_thresh,
       "stability_score_offset": AMG.stability_score_offset,
       "box_nms_thresh": AMG.box_nms_thresh}
F32_TOL = 1e-4
BF16_GAP = 0.1
BF16_IOU = 0.05


def _state(seed: int = 0) -> dict[str, torch.Tensor]:
    """Seeded weights with the relative-position tables and pos_embed drawn
    wide enough to move the logits, and the logits scaled to spread over
    the stability offset."""
    g = torch.Generator().manual_seed(seed)
    state = sam_decoder.seeded_state_dict(CONFIG, g)
    for name, t in state.items():
        if "rel_pos" in name:
            state[name] = 0.2 * torch.randn(t.shape, generator=g)
    state["image_encoder.pos_embed"] = 0.3 * torch.randn(state["image_encoder.pos_embed"].shape,
                                                         generator=g)
    for i in range(4):
        for leaf in ("weight", "bias"):
            state[f"mask_decoder.output_hypernetworks_mlps.{i}.layers.2.{leaf}"] *= 20.0
    return state


def _image(h: int, w: int, seed: int = 1, planes: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = rng.normal(150, 15, size=(planes, h, w))
    yy, xx = np.mgrid[:h, :w]
    for _ in range(8):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        img += 2000 * rng.uniform(0.2, 1, size=(planes, 1, 1)) * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / 80)
    return img


def _stretched(img: np.ndarray) -> torch.Tensor:
    """Kernel 7's plain stretch: (H, W, 3) float32."""
    return percentile_stretch_plain([torch.from_numpy(img)], *img.shape[-2:])[0]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def _gap(prog: torch.Tensor, want: torch.Tensor) -> float:
    d = (prog.float() - want.float()).abs().flatten()
    kth = max(1, int(math.ceil(0.999 * d.numel())))
    return float(d.kthvalue(kth).values / want.float().std())


def _model(state, dtype=torch.bfloat16, amg: sam_amg.AmgSettings = AMG) -> SegmentationModel:
    model = SegmentationModel(device="cpu", network="sam")
    model._sam_model_config, model._amg = CONFIG, amg
    model._network = sam_decoder.SegmentAnything(state, CONFIG, dtype=dtype)
    return model


POINTS = torch.tensor([[3.0, 5.0], [64.0, 64.0], [100.5, 20.0], [127.0, 127.0]],
                      dtype=torch.float64)


def _both(state, img, faults=()):
    """(port float32, reference) embeddings, logits and IoUs of POINTS."""
    net = sam_decoder.SegmentAnything(state, CONFIG, dtype=torch.float32)
    x = sam_amg.sam_input(_stretched(img)[None], IMAGE.tile)
    emb = net.encode(x)[0]
    logits, iou = net.decode(emb, POINTS.float())
    sam = ref.Sam(state, REF, faults=faults)
    with torch.no_grad():
        r_emb = sam.encode(ref.sam_image(_stretched(img), IMAGE.tile))
        r_logits, r_iou = sam.decode(r_emb, POINTS)
    return (emb, logits, iou), (r_emb[0].flatten(1).t(), r_logits, r_iou)


# -- the network ------------------------------------------------------------

def test_published_layout_and_size():
    shapes = sam_decoder.published_shapes()
    n = sum(math.prod(s) for s in shapes.values())
    assert 312.0e6 < n < 312.7e6  # sam_vit_l_0b3195.pth: 1.25 GB of float32
    for i in range(24):
        rows = 127 if i in (5, 11, 17, 23) else 27
        assert shapes[f"image_encoder.blocks.{i}.attn.rel_pos_h"] == (rows, 64)
    assert shapes["prompt_encoder.mask_downscaling.6.weight"] == (256, 16, 1, 1)
    assert shapes["mask_decoder.output_upscaling.0.weight"] == (256, 64, 2, 2)
    assert shapes["mask_decoder.iou_prediction_head.layers.2.weight"] == (4, 256)
    assert len([k for k in shapes if k.startswith("mask_decoder.transformer.layers.1.")]) == 36


def test_state_is_checked():
    state = _state()
    sam_decoder.SegmentAnything(state, CONFIG)
    missing = dict(state)
    missing.pop("prompt_encoder.mask_downscaling.0.weight")
    with pytest.raises(ValueError, match="missing"):
        sam_decoder.SegmentAnything(missing, CONFIG)
    wrong = dict(state, **{"mask_decoder.iou_token.weight": torch.zeros(2, 32)})
    with pytest.raises(ValueError, match="shape"):
        sam_decoder.SegmentAnything(wrong, CONFIG)


@pytest.mark.parametrize("hw", [(128, 128), (160, 96), (200, 256)])
def test_float32_network_matches_the_reference(hw):
    img = _image(*hw, seed=hw[0])
    (emb, logits, iou), (r_emb, r_logits, r_iou) = _both(_state(1), img)
    assert _rel(emb, r_emb) < F32_TOL
    assert _rel(logits, r_logits) < F32_TOL
    assert _rel(iou, r_iou) < F32_TOL


def test_bfloat16_network_is_close():
    state, img = _state(2), _image(128, 128, seed=2)
    net = sam_decoder.SegmentAnything(state, CONFIG)
    emb = net.encode(sam_amg.sam_input(_stretched(img)[None], IMAGE.tile))[0]
    logits, iou = net.decode(emb, POINTS.float())
    assert logits.dtype == torch.bfloat16 and iou.dtype == torch.float32
    _, (_, r_logits, r_iou) = _both(state, img)
    assert _gap(logits, r_logits) < BF16_GAP
    assert float((iou - r_iou).abs().max()) < BF16_IOU


@pytest.mark.parametrize("fault", ref.NETWORK_FAULTS)
def test_network_faults_move_the_outputs(fault):
    """The port leaves the windows' pad keys unmasked and replaces block 0's
    queries by their self-attention (no residual), as SAM does: the
    reference with either fault planted is far from the port."""
    img = _image(128, 128, seed=3)
    (_, logits, iou), (_, r_logits, r_iou) = _both(_state(3), img, faults=[fault])
    assert max(_rel(logits, r_logits), _rel(iou, r_iou)) > 100 * F32_TOL


def test_pad_tokens_reach_the_windows():
    """The 8 x 8 grid is padded to 9 x 9: the last row and column of windows
    hold pad tokens, whose k and v are the qkv bias."""
    assert IMAGE.grid % IMAGE.window
    state = _state(4)
    enc = vit_sam.ViTEncoder(state, IMAGE, "image_encoder.", torch.device("cpu"), torch.float32)
    h = torch.randn(1, IMAGE.grid**2, IMAGE.width, generator=torch.Generator().manual_seed(4))
    blk = enc.blocks[0]
    got = enc._windowed(h, blk)
    # by hand: the padded grid, each window alone through the plain attention
    g, win, n = IMAGE.grid, IMAGE.window, 3
    hp = torch.nn.functional.pad(h.view(1, g, g, -1), (0, 0, 0, 1, 0, 1))
    want = torch.empty(1, n * win, n * win, IMAGE.width)
    for i in range(n):
        for j in range(n):
            tokens = hp[:, i * win:(i + 1) * win, j * win:(j + 1) * win].reshape(1, win * win, -1)
            qkv = torch.nn.functional.linear(tokens, *blk["qkv"])
            o = sam_attention.sam_attention_plain(qkv, blk["rel_h"], blk["rel_w"], IMAGE.heads,
                                                  win)
            want[:, i * win:(i + 1) * win, j * win:(j + 1) * win] = o.view(1, win, win, -1)
    assert _rel(got, want[:, :g, :g].reshape(1, g * g, -1)) < 1e-6


# -- the automatic mask generator -------------------------------------------

def _between(values: np.ndarray, quantile: float) -> float:
    """A threshold near `quantile` of `values`, halfway across the widest
    gap there, so that float32 noise cannot move a value across it."""
    v = np.sort(values[np.isfinite(values)])
    k = int(quantile * (len(v) - 1))
    lo, hi = max(0, k - 3), min(len(v) - 1, k + 4)
    gaps = np.diff(v[lo:hi + 1])
    i = lo + int(np.argmax(gaps))
    return float((v[i] + v[i + 1]) / 2)


def _settings_for(state, img) -> tuple[sam_amg.AmgSettings, dict]:
    """AMG settings whose two thresholds fall in wide gaps of the reference's
    IoU predictions and stability scores of `img`, and the reference's cfg."""
    cfg = dict(REF, pred_iou_thresh=-100.0, stability_score_thresh=0.0)
    first = ref.generate(ref.Sam(state, cfg), _stretched(img), cfg)
    iou_t = _between(first["iou_preds"].numpy(), 0.5)
    stab_t = _between(first["stability"][first["iou_preds"] > iou_t].numpy(), 0.4)
    amg = sam_amg.AmgSettings(points_per_side=4, points_per_batch=8, pred_iou_thresh=iou_t,
                              stability_score_thresh=stab_t)
    return amg, dict(REF, pred_iou_thresh=iou_t, stability_score_thresh=stab_t)


def test_float32_route_equals_the_reference():
    state, img = _state(5), _image(160, 120, seed=5)
    amg, cfg = _settings_for(state, img)
    model = _model(state, torch.float32, amg)
    (labels,), (cand,) = model.batch_segment([img], show_progress=False, return_candidates=True)
    want = ref.generate(ref.Sam(state, cfg), _stretched(img), cfg)
    assert labels.dtype == np.int32 and labels.shape == (160, 120)
    assert np.array_equal(labels, want["labels"])
    assert labels.max() >= 1
    assert np.allclose(cand["iou_preds"], want["iou_preds"].numpy(), atol=1e-5)
    assert np.array_equal(np.isnan(cand["stability"]), np.isnan(want["stability"].numpy()))
    kept = np.flatnonzero(np.nan_to_num(want["stability"].numpy(), nan=-1) >= cfg[
        "stability_score_thresh"])
    assert np.array_equal(cand["kept"], kept)
    assert _rel(cand["logits"], want["logits"][kept]) < F32_TOL


def test_bfloat16_route_tail_equals_the_reference_tail():
    """The labels of `batch_segment` (bfloat16) equal the reference's tail
    run on the route's own surviving logits and IoU predictions."""
    state = _state(6)
    imgs = [_image(128, 128, seed=6), _image(96, 144, seed=7), _image(128, 128, seed=8)[0]]
    amg, cfg = _settings_for(state, imgs[0])
    model = _model(state, amg=amg)
    labels, cands = model.batch_segment(imgs, show_progress=False, return_candidates=True)
    for img, lab, cand in zip(imgs, labels, cands):
        assert cand["logits"].dtype == torch.bfloat16
        want = ref.tail(cand["logits"].float(), torch.from_numpy(cand["iou_preds"][cand["kept"]]),
                        cfg, lab.shape)
        assert np.array_equal(lab, want.numpy())
        assert len(cand["candidate"]) == lab.max()
        assert np.isnan(cand["stability"]).sum() == (cand["iou_preds"] <= amg.pred_iou_thresh).sum()


@pytest.mark.parametrize("fault", ["nms_0.5", "paint_reversed"])
def test_tail_faults_change_the_labels(fault):
    """Overlapping masks of shifted discs: the reference tail with a planted
    fault paints other labels than the port's tail."""
    h = w = 64
    yy, xx = np.mgrid[:h, :w]
    centres = [(20, 20, 12), (23, 22, 12), (28, 30, 9), (44, 44, 10), (40, 48, 6)]
    low = torch.stack([torch.from_numpy(12.0 * (1 - np.hypot(yy - cy, xx - cx) / r))
                       for cy, cx, r in centres]).float()
    iou = torch.tensor([0.95, 0.94, 0.93, 0.92, 0.91])
    cfg = dict(REF, image=64, stability_score_thresh=0.5)
    amg = sam_amg.AmgSettings(stability_score_thresh=0.5)
    port = _port_tail(low, iou, amg, 64, (h, w))
    assert np.array_equal(port, ref.tail(low, iou, cfg, (h, w)).numpy())
    assert not np.array_equal(port, ref.tail(low, iou, cfg, (h, w), [fault]).numpy())


def _port_tail(low, iou, amg, size, hw):
    stab = torch.full((len(low),), float("nan"))
    got = sam_amg.filter_batch(low[:, None].expand(-1, 1, -1, -1), iou[:, None], 0, size, hw, hw,
                               dataclasses.replace(amg, pred_iou_thresh=-1.0), stab)
    order = sam_amg.nms(got.boxes, iou[got.index], amg.box_nms_thresh)
    return sam_amg.paint(got.masks[order]).numpy()


def _brute_force_nms(boxes: np.ndarray, scores: np.ndarray, threshold: float) -> list[int]:
    """Greedy NMS written out: boxes in decreasing score, ties by index."""
    order = sorted(range(len(scores)), key=lambda i: (-scores[i], i))
    kept = []
    for i in order:
        ok = True
        for j in kept:
            x0, y0 = max(boxes[i, 0], boxes[j, 0]), max(boxes[i, 1], boxes[j, 1])
            x1, y1 = min(boxes[i, 2], boxes[j, 2]), min(boxes[i, 3], boxes[j, 3])
            inter = max(0.0, x1 - x0) * max(0.0, y1 - y0)
            area = lambda b: (b[2] - b[0]) * (b[3] - b[1])  # noqa: E731
            union = area(boxes[i]) + area(boxes[j]) - inter
            if union > 0 and inter / union > threshold:
                ok = False
                break
        if ok:
            kept.append(i)
    return kept


@pytest.mark.parametrize("seed", range(6))
def test_nms_equals_brute_force_greedy_with_ties(seed):
    rng = np.random.default_rng(seed)
    n = 60
    xy = rng.integers(0, 40, size=(n, 2))
    wh = rng.integers(1, 30, size=(n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.int64)
    boxes[5] = boxes[3]  # a duplicate box
    scores = rng.choice([0.9, 0.91, 0.92, 0.95], size=n).astype(np.float32)  # many ties
    got = sam_amg.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.7).tolist()
    assert got == _brute_force_nms(boxes.astype(np.float64), scores, 0.7)
    assert got == ref.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.7)


def test_paint_order():
    """Largest first, ties in the given (NMS) order, later masks on top."""
    m = torch.zeros(4, 8, 8, dtype=torch.bool)
    m[0, :4, :4] = True  # 16
    m[1, 2:6, 2:6] = True  # 16, ties with 0: painted after it
    m[2, :8, :3] = True  # 24: painted first
    m[3, 3:5, 0:2] = True  # 4: painted last, on top
    got = sam_amg.paint(m)
    assert torch.equal(got, ref.mask_data_to_segmentation(m))
    assert int(got[0, 0]) == 2 and int(got[3, 3]) == 3 and int(got[3, 0]) == 4
    assert int(got[7, 0]) == 1 and got.dtype == torch.int32


def test_mask_to_box_matches_sam():
    g = torch.Generator().manual_seed(0)
    m = torch.rand(6, 20, 30, generator=g) > 0.97
    m[2] = False  # empty: [0, 0, 0, 0]
    m[3] = False
    m[3, 4, 7] = True  # one pixel: the last pixel inclusive
    got = sam_amg.mask_to_box(m)
    assert torch.equal(got, ref.batched_mask_to_box(m))
    assert got[2].tolist() == [0, 0, 0, 0] and got[3].tolist() == [7, 4, 7, 4]


def test_point_grid_and_input():
    pts = sam_amg.point_grid(4)
    assert np.array_equal(pts, ref.build_point_grid(4))
    assert np.allclose(pts[:4, 0], [0.125, 0.375, 0.625, 0.875]) and np.all(pts[:4, 1] == 0.125)
    img = _stretched(_image(200, 100, seed=9))
    assert torch.equal(sam_amg.sam_input(img[None], 128)[0], ref.sam_image(img, 128)[0])
    assert sam_amg.preprocess_shape(200, 100, 128) == (128, 64)


# -- the entry: spans, counters, options ------------------------------------

def test_stage_timer_count():
    timer = StageTimer()
    timer.count("x.items", 3)
    timer.count("x.items")
    assert timer.counts == {"x.items": 4} and timer.totals == {}


def test_spans_and_counters():
    state = _state(10)
    model = _model(state, amg=sam_amg.AmgSettings(points_per_side=4, points_per_batch=8,
                                                  pred_iou_thresh=-100.0,
                                                  stability_score_thresh=0.0))
    imgs = [_image(128, 128, seed=10 + k) for k in range(3)]
    labels, cands = model.batch_segment(imgs, show_progress=False, return_candidates=True)
    c, t = model.stages.counts, model.stages.totals
    assert c["segment.prepare"] == 3 and c["segment.encoder.images"] == 3
    assert c["segment.encoder"] == 1  # one micro-batch
    assert c["segment.decoder"] == c["segment.amg_filter"] == 6  # 2 prompt batches an image
    assert c["segment.nms"] == c["segment.paint"] == c["segment.readback"] == 3
    assert c["segment.amg.candidates"] == 3 * 48
    assert c["segment.amg.iou_kept"] == 3 * 48  # no IoU filter at -100
    assert c["segment.amg.stable_kept"] == sum(len(x["kept"]) for x in cands)
    assert c["segment.amg.nms_kept"] == sum(int(x.max()) for x in labels)
    assert all(t[k] > 0 for k in ("segment.encoder", "segment.decoder", "segment.amg_filter"))


def test_options_and_checkpoint(tmp_path):
    state = _state(11)
    path = tmp_path / "sam.pt"
    torch.save(state, path)
    model = SegmentationModel(device="cpu", network="sam", checkpoint_path=path)
    model._sam_model_config, model._amg = CONFIG, AMG
    img = _image(128, 128, seed=11)
    a = model.batch_segment([img], show_progress=False)
    b = _model(state).batch_segment([img], show_progress=False)
    assert np.array_equal(a[0], b[0])
    with pytest.raises(ValueError, match="flows"):
        model.batch_segment([img], show_progress=False, return_flows=True)
    with pytest.raises(ValueError, match="network='sam'"):
        SegmentationModel(device="cpu").batch_segment([img], show_progress=False,
                                                      return_candidates=True)


# -- kernel 8's new forms on the card ---------------------------------------

def _card_case(tiles: int, grid: int, scale: float = 1.0):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(tiles * 100 + grid)
    qkv = (scale * torch.randn(tiles, grid * grid, 3 * 1024, generator=g, device=dev)).bfloat16()
    rh, rw = ((0.05 * torch.randn(2 * grid - 1, 64, generator=g, device=dev)).bfloat16()
              for _ in range(2))
    return qkv, rh, rw


def _within_steps(got: torch.Tensor, want: torch.Tensor, steps: float = 2.0) -> bool:
    step = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
    return float((got.float() - want.float()).abs().max()) <= steps * step


@pytest.mark.gpu
@pytest.mark.parametrize("tiles", [1, 2])
def test_kernel_grid64_equals_plain_on_the_card(tiles):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qkv, rh, rw = _card_case(tiles, 64)
    before = sam_attention.launch_counts["sam_attention"]
    got = sam_attention.sam_attention(qkv, rh, rw, 16, 64)
    assert sam_attention.launch_counts["sam_attention"] == before + 1
    assert _within_steps(got, sam_attention.sam_attention_plain(qkv, rh, rw, 16, 64))


@pytest.mark.gpu
@pytest.mark.parametrize("windows", [1, 7, 25, 200])
def test_kernel_windows_equal_plain_on_the_card(windows):
    """Odd window counts, and 196 tokens that fill neither a block of 64
    queries nor a step of 64 keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for scale in (1.0, 3.0):
        qkv, rh, rw = _card_case(windows, 14, scale)
        before = sam_attention.launch_counts["sam_window_attention"]
        got = sam_attention.sam_attention(qkv, rh, rw, 16, 14)
        assert sam_attention.launch_counts["sam_window_attention"] == before + 1
        assert _within_steps(got, sam_attention.sam_attention_plain(qkv, rh, rw, 16, 14))


@pytest.mark.gpu
def test_windowed_encoder_block_on_the_card_matches_the_cpu():
    """A ViT-L-wide windowed block and a global one over SAM's 64 x 64 grid
    (padded to 70 x 70): the card's kernels against the CPU's plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = vit_sam.SamConfig(width=1024, depth=2, heads=16, mlp=1024, patch=16, tile=1024,
                            neck=32, global_blocks=(1,), window=14)
    state = {k: v for k, v in sam_decoder.seeded_state_dict(
        sam_decoder.SamModelConfig(cfg, DECODER), torch.Generator().manual_seed(12)).items()
        if k.startswith("image_encoder.")}
    x = torch.randn(1, 64 * 64, 1024, generator=torch.Generator().manual_seed(13))
    card = vit_sam.ViTEncoder(state, cfg, "image_encoder.", torch.device("cuda"), torch.bfloat16)
    cpu = vit_sam.ViTEncoder(state, cfg, "image_encoder.", torch.device("cpu"), torch.float32)
    for blk_card, blk_cpu in zip(card.blocks, cpu.blocks):
        got = card._block(x.cuda().bfloat16(), blk_card).float().cpu()
        want = cpu._block(x, blk_cpu)
        assert _gap(got - x, want - x) < BF16_GAP


# -- kernel 10: the mask head ------------------------------------------------

def _parent_mask_head(keys, up0, up1, up3, hyper4, g):
    """The mask head as `decode` ran it before kernel 10, verbatim but for
    `self.`: all four masks, then mask 0 dropped."""
    n = keys.shape[0]
    x = F.linear(keys, up0[0]).view(n, g, g, -1, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3).reshape(n, 2 * g, 2 * g, -1) + up0[1]
    x = F.gelu(F.layer_norm(x, (x.shape[-1],), up1[0], up1[1], 1e-6))
    x = F.linear(x, up3[0]).view(n, 2 * g, 2 * g, -1, 2, 2)
    x = F.gelu(x.permute(0, 1, 4, 2, 5, 3).reshape(n, 4 * g, 4 * g, -1) + up3[1])
    masks = torch.matmul(hyper4, x.view(n, 16 * g * g, -1).transpose(1, 2))
    return masks[:, 1:].view(n, 3, 4 * g, 4 * g)


def _head_operands(n: int, grid: int, width: int, dtype, seed: int, spread: float = 1.0,
                   device="cpu"):
    """Random keys, ConvT weights in `decode`'s layout and four hypernetwork
    rows; weights N(0, 1 / fan_in), the LayerNorm's weight 1 + N(0, 0.1^2)."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(device, dtype)

    keys = r(n, grid * grid, width, scale=spread)
    up0 = (r(width, width, scale=width**-0.5), r(width // 4, scale=0.02))
    up1 = ((1 + 0.1 * torch.randn(width // 4, generator=g)).to(device, dtype),
           r(width // 4, scale=0.02))
    up3 = (r(width // 2, width // 4, scale=(width // 4) ** -0.5), r(width // 8, scale=0.02))
    hyper4 = r(n, 4, width // 8, scale=spread)
    return keys, up0, up1, up3, hyper4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width,grid", [(256, 64), (256, 16), (32, 8)])
def test_upscale_plain_equals_the_inline_sequence(dtype, width, grid):
    """At SAM's widths and at a small one: the plain version (and the
    wrapper, which runs it on the CPU) gives the replaced sequence's bits."""
    keys, up0, up1, up3, hyper4 = _head_operands(2, grid, width, dtype, seed=width + grid)
    want = _parent_mask_head(keys, up0, up1, up3, hyper4, grid)
    args = (keys, *up0, *up1, *up3, hyper4[:, 1:].contiguous(), grid)
    got = sam_upscale_cuda.sam_upscale_plain(*args)
    assert got.dtype == dtype and got.shape == (2, 3, 4 * grid, 4 * grid)
    assert torch.equal(got, want)
    before = dict(sam_upscale_cuda.launch_counts)
    assert torch.equal(sam_upscale_cuda.sam_upscale(*args), want)
    assert sam_upscale_cuda.launch_counts == before  # no launch on the CPU


# SAM's decoder widths on a 16 x 16 token grid, one of kernel 10's instances
SAM_DECODER = sam_decoder.SamModelConfig(
    dataclasses.replace(IMAGE, neck=256, tile=256, sam_grid=16), sam_decoder.DecoderConfig())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("config", [CONFIG, SAM_DECODER], ids=["small", "sam_widths"])
def test_decode_keeps_the_parent_bits(dtype, config):
    """`decode` on the CPU: the logits of the parent's mask head on the
    two-way transformer's output, bit for bit, and the same IoUs."""
    state = sam_decoder.seeded_state_dict(config, torch.Generator().manual_seed(14))
    net = sam_decoder.SegmentAnything(state, config, dtype=dtype)
    g, w = config.image.grid, config.decoder.width
    emb = torch.randn(g * g, w, generator=torch.Generator().manual_seed(15)).to(dtype)
    logits, iou = net.decode(emb, POINTS.float())
    queries, keys = net.two_way(emb, POINTS.float())
    hyper4 = torch.stack([net._mlp(queries[:, 1 + i], net.hyper[i]) for i in range(4)], dim=1)
    assert torch.equal(logits, _parent_mask_head(keys, net.up0, net.up1, net.up3, hyper4, g))
    assert torch.equal(iou, net._mlp(queries[:, 0], net.iou_head).float()[:, 1:])


def _bad_operands(case: str):
    keys, up0, up1, up3, hyper4 = _head_operands(2, 8, 256, torch.bfloat16, seed=16)
    args = [keys, *up0, *up1, *up3, hyper4[:, 1:].contiguous(), 8]
    if case == "tokens":
        args[0] = keys[:, :60]
    elif case == "up0":
        args[1] = up0[0][:, :128]
    elif case == "up3_bias":
        args[6] = torch.zeros(16, dtype=torch.bfloat16)
    elif case == "hyper":
        args[7] = hyper4[:, 1:, :16]
    elif case == "prompts":
        args[7] = hyper4[:1, 1:]
    elif case == "mixed_dtypes":
        args[1] = up0[0].float()
    elif case == "integer":
        args = [a.to(torch.int32) if isinstance(a, torch.Tensor) else a for a in args]
    elif case == "meta":
        args = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    return args


@pytest.mark.parametrize("case", ["tokens", "up0", "up3_bias", "hyper", "prompts",
                                  "mixed_dtypes", "integer", "meta"])
def test_upscale_refuses_bad_operands(case):
    with pytest.raises(ValueError):
        sam_upscale_cuda.sam_upscale(*_bad_operands(case))
    if case != "meta":
        with pytest.raises(ValueError):
            sam_upscale_cuda.sam_upscale_plain(*_bad_operands(case))


def test_kernel_takes_sam_widths_only():
    takes = sam_upscale_cuda.kernel_takes
    assert takes(256, 64, torch.bfloat16) and takes(256, 16, torch.bfloat16)
    assert not takes(256, 64, torch.float32)  # the float32 decoder runs the plain version
    assert not takes(32, 8, torch.bfloat16)  # the tests' small decoder
    assert not takes(256, 8, torch.bfloat16) and not takes(256, 32, torch.bfloat16)


# -- kernel 10 on the card --------------------------------------------------

def _masks_within_steps(got: torch.Tensor, want: torch.Tensor, steps: float = 2.0) -> float:
    """The worst mask's largest |got - want| in bfloat16 steps at that
    mask's largest |logit|."""
    g, w = got.float().flatten(2), want.float().flatten(2)
    top = w.abs().amax(-1).clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return float(((g - w).abs().amax(-1) / step).max())


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [64, 16])
@pytest.mark.parametrize("prompts", [1, 7, 64])
def test_upscale_kernel_matches_plain_on_the_card(prompts, grid):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for spread in (1.0, 4.0):
        keys, up0, up1, up3, hyper4 = _head_operands(prompts, grid, 256, torch.bfloat16,
                                                     seed=prompts * 100 + grid, spread=spread,
                                                     device="cuda")
        args = (keys, *up0, *up1, *up3, hyper4[:, 1:].contiguous(), grid)
        before = sam_upscale_cuda.launch_counts["sam_upscale"]
        got = sam_upscale_cuda.sam_upscale(*args)
        assert sam_upscale_cuda.launch_counts["sam_upscale"] == before + 1
        want = sam_upscale_cuda.sam_upscale_plain(*args)
        worst = _masks_within_steps(got, want)
        equal = float((got.view(torch.int16) == want.view(torch.int16)).float().mean())
        print(f"kernel 10, P {prompts}, grid {grid}, spread {spread}: worst mask {worst:.3f} "
              f"bf16 steps, {equal:.4%} of the logits bit for bit")
        assert worst <= 2.0


@pytest.mark.gpu
def test_decode_launches_the_upscale_kernel_once_on_the_card():
    """SAM's decoder widths on the card: one launch per bfloat16 `decode`,
    within two bf16 steps of the plain mask head on the same transformer
    output; none for the float32 decoder."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    state = sam_decoder.seeded_state_dict(SAM_DECODER, torch.Generator().manual_seed(17))
    g = SAM_DECODER.image.grid
    emb = torch.randn(g * g, 256, generator=torch.Generator().manual_seed(18))
    for dtype, launches in ((torch.bfloat16, 1), (torch.float32, 0)):
        net = sam_decoder.SegmentAnything(state, SAM_DECODER, device="cuda", dtype=dtype)
        e, pts = emb.to("cuda", dtype), POINTS.float().cuda()
        sam_upscale_cuda.reset_launch_counts()
        logits, _ = net.decode(e, pts)
        assert sam_upscale_cuda.launch_counts["sam_upscale"] == launches
        queries, keys = net.two_way(e, pts)
        hyper = torch.stack([net._mlp(queries[:, 1 + i], net.hyper[i]) for i in range(1, 4)], 1)
        want = sam_upscale_cuda.sam_upscale_plain(keys, *net.up0, *net.up1, *net.up3, hyper, g)
        assert _masks_within_steps(logits, want) <= 2.0
