"""Segment Anything's automatic mask generator (AMG), on the device.

`SamAutomaticMaskGenerator` of github.com/facebookresearch/segment-anything
(`automatic_mask_generator.py`, `utils/amg.py`) at its defaults with one
crop (`crop_n_layers` 0), as micro-SAM's AMG mode runs it, then micro-SAM's
`mask_data_to_segmentation` into one label image. For one (H, W) image whose
embedding `SegmentAnything.encode` made (models/sam_decoder.py):

1. input: the image's three planes stretched to [0, 1] (kernel 7), times
   255 and rounded (SAM's uint8 RGB input), resized so that its longer side
   is the encoder's input side (`ResizeLongestSide`: bilinear, antialiased,
   rounded to integers again), normalised by SAM's pixel mean and std and
   zero-padded at the bottom and right to a square (`sam_input`);
2. point prompts: `points_per_side`^2 points at ((i + 0.5) / n, (j + 0.5) /
   n) of the image (x first), mapped into the input frame, in batches of
   `points_per_batch`; each gives 3 candidate masks (multimask), candidate
   c = 3 * point + mask;
3. per batch (`filter_batch`): candidates with predicted IoU >
   `pred_iou_thresh` are kept; their logits are upsampled as
   `postprocess_masks` does (bilinear, align_corners False, to the input
   side, cropped to the resized image, then to (H, W)) in float32; the
   stability score #(logit > offset) / #(logit > -offset) must be >=
   `stability_score_thresh`; the mask is logit > 0; its box the XYXY box of
   `batched_mask_to_box` (last pixel inclusive; [0, 0, 0, 0] when empty);
   the near-crop-edge filter keeps everything with one crop;
4. over all batches, greedy NMS of the boxes by predicted IoU at IoU >
   `box_nms_thresh` (torchvision's `box_iou`, areas (x1 - x0)(y1 - y0)),
   kept masks in decreasing score, ties by candidate index (`nms`);
5. painting (`paint`): the kept masks stably sorted by area, largest first,
   each written over the label image in that order with ids 1, 2, ... in
   paint order (micro-SAM, `with_background` False, `min_size` 0).

Departures from SAM's code, none of which changes the kept masks:
- the resize is PyTorch's antialiased bilinear, not PIL's filter (a
  difference of the input, stated as an assumption where it is compared);
- the IoU filter runs before the upsampling (SAM upsamples all of a batch's
  masks, then filters): the same survivors, fewer masks upsampled;
- the masks stay binary images: no RLE round trip, which gives the same
  masks;
- NMS runs as a fixed point on the device (`nms`), which is greedy NMS in
  score order: each box is kept unless a kept box before it overlaps it by
  more than the threshold.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import StageTimer
from .sam_decoder import PIXEL_MEAN, PIXEL_STD, SegmentAnything

__all__ = [
    "AmgSettings",
    "box_iou",
    "filter_batch",
    "generate",
    "mask_to_box",
    "nms",
    "paint",
    "point_grid",
    "preprocess_shape",
    "sam_input",
    "stability_score",
    "upsample_logits",
]


@dataclass(frozen=True)
class AmgSettings:
    """`SamAutomaticMaskGenerator`'s settings; the defaults are SAM's."""

    points_per_side: int = 32
    points_per_batch: int = 64
    pred_iou_thresh: float = 0.88
    stability_score_thresh: float = 0.95
    stability_score_offset: float = 1.0
    box_nms_thresh: float = 0.7
    mask_threshold: float = 0.0


def point_grid(n: int) -> np.ndarray:
    """SAM's `build_point_grid`: (n^2, 2) float64 points (x, y) in [0, 1]."""
    offset = 1 / (2 * n)
    side = np.linspace(offset, 1 - offset, n)
    xs = np.tile(side[None, :], (n, 1))
    ys = np.tile(side[:, None], (1, n))
    return np.stack([xs, ys], axis=-1).reshape(-1, 2)


def preprocess_shape(h: int, w: int, long_side: int) -> tuple[int, int]:
    """`ResizeLongestSide.get_preprocess_shape`."""
    scale = long_side * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def sam_input(stretched: torch.Tensor, size: int) -> torch.Tensor:
    """(N, H, W, 3) float32 planes in [0, 1] -> (N, 3, size, size) float32:
    SAM's uint8 input, resized to the longest side `size`, normalised and
    padded (step 1 of the module docstring)."""
    h, w = stretched.shape[1:3]
    x = torch.round(stretched * 255.0).permute(0, 3, 1, 2)
    nh, nw = preprocess_shape(h, w, size)
    if (nh, nw) != (h, w):
        x = F.interpolate(x, (nh, nw), mode="bilinear", align_corners=False, antialias=True)
        x = torch.round(x).clamp_(0.0, 255.0)
    mean = torch.tensor(PIXEL_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(PIXEL_STD, device=x.device).view(1, 3, 1, 1)
    return F.pad((x - mean) / std, (0, size - nw, 0, size - nh))


def upsample_logits(low: torch.Tensor, size: int, input_hw: tuple[int, int],
                    out_hw: tuple[int, int]) -> torch.Tensor:
    """SAM's `postprocess_masks` of (K, h, w) float32 logits -> (K, H, W)."""
    x = F.interpolate(low[:, None], (size, size), mode="bilinear", align_corners=False)
    x = x[..., : input_hw[0], : input_hw[1]]
    return F.interpolate(x, out_hw, mode="bilinear", align_corners=False)[:, 0]


def stability_score(logits: torch.Tensor, threshold: float, offset: float) -> torch.Tensor:
    """SAM's `calculate_stability_score`: #(logit > t + offset) /
    #(logit > t - offset) per mask, float32."""
    inter = (logits > threshold + offset).sum((-1, -2), dtype=torch.int32)
    union = (logits > threshold - offset).sum((-1, -2), dtype=torch.int32)
    return inter / union


def mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    """SAM's `batched_mask_to_box`: (K, H, W) bool -> (K, 4) int64 XYXY, the
    last pixel inclusive, [0, 0, 0, 0] for an empty mask."""
    k, h, w = masks.shape
    if k == 0:
        return torch.zeros((0, 4), dtype=torch.int64, device=masks.device)
    rows = masks.any(-1)
    cols = masks.any(-2)
    ry = rows * torch.arange(h, device=masks.device)
    cx = cols * torch.arange(w, device=masks.device)
    bottom, right = ry.amax(-1), cx.amax(-1)
    top = (ry + h * ~rows).amin(-1)
    left = (cx + w * ~cols).amin(-1)
    empty = (right < left) | (bottom < top)
    return torch.stack([left, top, right, bottom], -1) * ~empty[:, None]


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torchvision's `box_iou` of float XYXY boxes: (K, 4), (M, 4) -> (K, M)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def nms(boxes: torch.Tensor, scores: torch.Tensor, threshold: float) -> torch.Tensor:
    """Greedy NMS: indices of the kept boxes in decreasing score (ties by
    index). Box j is kept unless a kept box before it in that order has
    IoU > threshold with it. Solved as the fixed point of keep[j] = no kept
    i < j suppresses j, iterated from all kept: after t rounds the first t
    boxes are settled, and a round that changes nothing has reached greedy
    NMS's unique solution, so the rounds number the longest chain of
    suppressions, not the boxes."""
    order = torch.sort(scores, descending=True, stable=True).indices
    b = boxes[order].float()
    suppresses = (box_iou(b, b) > threshold).triu(1)
    keep = torch.ones(len(order), dtype=torch.bool, device=boxes.device)
    while True:
        new = ~(suppresses & keep[:, None]).any(0)
        if torch.equal(new, keep):
            return order[keep]
        keep = new


def paint(masks: torch.Tensor) -> torch.Tensor:
    """micro-SAM's `mask_data_to_segmentation`: (M, H, W) bool masks in
    their given order -> (H, W) int32 labels, the masks stably sorted by
    area (largest first) and painted in that order with ids 1, 2, ..."""
    labels = torch.zeros(masks.shape[1:], dtype=torch.int32, device=masks.device)
    if len(masks) == 0:
        return labels
    order = torch.sort(masks.sum((-1, -2)), descending=True, stable=True).indices.tolist()
    for rank, m in enumerate(order):
        labels.masked_fill_(masks[m], rank + 1)
    return labels


@dataclass
class _Survivors:
    """What `filter_batch` keeps of one batch of candidates."""

    index: torch.Tensor  # (K,) candidate indices
    logits: torch.Tensor  # (K, h, w) low-resolution logits, the decoder's dtype
    masks: torch.Tensor  # (K, H, W) bool
    boxes: torch.Tensor  # (K, 4) int64 XYXY
    iou_kept: int  # candidates past the IoU filter


def filter_batch(logits: torch.Tensor, iou: torch.Tensor, first: int, size: int,
                 input_hw: tuple[int, int], out_hw: tuple[int, int], amg: AmgSettings,
                 stability: torch.Tensor) -> _Survivors:
    """Step 3 for one batch: (P, 3, h, w) logits and (P, 3) IoUs of
    candidates `first`, `first` + 1, ... -> the survivors of both filters;
    writes the stability scores of the IoU filter's survivors into
    `stability` (one entry per candidate of the image)."""
    iou = iou.flatten()
    passed = torch.nonzero(iou > amg.pred_iou_thresh).flatten()
    low = logits.flatten(0, 1)[passed]
    up = upsample_logits(low.float(), size, input_hw, out_hw)
    score = stability_score(up, amg.mask_threshold, amg.stability_score_offset)
    stability[first + passed] = score
    stable = score >= amg.stability_score_thresh
    masks = up[stable] > amg.mask_threshold
    return _Survivors(first + passed[stable], low[stable], masks, mask_to_box(masks), len(passed))


def generate(net: SegmentAnything, embedding: torch.Tensor, hw: tuple[int, int],
             amg: AmgSettings, stages: StageTimer, image: int = 0
             ) -> tuple[torch.Tensor, dict]:
    """The AMG of one (H, W) image from its (grid^2, width) embedding:
    (H, W) int32 labels and its candidates on the device: "iou_preds" and
    "stability" (float32, one per candidate; NaN where the IoU filter
    dropped it), "kept" (the candidates that passed both filters),
    "logits" (theirs, low resolution, the decoder's dtype) and the records
    of the masks NMS kept, in NMS order: "candidate", "box" (XYWH),
    "predicted_iou", "stability_score", "point" (x, y in the image), "area".

    `stages` gets a "segment.decoder" and a "segment.amg_filter" range per
    prompt batch (args "image i points a-b"), a "segment.nms" and a
    "segment.paint" range, and the counters "segment.amg.candidates",
    ".iou_kept", ".stable_kept" and ".nms_kept"."""
    size = net.config.image.tile
    h, w = hw
    input_hw = preprocess_shape(h, w, size)
    dev = embedding.device
    points = point_grid(amg.points_per_side) * np.array([w, h], dtype=np.float64)
    prompts = torch.from_numpy(points * np.array([input_hw[1] / w, input_hw[0] / h])).to(dev)
    n_points = len(points)
    iou_preds = torch.empty(3 * n_points, dtype=torch.float32, device=dev)
    stability = torch.full((3 * n_points,), float("nan"), dtype=torch.float32, device=dev)
    kept: list[_Survivors] = []
    for a in range(0, n_points, amg.points_per_batch):
        b = min(a + amg.points_per_batch, n_points)
        args = f"image {image} points {a}-{b - 1}"
        # block=embedding: each stage ends once its device, the embedding's, is done
        with stages.stage("segment.decoder", block=embedding, args=args):
            logits, iou = net.decode(embedding, prompts[a:b].float())
        with stages.stage("segment.amg_filter", block=embedding, args=args):
            iou_preds[3 * a : 3 * b] = iou.flatten()
            got = filter_batch(logits, iou, 3 * a, size, input_hw, hw, amg, stability)
        kept.append(got)
        stages.count("segment.amg.candidates", 3 * (b - a))
        stages.count("segment.amg.iou_kept", got.iou_kept)
    index = torch.cat([k.index for k in kept])
    masks = torch.cat([k.masks for k in kept])
    boxes = torch.cat([k.boxes for k in kept])
    stages.count("segment.amg.stable_kept", len(index))
    with stages.stage("segment.nms", args=f"image {image}"):
        order = nms(boxes, iou_preds[index], amg.box_nms_thresh)
    stages.count("segment.amg.nms_kept", len(order))
    with stages.stage("segment.paint", args=f"image {image}", block=masks):
        labels = paint(masks[order])
    box = boxes[order]
    point = torch.from_numpy(points).to(dev)[index[order] // 3]
    candidates = {
        "iou_preds": iou_preds, "stability": stability, "kept": index,
        "logits": torch.cat([k.logits for k in kept]),
        "candidate": index[order],
        "box": torch.cat([box[:, :2], box[:, 2:] - box[:, :2]], 1),
        "predicted_iou": iou_preds[index[order]], "stability_score": stability[index[order]],
        "point": point, "area": masks[order].sum((-1, -2)),
    }
    return labels, candidates
