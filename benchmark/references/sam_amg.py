"""Plain reference of `batch_segment` with Segment Anything's automatic
mask generator (`network="sam"`): every candidate's IoU prediction,
stability score and low-resolution logits of each pool image, its label
image, and the AMG's tail run on given survivors.

The semantics the cell states (the port's models/sam_decoder.py and
models/sam_amg.py document them), written out as SAM's modules compute
them (github.com/facebookresearch/segment-anything: `image_encoder.py`,
`prompt_encoder.py`, `mask_decoder.py`, `transformer.py`,
`automatic_mask_generator.py`, `utils/amg.py`; micro-SAM's
`mask_data_to_segmentation`) in plain PyTorch, float32 with TF32 off, with
no kernel and nothing of the program: the windows partitioned explicitly
(the pad keys unmasked), the relative-position bias materialised, the image
embedding copied per prompt (`repeat_interleave`), every one of a batch's
192 masks upsampled before the filters, greedy NMS one box at a time,
Python's stable sort by area. One image at a time; the prompts in SAM's
batches of `points_per_batch`. The input is the three planes stretched as
the U-Net reference stretches (1-99 percentiles, clipped), times 255 and
rounded. The weights are the benchmark's seeded state dict
(`sam_amg_weights.py`), remade from the pool. tests/reference_sam_amg.py is
the same network and tail, for the CPU tests.

Controls (`LOWERED`; all are `CONTROLS`, each must fail the comparison):
- "forward": every operand of every product stored in float8 e4m3
  (saturated at +-448) with float32 accumulation, below the configuration's
  bfloat16;
- planted faults of the network, in the reference's own outputs:
  "pad_keys_masked" (the windows' pad keys masked out of the softmax) and
  "block0_residual" (block 0's token self-attention added as a residual);
- planted faults of the filters, on the reference's own candidates:
  "iou_thresh_0.95" (the IoU filter at 0.95 in place of 0.88: the
  candidates between them neither scored nor kept) and "survivors_halved"
  (every second survivor of both filters dropped before NMS and the
  painting);
- planted faults of the tail, on the reference's own survivors: "nms_0.5"
  (NMS at IoU 0.5) and "paint_reversed" (the smallest mask painted first).

Compared (`compare`), over every image the window returned:
- `iou_gap`: the largest |program - reference| IoU prediction over all
  candidates (a NaN reads inf);
- `stability_gap`: the STABILITY_QUANTILE quantile of |program -
  reference| stability score over the candidates both sides scored, of
  every image together. Not the largest gap, nor one image's: the score is
  a ratio of two pixel counts, #(logit > 1) / #(logit > -1), and a mask
  whose logits lie flat near -1 or 1 changes it by up to 1 for a bf16
  rounding (the program's largest read 0.43-0.97, as large as the float8
  control's, and one image's 90th percentile up to 0.11, above the pad-key
  fault's on another seed);
- `logit_gap`: per mask that passed the program's filters, the 99.9th
  percentile of |program - reference| low-resolution logit over the
  reference mask's root mean square logit (the distance of its logits from
  the mask threshold 0); per answer the MASK_QUANTILE quantile over its
  masks, the worst answer's (so that a fault in one image cannot hide among
  the others). Not the standard deviation, which is small on the seeded
  whole-field masks (logits nearly flat, far from 0), and not the largest
  mask: a few masks with logits near 0 read 0.5-1.1 for the program, as
  high as the pad-key fault's least;
- `filter_errors`: per answer, the candidates whose filter decisions
  disagree with the answer's own numbers at the configuration's
  thresholds: scored (a stability score, not NaN) where its IoU prediction
  is not above `pred_iou_thresh`; in `kept` where it is not scored at or
  above `stability_score_thresh`, or not in `kept` where it is; each index
  of `kept` past the first time it appears or out of range; the worst
  answer's count. Exact: the program decides on the float32 numbers it
  returns. A NaN where the IoU prediction is above the threshold is no
  error by itself: SAM's score of a mask with no logit above -offset is
  0 / 0, NaN as well;
- `decision_gap`: per answer, the share of the candidates that the
  program's filters and the reference's decided differently (scored, a
  number and not NaN, by one side only, or kept by one side only), the
  worst answer's: this holds the set of survivors to the reference's,
  where the gaps above read only the survivors the program kept, and it
  catches an IoU filter that drops too much;
- `mask_gap`, `centroid_gap`: the program's label image against the
  reference's tail (`tail`: upsampling, stability, boxes, NMS, painting)
  run on the program's own surviving logits and IoU predictions, as tables
  of cells (`tables`), so the tail is held to the reference whatever the
  network gives.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import sam_amg_weights, tables
from benchmark.references import classical, unet
from benchmark.references.segment import _table

FORWARD = {"reference": torch.float32, "control": torch.float8_e4m3fn}
LOWERED = {"forward": {"forward": "control"},
           "pad_keys_masked": {"network": "pad_keys_masked"},
           "block0_residual": {"network": "block0_residual"},
           "iou_thresh_0.95": {"filter": "iou_thresh_0.95"},
           "survivors_halved": {"filter": "survivors_halved"},
           "nms_0.5": {"tail": "nms_0.5"}, "paint_reversed": {"tail": "paint_reversed"}}
CONTROLS = ["forward", "pad_keys_masked", "block0_residual", "iou_thresh_0.95",
            "survivors_halved", "nms_0.5", "paint_reversed"]
LOGIT_QUANTILE = 0.999
STABILITY_QUANTILE = 0.9
MASK_QUANTILE = 0.9

EPS_ENCODER = 1e-6  # the image encoder's LayerNorms and the LayerNorm2d's
EPS_DECODER = 1e-5  # the two-way transformer's LayerNorms
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
FP8_MAX = 448.0
# planted faults of the network (`Sam(faults=...)`): the windows' pad keys
# masked out of the softmax, and block 0's token self-attention added to its
# queries as a residual
NETWORK_FAULTS = ("pad_keys_masked", "block0_residual")


class Sam:
    """SAM's image encoder, prompt encoder and mask decoder as its modules
    compute them, in float32 on the state dict's device. `store` rounds
    every operand of every product to that dtype first (the float8
    control); `faults` plants NETWORK_FAULTS. `cfg` holds the sizes:
    width, depth, heads, mlp, patch, image, window, global_blocks, neck,
    and `decoder` (width, depth, heads, mlp, downsample)."""

    def __init__(self, state: dict, cfg: dict, store=torch.float32, faults=()):
        self.s = {k: v.float() for k, v in state.items()}
        self.cfg, self.store, self.faults = cfg, store, set(faults)
        self.grid = cfg["image"] // cfg["patch"]
        # a dict to receive, per `decode`, the upscaled map ("upscaled") and
        # the last image -> token attention's weights of the point token,
        # mean over heads ("point_attention"): the seeded weights'
        # calibration reads them
        self.capture: dict | None = None

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.store == torch.float32:
            return t
        if self.store == torch.float8_e4m3fn:
            t = t.clamp(-FP8_MAX, FP8_MAX)
        return t.to(self.store).float()

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.linear(self.q(x), self.q(self.s[name + ".weight"]), self.s[name + ".bias"])

    def layer_norm(self, x: torch.Tensor, name: str, eps: float) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.s[name + ".weight"], self.s[name + ".bias"],
                            eps)

    def layer_norm_2d(self, x: torch.Tensor, name: str) -> torch.Tensor:
        u = x.mean(1, keepdim=True)
        v = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(v + EPS_ENCODER)
        return self.s[name + ".weight"][:, None, None] * x + self.s[name + ".bias"][:, None, None]

    # -- image encoder (image_encoder.py) ----------------------------------

    @staticmethod
    def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
        max_rel_dist = int(2 * max(q_size, k_size) - 1)
        if rel_pos.shape[0] != max_rel_dist:
            rel_pos = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
                                    size=max_rel_dist, mode="linear")
            rel_pos = rel_pos.reshape(-1, max_rel_dist).permute(1, 0)
        q_coords = torch.arange(q_size, device=rel_pos.device)[:, None]
        k_coords = torch.arange(k_size, device=rel_pos.device)[None, :]
        return rel_pos[(q_coords - k_coords) + (k_size - 1)]

    def attention(self, x: torch.Tensor, i: int, pad_hw=None) -> torch.Tensor:
        """SAM's `Attention` with `add_decomposed_rel_pos` on (B, H, W, C)."""
        b, h, w, _ = x.shape
        heads = self.cfg["heads"]
        p = f"image_encoder.blocks.{i}.attn"
        qkv = self.linear(x, p + ".qkv").reshape(b, h * w, 3, heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * heads, h * w, -1).unbind(0)
        scale = q.shape[-1] ** -0.5
        attn = self.q(q * scale) @ self.q(k).transpose(-2, -1)
        rh = self.get_rel_pos(h, h, self.s[p + ".rel_pos_h"])
        rw = self.get_rel_pos(w, w, self.s[p + ".rel_pos_w"])
        r_q = self.q(q).reshape(b * heads, h, w, -1)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, self.q(rh))
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, self.q(rw))
        attn = (attn.view(b * heads, h, w, h, w) + rel_h[:, :, :, :, None]
                + rel_w[:, :, :, None, :]).view(b * heads, h * w, h * w)
        if pad_hw is not None and "pad_keys_masked" in self.faults:
            attn = attn + pad_hw.view(-1, 1, 1, h * w).expand(-1, heads, 1, -1).reshape(
                b * heads, 1, h * w)
        attn = attn.softmax(dim=-1)
        o = (self.q(attn) @ self.q(v)).view(b, heads, h, w, -1).permute(0, 2, 3, 1, 4)
        return self.linear(o.reshape(b, h, w, -1), p + ".proj")

    def block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """SAM's `Block`: windowed (explicit `window_partition` with zero
        padding, `window_unpartition` with the crop) or global."""
        p = f"image_encoder.blocks.{i}."
        width, win = self.cfg["width"], self.cfg["window"]
        shortcut = x
        x = self.layer_norm(x, p + "norm1", EPS_ENCODER)
        if win > 0 and i not in self.cfg["global_blocks"]:
            b, h, w, c = x.shape
            pad_h, pad_w = (win - h % win) % win, (win - w % win) % win
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
            hp, wp = h + pad_h, w + pad_w
            windows = x.view(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
            windows = windows.reshape(-1, win, win, c)
            # -inf on the pad keys, for the planted fault only
            pad = torch.zeros((b, hp, wp), device=x.device)
            pad[:, h:, :] = -math.inf
            pad[:, :, w:] = -math.inf
            pad = pad.view(b, hp // win, win, wp // win, win).permute(0, 1, 3, 2, 4)
            x = self.attention(windows, i, pad.reshape(-1, win, win))
            x = x.view(b, hp // win, wp // win, win, win, -1).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(b, hp, wp, -1)[:, :h, :w, :].contiguous()
        else:
            x = self.attention(x, i)
        x = shortcut + x
        h = self.layer_norm(x, p + "norm2", EPS_ENCODER)
        h = F.gelu(self.linear(h, p + "mlp.lin1"))
        return x + self.linear(h, p + "mlp.lin2")

    def encode(self, image: torch.Tensor) -> torch.Tensor:
        """(1, 3, image, image) normalised image -> (1, neck, grid, grid)."""
        s = self.s
        x = F.conv2d(self.q(image), self.q(s["image_encoder.patch_embed.proj.weight"]),
                     s["image_encoder.patch_embed.proj.bias"], stride=self.cfg["patch"])
        x = x.permute(0, 2, 3, 1) + s["image_encoder.pos_embed"]
        for i in range(self.cfg["depth"]):
            x = self.block(x, i)
        x = F.conv2d(self.q(x.permute(0, 3, 1, 2)), self.q(s["image_encoder.neck.0.weight"]))
        x = self.layer_norm_2d(x, "image_encoder.neck.1")
        x = F.conv2d(self.q(x), self.q(s["image_encoder.neck.2.weight"]), padding=1)
        return self.layer_norm_2d(x, "image_encoder.neck.3")

    # -- prompt encoder (prompt_encoder.py) --------------------------------

    def pe_encoding(self, coords: torch.Tensor) -> torch.Tensor:
        coords = 2 * coords - 1
        coords = coords @ self.s["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
        coords = 2 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def dense_pe(self) -> torch.Tensor:
        g = self.grid
        grid = torch.ones((g, g), device=self.s["prompt_encoder.no_mask_embed.weight"].device)
        y_embed = (grid.cumsum(dim=0) - 0.5) / g
        x_embed = (grid.cumsum(dim=1) - 0.5) / g
        return self.pe_encoding(torch.stack([x_embed, y_embed], dim=-1)).permute(2, 0, 1)[None]

    def embed_points(self, points: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        points = points + 0.5
        padding_point = torch.zeros((points.shape[0], 1, 2), device=points.device)
        padding_label = -torch.ones((labels.shape[0], 1), device=labels.device)
        points = torch.cat([points, padding_point], dim=1)
        labels = torch.cat([labels, padding_label], dim=1)
        coords = points.clone()
        coords[:, :, 0] = coords[:, :, 0] / self.cfg["image"]
        coords[:, :, 1] = coords[:, :, 1] / self.cfg["image"]
        emb = self.pe_encoding(coords.float())
        emb[labels == -1] = 0.0
        emb[labels == -1] += self.s["prompt_encoder.not_a_point_embed.weight"]
        emb[labels == 0] += self.s["prompt_encoder.point_embeddings.0.weight"]
        emb[labels == 1] += self.s["prompt_encoder.point_embeddings.1.weight"]
        return emb

    # -- mask decoder (mask_decoder.py, transformer.py) --------------------

    def decoder_attention(self, name: str, q, k, v, heads: int) -> torch.Tensor:
        q, k, v = (self.linear(t, f"{name}.{n}_proj") for t, n in ((q, "q"), (k, "k"), (v, "v")))

        def separate(x):
            b, n, c = x.shape
            return x.reshape(b, n, heads, c // heads).transpose(1, 2)

        q, k, v = separate(q), separate(k), separate(v)
        attn = self.q(q) @ self.q(k).permute(0, 1, 3, 2)
        attn = torch.softmax(attn / math.sqrt(q.shape[-1]), dim=-1)
        if self.capture is not None and name.endswith("cross_attn_image_to_token"):
            self.capture["point_attention"] = attn[..., 5].mean(1)  # the point's token
        out = self.q(attn) @ self.q(v)
        b, h, n, c = out.shape
        return self.linear(out.transpose(1, 2).reshape(b, n, h * c), f"{name}.out_proj")

    def two_way(self, image_embedding, image_pe, point_embedding):
        d = self.cfg["decoder"]
        t = "mask_decoder.transformer."
        image_embedding = image_embedding.flatten(2).permute(0, 2, 1)
        image_pe = image_pe.flatten(2).permute(0, 2, 1)
        queries, keys = point_embedding, image_embedding
        for layer in range(d["depth"]):
            p = f"{t}layers.{layer}."
            if layer == 0 and "block0_residual" not in self.faults:  # skip_first_layer_pe
                queries = self.decoder_attention(p + "self_attn", queries, queries, queries,
                                                 d["heads"])
            elif layer == 0:
                queries = queries + self.decoder_attention(p + "self_attn", queries, queries,
                                                           queries, d["heads"])
            else:
                q = queries + point_embedding
                queries = queries + self.decoder_attention(p + "self_attn", q, q, queries,
                                                           d["heads"])
            queries = self.layer_norm(queries, p + "norm1", EPS_DECODER)
            q, k = queries + point_embedding, keys + image_pe
            queries = queries + self.decoder_attention(p + "cross_attn_token_to_image", q, k,
                                                       keys, d["heads"])
            queries = self.layer_norm(queries, p + "norm2", EPS_DECODER)
            mlp = self.linear(F.relu(self.linear(queries, p + "mlp.lin1")), p + "mlp.lin2")
            queries = self.layer_norm(queries + mlp, p + "norm3", EPS_DECODER)
            q, k = queries + point_embedding, keys + image_pe
            keys = keys + self.decoder_attention(p + "cross_attn_image_to_token", k, q, queries,
                                                 d["heads"])
            keys = self.layer_norm(keys, p + "norm4", EPS_DECODER)
        q, k = queries + point_embedding, keys + image_pe
        queries = queries + self.decoder_attention(t + "final_attn_token_to_image", q, k, keys,
                                                   d["heads"])
        return self.layer_norm(queries, t + "norm_final_attn", EPS_DECODER), keys

    def mlp_head(self, x, name: str, layers: int = 3):
        for i in range(layers):
            x = self.linear(x, f"{name}.layers.{i}")
            if i < layers - 1:
                x = F.relu(x)
        return x

    def decode(self, image_embeddings: torch.Tensor, points: torch.Tensor):
        """`SamPredictor.predict_torch` of P points (P, 2) in the input
        frame, multimask: (P, 3, 4 grid, 4 grid) logits, (P, 3) IoUs."""
        s, md = self.s, "mask_decoder."
        labels = torch.ones((points.shape[0], 1), device=points.device)
        sparse = self.embed_points(points[:, None, :].float(), labels)
        dense = s["prompt_encoder.no_mask_embed.weight"].reshape(1, -1, 1, 1).expand(
            1, -1, self.grid, self.grid)
        output_tokens = torch.cat([s[md + "iou_token.weight"], s[md + "mask_tokens.weight"]])
        output_tokens = output_tokens.unsqueeze(0).expand(sparse.size(0), -1, -1)
        tokens = torch.cat((output_tokens, sparse), dim=1)
        src = torch.repeat_interleave(image_embeddings, tokens.shape[0], dim=0)
        src = src + dense
        pos_src = torch.repeat_interleave(self.dense_pe(), tokens.shape[0], dim=0)
        b, c, h, w = src.shape
        hs, src = self.two_way(src, pos_src, tokens)
        iou_token_out = hs[:, 0, :]
        mask_tokens_out = hs[:, 1:5, :]
        src = src.transpose(1, 2).reshape(b, c, h, w)
        up = F.conv_transpose2d(self.q(src), self.q(s[md + "output_upscaling.0.weight"]),
                                s[md + "output_upscaling.0.bias"], stride=2)
        up = F.gelu(self.layer_norm_2d(up, md + "output_upscaling.1"))
        up = F.conv_transpose2d(self.q(up), self.q(s[md + "output_upscaling.3.weight"]),
                                s[md + "output_upscaling.3.bias"], stride=2)
        up = F.gelu(up)
        if self.capture is not None:
            self.capture["upscaled"] = up
        hyper_in = torch.stack([self.mlp_head(mask_tokens_out[:, i, :],
                                              f"{md}output_hypernetworks_mlps.{i}")
                                for i in range(4)], dim=1)
        b, c, h, w = up.shape
        masks = (self.q(hyper_in) @ self.q(up).view(b, c, h * w)).view(b, -1, h, w)
        iou_pred = self.mlp_head(iou_token_out, md + "iou_prediction_head")
        return masks[:, 1:], iou_pred[:, 1:]


# -- the automatic mask generator (automatic_mask_generator.py, utils/amg.py)

def build_point_grid(n_per_side: int) -> np.ndarray:
    offset = 1 / (2 * n_per_side)
    points_one_side = np.linspace(offset, 1 - offset, n_per_side)
    points_x = np.tile(points_one_side[None, :], (n_per_side, 1))
    points_y = np.tile(points_one_side[:, None], (1, n_per_side))
    return np.stack([points_x, points_y], axis=-1).reshape(-1, 2)


def preprocess_shape(oldh: int, oldw: int, long_side_length: int) -> tuple[int, int]:
    scale = long_side_length * 1.0 / max(oldh, oldw)
    return int(oldh * scale + 0.5), int(oldw * scale + 0.5)


def sam_image(stretched: torch.Tensor, size: int) -> torch.Tensor:
    """(H, W, 3) planes in [0, 1] -> (1, 3, size, size): uint8 by rounding,
    `ResizeLongestSide` (PyTorch's antialiased bilinear), rounded again,
    SAM's normalisation, the pad."""
    h, w, _ = stretched.shape
    x = torch.round(stretched.float() * 255.0).permute(2, 0, 1)[None]
    nh, nw = preprocess_shape(h, w, size)
    if (nh, nw) != (h, w):
        x = F.interpolate(x, (nh, nw), mode="bilinear", align_corners=False, antialias=True)
        x = torch.round(x).clamp(0.0, 255.0)
    mean = torch.tensor(PIXEL_MEAN, device=x.device).view(-1, 1, 1)
    std = torch.tensor(PIXEL_STD, device=x.device).view(-1, 1, 1)
    return F.pad((x - mean) / std, (0, size - nw, 0, size - nh))


def postprocess_masks(masks: torch.Tensor, size: int, input_size, original_size):
    masks = F.interpolate(masks, (size, size), mode="bilinear", align_corners=False)
    masks = masks[..., : input_size[0], : input_size[1]]
    return F.interpolate(masks, original_size, mode="bilinear", align_corners=False)


def calculate_stability_score(masks: torch.Tensor, mask_threshold: float, offset: float):
    intersections = (masks > (mask_threshold + offset)).sum(-1, dtype=torch.int16).sum(
        -1, dtype=torch.int32)
    unions = (masks > (mask_threshold - offset)).sum(-1, dtype=torch.int16).sum(
        -1, dtype=torch.int32)
    return intersections / unions


def batched_mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    if torch.numel(masks) == 0:
        return torch.zeros(*masks.shape[:-2], 4, device=masks.device)
    h, w = masks.shape[-2:]
    in_height, _ = torch.max(masks, dim=-1)
    in_height_coords = in_height * torch.arange(h, device=in_height.device)[None, :]
    bottom_edges, _ = torch.max(in_height_coords, dim=-1)
    in_height_coords = in_height_coords + h * (~in_height)
    top_edges, _ = torch.min(in_height_coords, dim=-1)
    in_width, _ = torch.max(masks, dim=-2)
    in_width_coords = in_width * torch.arange(w, device=in_width.device)[None, :]
    right_edges, _ = torch.max(in_width_coords, dim=-1)
    in_width_coords = in_width_coords + w * (~in_width)
    left_edges, _ = torch.min(in_width_coords, dim=-1)
    empty_filter = (right_edges < left_edges) | (bottom_edges < top_edges)
    out = torch.stack([left_edges, top_edges, right_edges, bottom_edges], dim=-1)
    return out * (~empty_filter).unsqueeze(-1)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.max(a[:, None, :2], b[:, :2])
    rb = torch.min(a[:, None, 2:], b[:, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[:, :, 0] * wh[:, :, 1]
    return inter / (area_a[:, None] + area_b - inter)


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, threshold: float) -> list[int]:
    """torchvision's `nms` one box at a time: in decreasing score (ties by
    index), keep a box unless a kept one overlaps it by IoU > threshold."""
    order = torch.sort(scores.cpu(), descending=True, stable=True).indices.tolist()
    boxes = boxes.float().cpu()
    kept: list[int] = []
    for i in order:
        if not kept or not bool((box_iou(boxes[i : i + 1], boxes[kept]) > threshold).any()):
            kept.append(i)
    return kept


def mask_data_to_segmentation(masks: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """micro-SAM's painting: masks (in NMS order) sorted by area, largest
    first (Python's stable sort), painted in turn with ids 1, 2, ...;
    `reverse` paints in the opposite order (a planted fault)."""
    areas = masks.sum((-1, -2)).tolist()
    order = sorted(range(len(areas)), key=lambda i: areas[i], reverse=True)
    if reverse:
        order = order[::-1]
    seg = torch.zeros(masks.shape[1:], dtype=torch.int32, device=masks.device)
    for seg_id, i in enumerate(order, start=1):
        seg[masks[i]] = seg_id
    return seg


def amg_settings(cfg: dict) -> dict:
    return {k: cfg[k] for k in ("points_per_side", "points_per_batch", "pred_iou_thresh",
                                "stability_score_thresh", "stability_score_offset",
                                "box_nms_thresh")}


def generate(sam: Sam, stretched: torch.Tensor, cfg: dict) -> dict:
    """`SamAutomaticMaskGenerator.generate` with one crop on (H, W, 3)
    planes, then the painting: "labels", the float32 "iou_preds" and
    "stability" of every candidate (NaN where the IoU filter dropped it),
    and the float32 low-resolution "logits" of every candidate (P * 3, h,
    w), on the host."""
    a = amg_settings(cfg)
    size = cfg["image"]
    h, w = stretched.shape[:2]
    input_size = preprocess_shape(h, w, size)
    with torch.no_grad():
        embedding = sam.encode(sam_image(stretched, size))
        points = build_point_grid(a["points_per_side"]) * np.array([w, h])
        n = len(points)
        iou_all = torch.empty(3 * n)
        stab_all = torch.full((3 * n,), float("nan"))
        logits_all = torch.empty((3 * n, 4 * sam.grid, 4 * sam.grid))
        keep_masks, keep_boxes, keep_scores = [], [], []
        for start in range(0, n, a["points_per_batch"]):
            batch = points[start : start + a["points_per_batch"]]
            transformed = batch * np.array([input_size[1] / w, input_size[0] / h])
            in_points = torch.as_tensor(transformed, device=embedding.device)
            low, iou = sam.decode(embedding, in_points)
            masks = postprocess_masks(low, size, input_size, (h, w)).flatten(0, 1)
            iou = iou.flatten()
            first = 3 * start
            idx = torch.arange(first, first + len(iou), device=iou.device)
            iou_all[first : first + len(iou)] = iou.cpu()
            logits_all[first : first + len(iou)] = low.flatten(0, 1).cpu()
            keep = iou > a["pred_iou_thresh"]
            masks, iou, idx = masks[keep], iou[keep], idx[keep]
            stab = calculate_stability_score(masks, 0.0, a["stability_score_offset"])
            stab_all[idx.cpu()] = stab.cpu()
            keep = stab >= a["stability_score_thresh"]
            masks, iou = masks[keep] > 0.0, iou[keep]
            keep_masks.append(masks)
            keep_boxes.append(batched_mask_to_box(masks))
            keep_scores.append(iou)
        masks = torch.cat(keep_masks)
        kept = greedy_nms(torch.cat(keep_boxes), torch.cat(keep_scores), a["box_nms_thresh"])
        labels = mask_data_to_segmentation(masks[kept])
    return {"labels": labels.cpu().numpy(), "iou_preds": iou_all, "stability": stab_all,
            "logits": logits_all}


def tail(low: torch.Tensor, iou: torch.Tensor, cfg: dict, hw: tuple[int, int],
         faults=()) -> torch.Tensor:
    """The AMG's tail on given survivors: (K, h, w) low-resolution logits and
    their (K,) predicted IoUs -> (H, W) int32 labels: upsampling, the
    stability filter, the masks and boxes, NMS (at 0.5 with the planted
    fault "nms_0.5") and the painting (reversed with "paint_reversed")."""
    a = amg_settings(cfg)
    size = cfg["image"]
    input_size = preprocess_shape(hw[0], hw[1], size)
    with torch.no_grad():
        up = postprocess_masks(low.float()[:, None], size, input_size, hw)[:, 0]
        stab = calculate_stability_score(up, 0.0, a["stability_score_offset"])
        keep = stab >= a["stability_score_thresh"]
        masks, iou = up[keep] > 0.0, iou[keep]
        threshold = 0.5 if "nms_0.5" in faults else a["box_nms_thresh"]
        kept = greedy_nms(batched_mask_to_box(masks), iou, threshold)
        return mask_data_to_segmentation(masks[kept], reverse="paint_reversed" in faults)


def _stretched(pool: np.ndarray, k: int, config: dict, device) -> torch.Tensor:
    """Pool image k's three planes stretched: (H, W, 3) float32."""
    ar = classical._Arith("reference")
    planes = torch.from_numpy(pool[k, config["channels"]].astype(np.int32)).to(device)
    return torch.stack([unet.stretch(p, ar) for p in planes]).float().permute(1, 2, 0)


def _generated(pool: np.ndarray, config: dict, device, stages: dict):
    with unet.no_tf32():
        sam = Sam(sam_amg_weights.seeded_state(config, pool, device), config,
                  FORWARD[stages.get("forward", "reference")],
                  [stages["network"]] if "network" in stages else ())
        for k in range(len(pool)):
            yield generate(sam, _stretched(pool, k, config, device), config)


# the last plain reference computed: (pool, config, device, outputs); the
# controls that plant a fault only after the network (of the filters or the
# tail) start from these outputs instead of computing them again
_LAST: list = []


def reference_outputs(pool: np.ndarray, config: dict, device, stages: dict | None = None):
    """Each pool image's `generate` result (host tensors; the logits of
    every candidate in float32)."""
    outputs = list(_generated(pool, config, device, stages or {}))
    if not stages:
        _LAST[:] = [pool, config, device, outputs]
    return outputs


def _network_outputs(pool: np.ndarray, config: dict, device, stages: dict) -> list:
    """The network's outputs under `stages`: the plain reference's last
    ones where `stages` changes nothing before the filters and they were of
    this pool, configuration and device."""
    if ("forward" not in stages and "network" not in stages and _LAST
            and _LAST[0] is pool and _LAST[1] == config and _LAST[2] == device):
        return _LAST[3]
    return list(_generated(pool, config, device, stages))


def _as_program(ref: dict, config: dict, hw, device, stages: dict) -> tuple:
    """A reference result in the program's form: (labels, candidates), with
    the planted fault of the filters or of the tail that `stages` names."""
    iou, stab = ref["iou_preds"], ref["stability"]
    if stages.get("filter") == "iou_thresh_0.95":
        stab = torch.where(iou > 0.95, stab, torch.full_like(stab, float("nan")))
    kept = torch.nonzero(stab >= config["stability_score_thresh"]).flatten()
    if stages.get("filter") == "survivors_halved":
        kept = kept[::2]
    labels = ref["labels"]
    if "filter" in stages or "tail" in stages:
        faults = [stages["tail"]] if "tail" in stages else ()
        labels = tail(ref["logits"][kept].to(device), iou[kept].to(device), config, hw,
                      faults).cpu().numpy()
    return labels, {"iou_preds": iou.numpy(), "stability": stab.numpy(), "kept": kept.numpy(),
                    "logits": ref["logits"][kept]}


def control_outputs(pool: np.ndarray, config: dict, device, name: str):
    """Control `name` in the program's place: (pool index, (labels, candidates))."""
    stages = LOWERED[name]
    hw = pool.shape[-2:]
    return [(k, _as_program(r, config, hw, device, stages))
            for k, r in enumerate(_network_outputs(pool, config, device, stages))]


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return float("inf")
    d = (a.double() - b.double()).abs()
    return float(d.max()) if d.numel() else 0.0


def _kept_mask(kept: torch.Tensor, n: int) -> tuple[torch.Tensor, int]:
    """(n,) bool of the candidates in `kept`, and how many of its indices
    repeat an earlier one or lie out of range."""
    inside = kept[(kept >= 0) & (kept < n)]
    mask = torch.zeros(n, dtype=torch.bool)
    mask[inside] = True
    return mask, len(kept) - int(mask.sum())


def _decisions(cand: dict, ref: dict, config: dict) -> tuple[float, float]:
    """`filter_errors` and `decision_gap` of one answer (inf where its
    arrays do not match the reference's in shape)."""
    iou = torch.as_tensor(np.asarray(cand["iou_preds"]))
    stab = torch.as_tensor(np.asarray(cand["stability"]))
    n = ref["iou_preds"].numel()
    if iou.shape != ref["iou_preds"].shape or stab.shape != ref["stability"].shape:
        return float("inf"), float("inf")
    kept, extra = _kept_mask(torch.as_tensor(np.asarray(cand["kept"])).long().flatten(), n)
    # the program's float32 numbers against the thresholds, as it compares them
    scored = torch.isfinite(stab)
    stable = scored & (stab.float() >= config["stability_score_thresh"])
    errors = (int((scored & ~(iou.float() > config["pred_iou_thresh"])).sum())
              + int((kept != stable).sum()) + extra)
    ref_scored = torch.isfinite(ref["stability"])
    ref_kept = ref_scored & (ref["stability"] >= config["stability_score_thresh"])
    differs = (scored != ref_scored) | (kept != ref_kept)
    return float(errors), float(differs.sum()) / max(n, 1)


def _gaps(cand: dict, ref: dict, device) -> tuple[float, torch.Tensor, float]:
    """`iou_gap`, the stability gaps of the candidates both sides scored,
    and the answer's `logit_gap` (MASK_QUANTILE over its surviving masks)."""
    iou = torch.as_tensor(np.asarray(cand["iou_preds"]))
    iou_gap = _max_abs(iou, ref["iou_preds"])
    if not math.isfinite(iou_gap):
        iou_gap = float("inf")
    stab = torch.as_tensor(np.asarray(cand["stability"]))
    inf = torch.full((1,), float("inf"), dtype=torch.float64)
    if stab.shape != ref["stability"].shape:
        return iou_gap, inf, float("inf")
    both = torch.isfinite(stab) & torch.isfinite(ref["stability"])
    stab_gap = (stab[both].double() - ref["stability"][both].double()).abs()
    kept = torch.as_tensor(np.asarray(cand["kept"])).long()
    logits = torch.as_tensor(cand["logits"]).float()
    if len(kept) == 0:
        return iou_gap, stab_gap, 0.0
    if (logits.shape[0] != len(kept) or not torch.isfinite(logits).all()
            or bool(((kept < 0) | (kept >= ref["logits"].shape[0])).any())):
        return iou_gap, stab_gap, float("inf")
    p = logits.to(device).flatten(1)
    r = ref["logits"][kept].to(device).flatten(1)
    d = (p - r).abs()
    kth = min(d.shape[1], max(1, int(np.ceil(LOGIT_QUANTILE * d.shape[1]))))
    rms = r.pow(2).mean(dim=1).sqrt().clamp_min(1e-12)
    per_mask = (d.kthvalue(kth, dim=1).values / rms).double().cpu()
    return iou_gap, stab_gap, float(torch.quantile(per_mask, MASK_QUANTILE))


def _labels_table(labels, img: torch.Tensor, device) -> dict:
    lab = (labels if isinstance(labels, torch.Tensor) else torch.from_numpy(np.asarray(labels)))
    lab = lab.to(device).long()
    _, seq = torch.unique(lab, return_inverse=True)  # ids 1, 2, ... of the labels present
    seq = seq if bool((lab == 0).any()) else seq + 1
    return _table(seq.view(lab.shape), img, 1)


def _same(a: tuple, b: tuple) -> bool:
    (la, ca), (lb, cb) = a, b
    return (np.array_equal(la, lb) and np.array_equal(ca["kept"], cb["kept"])
            and np.array_equal(ca["iou_preds"], cb["iou_preds"], equal_nan=True)
            and torch.equal(torch.as_tensor(ca["logits"]), torch.as_tensor(cb["logits"])))


def compare(outputs, refs, pool: np.ndarray, config: dict, device) -> dict[str, float]:
    """The continuous gaps of the returned candidates against the
    reference's, the filters' decisions against the answer's own numbers
    and against the reference's; `mask_gap` and `centroid_gap` of the
    returned labels against the reference's tail on the program's own
    survivors. An image that never came back (None) is the harness's to
    count; an answer equal to one already compared for its image is not
    compared again."""
    iou_gap = logit_gap = filter_errors = decision_gap = 0.0
    per_candidate = [torch.zeros(0, dtype=torch.float64)]
    progs, ref_tables = [], []
    seen: dict[int, list] = {}
    hw = pool.shape[-2:]
    for k, got in outputs:
        if got is None:
            continue
        known = seen.setdefault(k, [])
        hit = next((t for g, t in known if _same(g, got)), None)
        if hit is None:
            labels, cand = got
            iou, candidates, logits = _gaps(cand, refs[k], device)
            errors, differs = _decisions(cand, refs[k], config)
            iou_gap, logit_gap = max(iou_gap, iou), max(logit_gap, logits)
            filter_errors, decision_gap = max(filter_errors, errors), max(decision_gap, differs)
            per_candidate.append(candidates)
            img = torch.from_numpy(pool[k, config["channels"][0]].astype(np.int32)).to(device)
            kept = torch.as_tensor(np.asarray(cand["kept"])).long()
            iou = torch.as_tensor(np.asarray(cand["iou_preds"]))[kept]
            want = tail(torch.as_tensor(cand["logits"]).to(device), iou.to(device), config, hw)
            hit = (_labels_table(labels, img, device), _labels_table(want, img, device))
            known.append((got, hit))
        progs.append((len(ref_tables), hit[0]))
        ref_tables.append(hit[1])
    t = tables.plate_gaps(progs, ref_tables)
    return {"iou_gap": iou_gap,
            "stability_gap": _pooled(per_candidate, STABILITY_QUANTILE),
            "logit_gap": logit_gap, "filter_errors": filter_errors,
            "decision_gap": decision_gap,
            "mask_gap": t["mask_gap"], "centroid_gap": t["centroid_gap"]}


def _pooled(parts: list[torch.Tensor], quantile: float) -> float:
    """`quantile` of the values of every compared answer together; inf if
    any is not finite (a NaN where a number was due, or a shape that does
    not match)."""
    v = torch.cat(parts)
    if not torch.isfinite(v).all():
        return float("inf")
    return float(torch.quantile(v, quantile)) if v.numel() else 0.0
