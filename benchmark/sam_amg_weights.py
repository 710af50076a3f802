"""Seeded Segment Anything (ViT-L) weights for the benchmark: one state dict
in SAM's published layout (`image_encoder.*`, `prompt_encoder.*`,
`mask_decoder.*`), made from the run's inputs, which the entry writes to the
run's work directory for the program and the reference remakes alike.

Neither SAM's `sam_vit_l_0b3195.pth` nor micro-SAM's `vit_l_lm` is in the
repository, so the weights are drawn on the run's device from the seed that
`sam_weights.weights_seed` hashes from the pool's first well. The recipe (the
configuration's `assumed` states it too) keeps every tensor nonzero:

- the image encoder as `sam_weights` seeds Cellpose-SAM's: each matrix
  N(0, 1 / fan_in), the q and k rows of each qkv matrix 1.5 times that,
  biases N(0, 0.02^2), LayerNorm weights 1 + N(0, 0.1^2), the
  relative-position tables N(0, 0.05^2) at their published 27 and 127 rows,
  `pos_embed` 0.2 times 3 smooth planar waves per channel over the 64 x 64
  grid;
- the prompt encoder: G N(0, 0.25^2) (SAM's own scale is 1), so that the
  likeness of two positional encodings falls smoothly with their distance
  across the whole image; the point embeddings and
  `not_a_point_embed` N(0, 0.1^2), `no_mask_embed` N(0, 0.1^2),
  `mask_downscaling` as any other layer (loaded, never run);
- the mask decoder: each matrix N(0, 1 / fan_in), biases N(0, 0.02^2),
  LayerNorm weights 1 + N(0, 0.1^2) (norm3's weight and bias times 0.1,
  block 0's norm4's times 0.1), the IoU and mask tokens N(0, 0.1^2); in both
  image -> token attentions the q and k projections are 3 times the same
  selection of positional features (`_pe_selection`: each head reads the
  sine and cosine of its own frequencies), so that a pixel's attention to
  the point token falls smoothly with its distance from the point, and the
  v projection is times 10, so that the point's value reaches the image
  tokens; the ConvTs of `output_upscaling` map each channel alike to all
  four pixels of their 2 x 2 output; the neck's last LayerNorm2d (weight
  and bias) halved. Without these a random decoder's masks cover the whole
  field and NMS keeps one of them;
- then, per seed, on the float32 reference of pool well 0 (`_calibrated`):
  the four hypernetworks' last layers made nearly prompt-independent (the
  matrix times 0.01) with the bias fitted by least squares so that mask
  token i's logit follows a - THRESHOLDS[i], a being the last image ->
  token attention's weight of the point token (head mean) over FIT_PROMPTS
  prompts: mask i is then roughly the region where the point holds more
  than THRESHOLDS[i] of a pixel's attention, around the point; then the IoU
  head's last bias shifted per mask output so that IOU_SHARE of that
  output's candidates' predicted IoUs lie above the configuration's
  `pred_iou_thresh`, and the hypernetworks' last layers scaled so that the
  median stability score of up to CALIBRATION_MASKS of those is the
  configuration's `stability_score_thresh` (about half pass), both on grids
  of 1/64 (of IoU, and of log2 of the scale) so that float noise between
  two computations of the same calibration does not move a stored weight.
Stored in bfloat16, the configuration's precision (the reference reads the
same values in float32).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.sam_weights import QK_SPREAD, _quantised, weights_seed

IOU_SHARE = 0.25  # of the candidates above the IoU threshold after calibration
CALIBRATION_MASKS = 64  # IoU survivors whose stability scores set the scale
FIT_PROMPTS = 64  # prompts, spread over the field, whose maps fit the hypernetworks
THRESHOLDS = (0.5, 0.5, 0.7, 0.85)  # of the point's attention, per mask token
PE_SCALE = 0.25
TOKEN_SPREAD = 0.1
LOCAL_QK = 3.0
LOCAL_V = 10.0
NORM3_GAIN = 0.1
NECK_GAIN = 0.5
NORM4_GAIN = 0.1
HYPER_WEIGHT = 0.01


def _attention(prefix: str, width: int, internal: int) -> dict:
    out = {f"{prefix}.{p}_proj.weight": (internal, width) for p in "qkv"}
    out.update({f"{prefix}.{p}_proj.bias": (internal,) for p in "qkv"})
    out.update({f"{prefix}.out_proj.weight": (width, internal),
                f"{prefix}.out_proj.bias": (width,)})
    return out


def _mlp(prefix: str, dims: list[int]) -> dict:
    out = {}
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        out.update({f"{prefix}.layers.{i}.weight": (b, a), f"{prefix}.layers.{i}.bias": (b,)})
    return out


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """SAM's published state dict's tensors and shapes for the sizes of `cfg`."""
    g, w, hd = cfg["image"] // cfg["patch"], cfg["width"], cfg["width"] // cfg["heads"]
    win = cfg["window"]
    ie = "image_encoder."
    out = {ie + "pos_embed": (1, g, g, w),
           ie + "patch_embed.proj.weight": (w, 3, cfg["patch"], cfg["patch"]),
           ie + "patch_embed.proj.bias": (w,)}
    for i in range(cfg["depth"]):
        p = f"{ie}blocks.{i}."
        rows = 2 * (g if i in cfg["global_blocks"] else win) - 1
        out.update({p + "norm1.weight": (w,), p + "norm1.bias": (w,),
                    p + "attn.rel_pos_h": (rows, hd), p + "attn.rel_pos_w": (rows, hd),
                    p + "attn.qkv.weight": (3 * w, w), p + "attn.qkv.bias": (3 * w,),
                    p + "attn.proj.weight": (w, w), p + "attn.proj.bias": (w,),
                    p + "norm2.weight": (w,), p + "norm2.bias": (w,),
                    p + "mlp.lin1.weight": (cfg["mlp"], w), p + "mlp.lin1.bias": (cfg["mlp"],),
                    p + "mlp.lin2.weight": (w, cfg["mlp"]), p + "mlp.lin2.bias": (w,)})
    n = cfg["neck"]
    out.update({ie + "neck.0.weight": (n, w, 1, 1), ie + "neck.1.weight": (n,),
                ie + "neck.1.bias": (n,), ie + "neck.2.weight": (n, n, 3, 3),
                ie + "neck.3.weight": (n,), ie + "neck.3.bias": (n,)})
    d = cfg["decoder"]
    dw, half = d["width"], d["width"] // d["downsample"]
    pe = "prompt_encoder."
    out[pe + "pe_layer.positional_encoding_gaussian_matrix"] = (2, dw // 2)
    out.update({f"{pe}point_embeddings.{i}.weight": (1, dw) for i in range(4)})
    out.update({pe + "not_a_point_embed.weight": (1, dw),
                pe + "mask_downscaling.0.weight": (4, 1, 2, 2),
                pe + "mask_downscaling.0.bias": (4,),
                pe + "mask_downscaling.1.weight": (4,), pe + "mask_downscaling.1.bias": (4,),
                pe + "mask_downscaling.3.weight": (16, 4, 2, 2),
                pe + "mask_downscaling.3.bias": (16,),
                pe + "mask_downscaling.4.weight": (16,), pe + "mask_downscaling.4.bias": (16,),
                pe + "mask_downscaling.6.weight": (dw, 16, 1, 1),
                pe + "mask_downscaling.6.bias": (dw,), pe + "no_mask_embed.weight": (1, dw)})
    md = "mask_decoder."
    for layer in range(d["depth"]):
        p = f"{md}transformer.layers.{layer}."
        out.update(_attention(p + "self_attn", dw, dw))
        out.update(_attention(p + "cross_attn_token_to_image", dw, half))
        out.update(_attention(p + "cross_attn_image_to_token", dw, half))
        out.update({p + "mlp.lin1.weight": (d["mlp"], dw), p + "mlp.lin1.bias": (d["mlp"],),
                    p + "mlp.lin2.weight": (dw, d["mlp"]), p + "mlp.lin2.bias": (dw,)})
        out.update({f"{p}norm{k}.{leaf}": (dw,) for k in range(1, 5)
                    for leaf in ("weight", "bias")})
    out.update(_attention(md + "transformer.final_attn_token_to_image", dw, half))
    out.update({md + "transformer.norm_final_attn.weight": (dw,),
                md + "transformer.norm_final_attn.bias": (dw,),
                md + "iou_token.weight": (1, dw), md + "mask_tokens.weight": (4, dw),
                md + "output_upscaling.0.weight": (dw, dw // 4, 2, 2),
                md + "output_upscaling.0.bias": (dw // 4,),
                md + "output_upscaling.1.weight": (dw // 4,),
                md + "output_upscaling.1.bias": (dw // 4,),
                md + "output_upscaling.3.weight": (dw // 4, dw // 8, 2, 2),
                md + "output_upscaling.3.bias": (dw // 8,)})
    for i in range(4):
        out.update(_mlp(f"{md}output_hypernetworks_mlps.{i}", [dw, dw, dw, dw // 8]))
    out.update(_mlp(md + "iou_prediction_head", [dw, d["iou_hidden"], d["iou_hidden"], 4]))
    return out


def _pe_selection(d: dict, device) -> torch.Tensor:
    """The (internal, width) matrix whose head h reads the sine and cosine
    features of frequencies F h, ..., F h + F - 1 of the positional
    encoding (F = half a head's width): each head's q . k of two encodings
    is then the sum of cos(theta . (x - y)) over its F frequencies, which
    peaks where the two positions meet."""
    width, internal = d["width"], d["width"] // d["downsample"]
    per_head = internal // d["heads"]
    freqs, n = per_head // 2, width // 2
    out = torch.zeros((internal, width), device=device)
    for r in range(internal):
        head, j = divmod(r, per_head)
        k = head * freqs + j % freqs
        out[r, k if j < freqs else n + k] = 1.0
    return out


def _is_norm_weight(name: str, shape) -> bool:
    return name.endswith(".weight") and len(shape) == 1


def seeded_state(cfg: dict, pool: np.ndarray, device) -> dict[str, torch.Tensor]:
    """The recipe above, bfloat16 on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(weights_seed(pool))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

    grid = cfg["image"] // cfg["patch"]
    state = {}
    for name, shape in shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if name == "image_encoder.pos_embed":
            yy, xx = torch.meshgrid(torch.arange(grid, device=device),
                                    torch.arange(grid, device=device), indexing="ij")
            t = torch.zeros(shape[1:], device=device)
            for _ in range(3):
                f = torch.randint(0, 3, (2, shape[-1]), generator=gen, device=device).float()
                phase = torch.rand(shape[-1], generator=gen, device=device) * 2 * math.pi
                t += torch.sin(2 * math.pi * (f[0] * yy[..., None] + f[1] * xx[..., None]) / grid
                               + phase)
            t = (0.2 * t)[None]
        elif name.endswith("positional_encoding_gaussian_matrix"):
            t = PE_SCALE * randn(*shape)
        elif name.endswith(("embed.weight", "iou_token.weight", "mask_tokens.weight")) or (
                ".point_embeddings." in name):
            t = TOKEN_SPREAD * randn(*shape)
        elif leaf.startswith("rel_pos"):
            t = 0.05 * randn(*shape)
        elif _is_norm_weight(name, shape):
            t = 1.0 + 0.1 * randn(*shape)
        elif leaf == "weight":
            fan_in = shape[0] if "output_upscaling" in name else math.prod(shape[1:])
            t = randn(*shape) * fan_in**-0.5
            if name.endswith("attn.qkv.weight"):
                t[: 2 * shape[1]] *= QK_SPREAD
        else:
            t = 0.02 * randn(*shape)
        state[name] = t
    select = _pe_selection(cfg["decoder"], device)
    for layer in range(cfg["decoder"]["depth"]):
        p = f"mask_decoder.transformer.layers.{layer}."
        for proj in ("q_proj", "k_proj"):
            state[p + f"cross_attn_image_to_token.{proj}.weight"] = LOCAL_QK * select
        state[p + "cross_attn_image_to_token.v_proj.weight"] *= LOCAL_V
        state[p + "norm3.weight"] *= NORM3_GAIN
        state[p + "norm3.bias"] *= NORM3_GAIN
    for k in ("image_encoder.neck.3.weight", "image_encoder.neck.3.bias"):
        state[k] *= NECK_GAIN
    for k in ("norm4.weight", "norm4.bias"):
        state[f"mask_decoder.transformer.layers.0.{k}"] *= NORM4_GAIN
    for k in ("mask_decoder.output_upscaling.0.weight", "mask_decoder.output_upscaling.3.weight"):
        state[k] = state[k].mean((2, 3), keepdim=True).expand_as(state[k]) * 2.0
    state = {k: v.to(torch.bfloat16) for k, v in state.items()}
    return _calibrated(state, cfg, pool, device)


def _calibrated(state: dict, cfg: dict, pool: np.ndarray, device) -> dict:
    """The IoU head's last bias and the hypernetworks' last layers set on the
    float32 reference of pool well 0 (the module docstring)."""
    from benchmark.references import sam_amg, unet

    sam = sam_amg.Sam(state, cfg)
    h, w = pool.shape[-2:]
    size = cfg["image"]
    input_size = sam_amg.preprocess_shape(h, w, size)
    points = sam_amg.build_point_grid(cfg["points_per_side"]) * np.array([w, h])
    points = points * np.array([input_size[1] / w, input_size[0] / h])
    with unet.no_tf32(), torch.no_grad():
        embedding = sam.encode(sam_amg.sam_image(sam_amg._stretched(pool, 0, cfg, device), size))
        # the hypernetworks: logit of mask token i ~ a - THRESHOLDS[i]
        sam.capture = {}
        spread = np.linspace(0, len(points) - 1, min(FIT_PROMPTS, len(points))).round().astype(int)
        sam.decode(embedding, torch.as_tensor(points[spread], device=device))
        feats = torch.nn.functional.avg_pool2d(sam.capture["upscaled"], 4)  # (P, C, grid, grid)
        feats = feats.permute(0, 2, 3, 1).reshape(-1, feats.shape[1]).double()
        attention = sam.capture["point_attention"].reshape(-1).double()
        sam.capture = None
        for i, theta in enumerate(THRESHOLDS):
            p = f"mask_decoder.output_hypernetworks_mlps.{i}.layers.2."
            fit = torch.linalg.lstsq(feats, (attention - theta)[:, None]).solution[:, 0]
            state[p + "weight"] = (state[p + "weight"].float() * HYPER_WEIGHT).to(torch.bfloat16)
            state[p + "bias"] = fit.float().to(torch.bfloat16)
            sam.s[p + "weight"], sam.s[p + "bias"] = (state[p + "weight"].float(),
                                                     state[p + "bias"].float())
        ious, lows = [], []
        for a in range(0, len(points), cfg["points_per_batch"]):
            batch = points[a : a + cfg["points_per_batch"]]
            low, iou = sam.decode(embedding, torch.as_tensor(batch, device=device))
            ious.append(iou.flatten())
            lows.append(low.flatten(0, 1))
        iou, low = torch.cat(ious).double(), torch.cat(lows)
        # per mask output (candidate c is output c % 3 + 1): IOU_SHARE of its candidates pass
        per_output = iou.view(-1, 3)
        shift = torch.tensor([_quantised(cfg["pred_iou_thresh"] - float(
            torch.quantile(per_output[:, m], 1.0 - IOU_SHARE))) for m in range(3)],
            dtype=torch.float64, device=device)
        passed = torch.nonzero((per_output + shift).flatten() > cfg["pred_iou_thresh"]).flatten()
        pick = passed[torch.linspace(0, len(passed) - 1, min(CALIBRATION_MASKS, len(passed)),
                                     device=device).round().long()]
        up = sam_amg.postprocess_masks(low[pick][:, None], size, input_size, (h, w))[:, 0]
        offset, target = cfg["stability_score_offset"], cfg["stability_score_thresh"]

        def median_stability(log2_scale: float) -> float:
            cut = offset / 2.0**log2_scale
            score = (up > cut).sum((-1, -2)) / (up > -cut).sum((-1, -2))
            return float(torch.median(torch.nan_to_num(score, nan=0.0)))  # empty masks: 0

        lo, hi = -12.0, 12.0  # the stability score grows with the scale
        for _ in range(40):
            mid = (lo + hi) / 2
            lo, hi = (mid, hi) if median_stability(mid) < target else (lo, mid)
        scale = 2 ** _quantised((lo + hi) / 2)
    head = "mask_decoder.iou_prediction_head.layers.2.bias"  # entry 0 is the unused output 0
    state[head] = (state[head].float() + torch.cat([shift[:1], shift]).float()).to(torch.bfloat16)
    for i in range(4):
        p = f"mask_decoder.output_hypernetworks_mlps.{i}.layers.2."
        for leaf in ("weight", "bias"):
            state[p + leaf] = (state[p + leaf].float() * scale).to(torch.bfloat16)
    return state
