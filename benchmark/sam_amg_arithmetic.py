"""The yardstick's arithmetic for Segment Anything's automatic mask
generator: operations of one field's image encoder and mask decoder, and the
bounds of a windowed and of a global block's attention. Counted from the
configuration's sizes and the image shape alone, never from the program (its
counters are not read), so that a change to the program cannot move what it
is measured against. The peaks are `arithmetic.py`'s.

Per 2048 x 2048 field at the published sizes (ViT-L: width 1024, 24 blocks,
16 heads of 64, MLP 4096, patch 16 on 1024^2, 14 x 14 windows, global blocks
5, 11, 17, 23, neck 256; decoder width 256, depth 2, MLP 2048, cross
attention at 128; 32 x 32 points, 3 masks each), counting only the work the
function needs:
- encoder 2.84e12: per block 103.1e9 in the projections and the MLP; each of
  the 20 windowed blocks' attention 3.52e9 (the 4096 real queries, each
  against the 196 keys of its window, pad keys included since they are not
  masked; the padded map's 804 pad queries are cropped away and not
  counted), each of the 4 global blocks' 69.8e9 (4096 tokens); the neck
  7.0e9, the patch embedding 6.4e9;
- decoder 2.88e12: block 0's image-side projections (the k and v of the
  token -> image attention and the q of the image -> token attention, the
  same for every prompt of an image) 0.81e9 once, then 1024 prompts of
  2.81e9 each;
together 5.72e12 (2 operations per multiply-add; LayerNorm, GELU, softmax,
the upsampling, the filters, NMS and the painting left out).
"""

from __future__ import annotations

import math

from benchmark.arithmetic import H100_BF16_FLOP_PER_S, H100_HBM_BYTES_PER_S


def _grid(cfg: dict) -> int:
    return cfg["image"] // cfg["patch"]


def _windows(cfg: dict) -> int:
    """Windows of the zero-padded token map."""
    return math.ceil(_grid(cfg) / cfg["window"]) ** 2


def attention_flop(cfg: dict, windowed: bool) -> float:
    """One block's attention on one image: for each of the grid^2 real
    queries of every head, Q K^T and P V against its window's keys (or the
    whole grid's), and its two relative-position rows (side offsets each of
    height and width) against its q."""
    side = cfg["window"] if windowed else _grid(cfg)
    d, heads = cfg["width"] // cfg["heads"], cfg["heads"]
    return heads * _grid(cfg) ** 2 * (2.0 * 2 * side * side * d + 2.0 * 2 * side * d)


def attention_bytes(cfg: dict, windowed: bool) -> float:
    """One block's attention on one image in bfloat16: q, k, v read and o
    written once for the grid^2 real tokens, the two tables, and in windows
    the pad keys' k and v, which are the qkv bias: one row of each."""
    side = cfg["window"] if windowed else _grid(cfg)
    d, width = cfg["width"] // cfg["heads"], cfg["width"]
    pad = 2 * width if windowed else 0
    return 2.0 * (4 * _grid(cfg) ** 2 * width + pad + 2 * (2 * side - 1) * d)


def attention_bound_s(cfg: dict, windowed: bool) -> float:
    """Least time of one block's attention on one image: the larger of its
    operations at the bf16 peak and its bytes at the memory rate."""
    return max(attention_flop(cfg, windowed) / H100_BF16_FLOP_PER_S,
               attention_bytes(cfg, windowed) / H100_HBM_BYTES_PER_S)


def blocks(cfg: dict) -> tuple[int, int]:
    """(windowed, global) block counts."""
    n_global = sum(1 for i in range(cfg["depth"]) if i in cfg["global_blocks"])
    return cfg["depth"] - n_global, n_global


def encoder_flop(cfg: dict) -> float:
    """Model operations of one image through the encoder: patch embedding,
    every block's projections, MLP and attention, the neck."""
    n, width = _grid(cfg) ** 2, cfg["width"]
    patch = 2.0 * n * 3 * cfg["patch"] ** 2 * width
    dense = 2.0 * n * width * (3 * width + width + 2 * cfg["mlp"])
    windowed, n_global = blocks(cfg)
    attention = (windowed * attention_flop(cfg, True) + n_global * attention_flop(cfg, False))
    neck = 2.0 * n * cfg["neck"] * (width + 9 * cfg["neck"])
    return patch + cfg["depth"] * dense + attention + neck


def _decoder_attention_flop(cfg: dict, lq: int, lk: int, internal: int,
                            shared: bool = False) -> float:
    """One decoder attention of lq queries over lk keys at `internal` width:
    its q, k, v and out projections and its two products; `shared` counts
    only what one image's prompts share in block 0 (the image side: the k
    and v projections of the token -> image attention when lk is the grid,
    the q projection of the image -> token attention when lq is)."""
    c, n = cfg["decoder"]["width"], _grid(cfg) ** 2
    image_side = (2 * lk if lk == n else 0) + (lq if lq == n else 0)
    if shared:
        return 2.0 * image_side * c * internal
    proj = 2.0 * (lq * c * internal + 2 * lk * c * internal + lq * internal * c)
    return proj + 2.0 * 2 * lq * lk * internal


def image_decoder_flop(cfg: dict) -> float:
    """Model operations of the decoder that one image's prompts share: block
    0's image-side projections, computed once."""
    d = cfg["decoder"]
    t, n, ci = 7, _grid(cfg) ** 2, d["width"] // d["downsample"]
    return (_decoder_attention_flop(cfg, t, n, ci, shared=True)
            + _decoder_attention_flop(cfg, n, t, ci, shared=True))


def prompt_flop(cfg: dict) -> float:
    """Model operations of one point prompt through the mask decoder: 7
    tokens (the IoU token, 4 mask tokens, the point and the padding point)
    against grid^2 image tokens, less what its image's prompts share
    (`image_decoder_flop`)."""
    d = cfg["decoder"]
    t, n, c, ci = 7, _grid(cfg) ** 2, d["width"], d["width"] // d["downsample"]

    def attention(lq: int, lk: int, internal: int) -> float:
        return _decoder_attention_flop(cfg, lq, lk, internal)

    layer = (attention(t, t, c) + attention(t, n, ci) + 2.0 * 2 * t * c * d["mlp"]
             + attention(n, t, ci))
    final = attention(t, n, ci)
    g4 = 4 * _grid(cfg) ** 2
    upscale = 2.0 * n * c * (c // 4) * 4 + 2.0 * g4 * (c // 4) * (c // 8) * 4
    hyper = 4 * 2.0 * (2 * c * c + c * (c // 8))
    masks = 2.0 * 4 * (c // 8) * 16 * n
    iou = 2.0 * (c * d["iou_hidden"] + d["iou_hidden"] ** 2 + d["iou_hidden"] * 4)
    return (d["depth"] * layer + final + upscale + hyper + masks + iou
            - image_decoder_flop(cfg))


def field_flop(cfg: dict) -> float:
    """Model operations of one field: the encoder, the decoder's shared
    image side once, and every point prompt."""
    return (encoder_flop(cfg) + image_decoder_flop(cfg)
            + cfg["points_per_side"] ** 2 * prompt_flop(cfg))


def field_bound_s(cfg: dict) -> float:
    """One field's model operations at the bf16 peak."""
    return field_flop(cfg) / H100_BF16_FLOP_PER_S
