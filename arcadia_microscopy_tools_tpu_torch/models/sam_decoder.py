"""Segment Anything: its image encoder, prompt encoder and mask decoder, with
the mask decoder batched over a batch of point prompts.

Kirillov et al., *Segment Anything* (arXiv:2304.02643;
github.com/facebookresearch/segment-anything: `build_sam.py`,
`modeling/image_encoder.py`, `prompt_encoder.py`, `mask_decoder.py`,
`transformer.py`). `SegmentAnything(state, SamModelConfig())` is SAM with the
ViT-L encoder (`build_sam_vit_l`): width 1024, 24 blocks of 16 heads, global
blocks 5, 11, 17, 23 and 14 x 14 windows elsewhere, patch 16 on a 1024^2
input (models/vit_sam.py `ViTEncoder`, kernel 8), the neck to 256. What this
module adds, for point prompts with no mask input:

- prompt encoder: SAM's random Fourier positional encoding,
  PE(c) = [sin, cos](2 pi (2 c - 1) G) of a coordinate c in [0, 1]^2 (x
  first), G the (2, width / 2) Gaussian matrix; the dense encoding of the
  grid at its pixel centres (i + 0.5) / grid; each point prompt p (in the
  input frame) two sparse tokens: PE((p + 0.5) / image) +
  point_embeddings[1] (a foreground point), and SAM's padding point (label
  -1), `not_a_point_embed` alone; the dense embedding `no_mask_embed`
  broadcast over the grid. `mask_downscaling.*` is loaded and checked, never
  run (no mask prompts).
- mask decoder: tokens [iou_token, 4 mask tokens, 2 sparse], src = the
  image embedding + `no_mask_embed`, one copy per prompt; the two-way
  transformer (depth 2, 8 heads, MLP 2048 with ReLU, LayerNorm eps 1e-5),
  each block: token self-attention (in block 0 it replaces the queries, no
  positional encoding, no residual; in block 1 q += attn(q + pe, q + pe,
  q)), norm1; token -> image cross-attention at half width (q += attn(q +
  pe, src + pos, src)), norm2; q += MLP(q), norm3; image -> token
  cross-attention (src += attn(src + pos, q + pe, q)), norm4; then the final
  token -> image attention and `norm_final_attn`; `output_upscaling`
  (ConvT 2 x 2 stride 2 to width / 4, LayerNorm2d eps 1e-6, GELU, ConvT to
  width / 8, GELU); four hypernetwork MLPs (3 layers, ReLU between) whose
  product with the upscaled map gives 4 mask logits at 4 grid^2; the IoU
  head (3 layers, ReLU between, no sigmoid). `multimask` keeps masks and
  IoUs 1-3.

Arithmetic as models/vit_sam.py's: weights and activations in bfloat16,
products with float32 accumulation, LayerNorm and GELU statistics in float32
inside PyTorch's bfloat16 kernels, each softmax in float32. The positional
encodings are computed in float32 and rounded once to bfloat16 (a bfloat16
SAM module would multiply float32 coordinates with a bfloat16 G, which
PyTorch refuses). `dtype=torch.float32` runs the same equations in float32.

Departures from SAM's code, none of which changes what it computes:
- the ConvTs with kernel = stride = 2 run as one matrix product each and a
  pixel shuffle, channels last;
- in block 0 the image side is the same for every prompt (the embedding plus
  `no_mask_embed`, and the positional encoding), so the k and v projections
  of the token -> image attention and the q projection of the image ->
  token attention are computed once per call of `decode` and shared by
  its batch of prompts; SAM's `repeat_interleave` copies appear first in block 0's
  residual, where the prompts part ways;
- the attention runs as explicit products (the decoder's keys are 7 tokens
  one way and 4096 image tokens the other, at heads of 16 and 32).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from .vit_sam import SamConfig, ViTEncoder, encoder_shapes

__all__ = [
    "DecoderConfig",
    "SamModelConfig",
    "SegmentAnything",
    "decoder_shapes",
    "published_shapes",
    "seeded_state_dict",
]

DECODER_LN_EPS = 1e-5
LN2D_EPS = 1e-6
MASK_TOKENS = 4  # multimask outputs + 1
MASK_IN_CHANS = 16  # the prompt encoder's mask_downscaling, loaded and unused
# SAM's pixel normalisation of the uint8 RGB input
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def _vit_l() -> SamConfig:
    return SamConfig(width=1024, depth=24, heads=16, mlp=4096, patch=16, tile=1024, neck=256,
                     global_blocks=(5, 11, 17, 23), window=14)


@dataclass(frozen=True)
class DecoderConfig:
    """The prompt encoder's and mask decoder's sizes; the defaults are SAM's."""

    width: int = 256  # the transformer's and the prompt embeddings' width
    depth: int = 2
    heads: int = 8
    mlp: int = 2048
    downsample: int = 2  # the cross-attentions' internal width is width / downsample
    iou_hidden: int = 256


@dataclass(frozen=True)
class SamModelConfig:
    """SAM's sizes: the image encoder's (`image.tile` is the input side,
    1024) and the decoder's."""

    image: SamConfig = field(default_factory=_vit_l)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)


def _attention_shapes(prefix: str, width: int, internal: int) -> dict[str, tuple[int, ...]]:
    out = {}
    for proj in ("q_proj", "k_proj", "v_proj"):
        out[f"{prefix}.{proj}.weight"] = (internal, width)
        out[f"{prefix}.{proj}.bias"] = (internal,)
    out[f"{prefix}.out_proj.weight"] = (width, internal)
    out[f"{prefix}.out_proj.bias"] = (width,)
    return out


def _mlp_shapes(prefix: str, dims: list[int]) -> dict[str, tuple[int, ...]]:
    out = {}
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        out[f"{prefix}.layers.{i}.weight"] = (b, a)
        out[f"{prefix}.layers.{i}.bias"] = (b,)
    return out


def decoder_shapes(config: SamModelConfig) -> dict[str, tuple[int, ...]]:
    """The prompt encoder's and mask decoder's tensors in SAM's published
    layout (`prompt_encoder.*`, `mask_decoder.*`) with their shapes."""
    d = config.decoder
    w, half = d.width, d.width // d.downsample
    pe = "prompt_encoder."
    shapes = {pe + "pe_layer.positional_encoding_gaussian_matrix": (2, w // 2)}
    for i in range(4):
        shapes[f"{pe}point_embeddings.{i}.weight"] = (1, w)
    shapes[pe + "not_a_point_embed.weight"] = (1, w)
    m4, m16 = MASK_IN_CHANS // 4, MASK_IN_CHANS
    shapes.update({
        pe + "mask_downscaling.0.weight": (m4, 1, 2, 2), pe + "mask_downscaling.0.bias": (m4,),
        pe + "mask_downscaling.1.weight": (m4,), pe + "mask_downscaling.1.bias": (m4,),
        pe + "mask_downscaling.3.weight": (m16, m4, 2, 2), pe + "mask_downscaling.3.bias": (m16,),
        pe + "mask_downscaling.4.weight": (m16,), pe + "mask_downscaling.4.bias": (m16,),
        pe + "mask_downscaling.6.weight": (w, m16, 1, 1), pe + "mask_downscaling.6.bias": (w,),
        pe + "no_mask_embed.weight": (1, w),
    })
    md = "mask_decoder."
    for layer in range(d.depth):
        p = f"{md}transformer.layers.{layer}."
        shapes.update(_attention_shapes(p + "self_attn", w, w))
        shapes.update(_attention_shapes(p + "cross_attn_token_to_image", w, half))
        shapes.update(_attention_shapes(p + "cross_attn_image_to_token", w, half))
        shapes.update({p + "mlp.lin1.weight": (d.mlp, w), p + "mlp.lin1.bias": (d.mlp,),
                       p + "mlp.lin2.weight": (w, d.mlp), p + "mlp.lin2.bias": (w,)})
        for n in range(1, 5):
            shapes[f"{p}norm{n}.weight"] = (w,)
            shapes[f"{p}norm{n}.bias"] = (w,)
    shapes.update(_attention_shapes(md + "transformer.final_attn_token_to_image", w, half))
    shapes.update({md + "transformer.norm_final_attn.weight": (w,),
                   md + "transformer.norm_final_attn.bias": (w,),
                   md + "iou_token.weight": (1, w), md + "mask_tokens.weight": (MASK_TOKENS, w),
                   md + "output_upscaling.0.weight": (w, w // 4, 2, 2),
                   md + "output_upscaling.0.bias": (w // 4,),
                   md + "output_upscaling.1.weight": (w // 4,),
                   md + "output_upscaling.1.bias": (w // 4,),
                   md + "output_upscaling.3.weight": (w // 4, w // 8, 2, 2),
                   md + "output_upscaling.3.bias": (w // 8,)})
    for i in range(MASK_TOKENS):
        shapes.update(_mlp_shapes(f"{md}output_hypernetworks_mlps.{i}", [w, w, w, w // 8]))
    shapes.update(_mlp_shapes(md + "iou_prediction_head", [w, d.iou_hidden, d.iou_hidden,
                                                           MASK_TOKENS]))
    return shapes


def published_shapes(config: SamModelConfig = SamModelConfig()) -> dict[str, tuple[int, ...]]:
    """Every tensor of SAM's published state dict (`sam_vit_l_0b3195.pth`'s
    layout at the default sizes) with its shape."""
    return {**encoder_shapes(config.image, "image_encoder."), **decoder_shapes(config)}


# the tensors that are vectors to add, not maps to apply
_EMBEDDINGS = ("embed.weight", "point_embeddings.0.weight", "point_embeddings.1.weight",
               "point_embeddings.2.weight", "point_embeddings.3.weight", "iou_token.weight",
               "mask_tokens.weight")


def seeded_state_dict(config: SamModelConfig = SamModelConfig(),
                      generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """An untrained state dict in the published layout: each matrix and
    convolution N(0, 1 / fan_in) (a transposed convolution's fan-in is its
    input channels), each norm's weight 1 + N(0, 0.1^2), G N(0, 1) (SAM's
    scale), every other tensor (biases, embeddings, tokens) N(0, 0.02^2)."""
    out = {}
    for name, shape in published_shapes(config).items():
        t = torch.randn(shape, generator=generator)
        if name.endswith("positional_encoding_gaussian_matrix"):
            pass
        elif name.endswith(".weight") and len(shape) == 1:
            t = 1.0 + 0.1 * t
        elif name.endswith(".weight") and not name.endswith(_EMBEDDINGS):
            t = t * (shape[0] if "output_upscaling" in name else math.prod(shape[1:])) ** -0.5
        else:
            t = 0.02 * t
        out[name] = t
    return out


def _check_state(state: dict[str, torch.Tensor], config: SamModelConfig) -> None:
    want = published_shapes(config)
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise ValueError(f"SAM state dict: missing {missing[:5]}, unexpected {extra[:5]} "
                         f"({len(missing)} missing, {len(extra)} unexpected)")
    for name, shape in want.items():
        if tuple(state[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(state[name].shape)}, expected {shape}")


def fourier_pe(coords: torch.Tensor, gauss: torch.Tensor) -> torch.Tensor:
    """SAM's `_pe_encoding` in float32: (..., 2) coordinates in [0, 1]^2
    (x, y) -> (..., 2 * G columns) [sin, cos](2 pi (2 c - 1) G)."""
    c = (2 * coords.float() - 1) @ gauss.float()
    c = 2 * math.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class SegmentAnything:
    """SAM on one device: `encode` maps (N, 3, image, image) normalised
    images to (N, grid^2, width) embeddings; `decode` maps one image's
    embedding and a batch of P point prompts to (P, 3, 4 grid, 4 grid)
    mask logits and (P, 3) IoU predictions (multimask, masks 1-3)."""

    def __init__(self, state: dict[str, torch.Tensor], config: SamModelConfig = SamModelConfig(),
                 device: str | torch.device = "cpu", dtype: torch.dtype = torch.bfloat16):
        _check_state(state, config)
        self.config, self.dtype = config, dtype
        self.device = torch.device(device)
        self.encoder = ViTEncoder(state, config.image, "image_encoder.", self.device, dtype)
        d = config.decoder

        def cast(t: torch.Tensor) -> torch.Tensor:
            return t.to(self.device, dtype).contiguous()

        def lin(name: str) -> tuple[torch.Tensor, torch.Tensor]:
            return cast(state[name + ".weight"]), cast(state[name + ".bias"])

        def attn(name: str, heads: int) -> dict:
            return {"q": lin(name + ".q_proj"), "k": lin(name + ".k_proj"),
                    "v": lin(name + ".v_proj"), "out": lin(name + ".out_proj"), "heads": heads}

        pe, md = "prompt_encoder.", "mask_decoder."
        self.gauss = state[pe + "pe_layer.positional_encoding_gaussian_matrix"].float().to(
            self.device)
        self.point_fg = state[pe + "point_embeddings.1.weight"].float().to(self.device)
        self.not_a_point = state[pe + "not_a_point_embed.weight"].float().to(self.device)
        self.no_mask = cast(state[pe + "no_mask_embed.weight"])
        self.layers = []
        for layer in range(d.depth):
            p = f"{md}transformer.layers.{layer}."
            self.layers.append({
                "self": attn(p + "self_attn", d.heads),
                "t2i": attn(p + "cross_attn_token_to_image", d.heads),
                "i2t": attn(p + "cross_attn_image_to_token", d.heads),
                "lin1": lin(p + "mlp.lin1"), "lin2": lin(p + "mlp.lin2"),
                **{f"norm{n}": lin(f"{p}norm{n}") for n in range(1, 5)},
            })
        self.final = attn(md + "transformer.final_attn_token_to_image", d.heads)
        self.norm_final = lin(md + "transformer.norm_final_attn")
        self.output_tokens = cast(torch.cat([state[md + "iou_token.weight"],
                                             state[md + "mask_tokens.weight"]]))
        # ConvT (Cin, Cout, 2, 2) as one product: (Cin) -> (Cout, 2, 2)
        up0, up3 = state[md + "output_upscaling.0.weight"], state[md + "output_upscaling.3.weight"]
        self.up0 = (cast(up0.reshape(up0.shape[0], -1).t()),
                    cast(state[md + "output_upscaling.0.bias"]))
        self.up1 = lin(md + "output_upscaling.1")
        self.up3 = (cast(up3.reshape(up3.shape[0], -1).t()),
                    cast(state[md + "output_upscaling.3.bias"]))
        self.hyper = [[lin(f"{md}output_hypernetworks_mlps.{i}.layers.{k}") for k in range(3)]
                      for i in range(MASK_TOKENS)]
        self.iou_head = [lin(f"{md}iou_prediction_head.layers.{k}") for k in range(3)]
        g = config.image.grid
        centres = (torch.arange(g, device=self.device, dtype=torch.float32) + 0.5) / g
        yy, xx = torch.meshgrid(centres, centres, indexing="ij")
        self.image_pe = fourier_pe(torch.stack([xx, yy], -1).view(g * g, 2), self.gauss).to(dtype)

    # -- the encoder --------------------------------------------------------

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """(N, 3, image, image) normalised images -> (N, grid^2, width)
        image embeddings (the neck's output, tokens row-major)."""
        c = self.config.image
        if images.dim() != 4 or tuple(images.shape[1:]) != (3, c.tile, c.tile):
            raise ValueError(f"expected (N, 3, {c.tile}, {c.tile}) images, got "
                             f"{tuple(images.shape)}")
        return self.encoder.neck(self.encoder.tokens(images))

    # -- the prompt encoder -------------------------------------------------

    def point_tokens(self, points: torch.Tensor) -> torch.Tensor:
        """(P, 2) points (x, y) in the input frame -> (P, 2, width) sparse
        tokens: the foreground point and SAM's padding point."""
        c = self.config.image
        pe = fourier_pe((points.float() + 0.5) / c.tile, self.gauss) + self.point_fg
        pad = self.not_a_point.expand(points.shape[0], -1)
        return torch.stack([pe, pad], dim=1).to(self.dtype)

    # -- the mask decoder ---------------------------------------------------

    @staticmethod
    def _ln(x: torch.Tensor, wb, eps: float = DECODER_LN_EPS) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), wb[0], wb[1], eps)

    @staticmethod
    def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
        """(..., L, C) -> (..., heads, L, C / heads)."""
        return x.unflatten(-1, (heads, -1)).transpose(-3, -2)

    def _attend(self, a: dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                projected: dict | None = None) -> torch.Tensor:
        """SAM's `Attention`: projections, heads, softmax(q k^T / sqrt(d)) in
        float32, P v, out_proj. `projected` holds "q", "k" or "v" already
        projected and split into heads (the shared image side of block 0);
        each may broadcast over the prompts."""
        projected = projected or {}
        h = a["heads"]
        qh = projected.get("q")
        if qh is None:
            qh = self._heads(F.linear(q, *a["q"]), h)
        kh = projected.get("k")
        if kh is None:
            kh = self._heads(F.linear(k, *a["k"]), h)
        vh = projected.get("v")
        if vh is None:
            vh = self._heads(F.linear(v, *a["v"]), h)
        s = torch.matmul(qh, kh.transpose(-1, -2)).float() * qh.shape[-1] ** -0.5
        o = torch.matmul(torch.softmax(s, dim=-1).to(vh.dtype), vh)
        return F.linear(o.transpose(-3, -2).flatten(-2), *a["out"])

    def _mlp(self, x: torch.Tensor, layers) -> torch.Tensor:
        for i, wb in enumerate(layers):
            x = F.linear(x, *wb)
            if i < len(layers) - 1:
                x = F.relu(x)
        return x

    def decode(self, embedding: torch.Tensor, points: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """One image's (grid^2, width) embedding and (P, 2) points in the
        input frame -> (P, 3, 4 grid, 4 grid) mask logits in the decoder's
        dtype and (P, 3) float32 IoU predictions."""
        d, g = self.config.decoder, self.config.image.grid
        n = points.shape[0]
        tokens_pe = torch.cat([self.output_tokens.expand(n, -1, -1), self.point_tokens(points)], 1)
        src = embedding + self.no_mask  # the image side of block 0, the same for every prompt
        pos = self.image_pe
        queries, keys = tokens_pe, None
        for i, blk in enumerate(self.layers):
            if i == 0:
                queries = self._attend(blk["self"], queries, queries, queries)
            else:
                q = queries + tokens_pe
                queries = queries + self._attend(blk["self"], q, q, queries)
            queries = self._ln(queries, blk["norm1"])
            q = queries + tokens_pe
            if keys is None:
                t2i = {"k": self._heads(F.linear(src + pos, *blk["t2i"]["k"]), d.heads),
                       "v": self._heads(F.linear(src, *blk["t2i"]["v"]), d.heads)}
                i2t = {"q": self._heads(F.linear(src + pos, *blk["i2t"]["q"]), d.heads)}
                queries = queries + self._attend(blk["t2i"], q, None, None, t2i)
            else:
                k = keys + pos
                queries = queries + self._attend(blk["t2i"], q, k, keys)
            queries = self._ln(queries, blk["norm2"])
            queries = self._ln(queries + self._mlp(queries, (blk["lin1"], blk["lin2"])),
                               blk["norm3"])
            q = queries + tokens_pe
            if keys is None:
                keys = src + self._attend(blk["i2t"], None, q, queries, i2t)
            else:
                keys = keys + self._attend(blk["i2t"], keys + pos, q, queries)
            keys = self._ln(keys, blk["norm4"])
        q = queries + tokens_pe
        queries = self._ln(queries + self._attend(self.final, q, keys + pos, keys), self.norm_final)

        # output_upscaling, channels last: ConvT, LayerNorm2d, GELU, ConvT, GELU
        x = F.linear(keys, self.up0[0]).view(n, g, g, -1, 2, 2)
        x = x.permute(0, 1, 4, 2, 5, 3).reshape(n, 2 * g, 2 * g, -1) + self.up0[1]
        x = F.gelu(self._ln(x, self.up1, LN2D_EPS))
        x = F.linear(x, self.up3[0]).view(n, 2 * g, 2 * g, -1, 2, 2)
        x = F.gelu(x.permute(0, 1, 4, 2, 5, 3).reshape(n, 4 * g, 4 * g, -1) + self.up3[1])
        hyper = torch.stack([self._mlp(queries[:, 1 + i], self.hyper[i])
                             for i in range(MASK_TOKENS)], dim=1)  # (P, 4, width / 8)
        masks = torch.matmul(hyper, x.view(n, 16 * g * g, -1).transpose(1, 2))
        iou = self._mlp(queries[:, 0], self.iou_head).float()
        return masks[:, 1:].view(n, MASK_TOKENS - 1, 4 * g, 4 * g), iou[:, 1:]
