"""SAM's ViT image encoder, and Cellpose-SAM: that encoder with Cellpose's
readout.

The network of Pachitariu, Rariden & Stringer, *Cellpose-SAM* (bioRxiv 2025;
github.com/MouseLand/cellpose, `cellpose/vit_sam.py`, `Transformer`), built
on the image encoder of Kirillov et al., *Segment Anything*
(arXiv:2304.02643, `segment_anything/modeling/image_encoder.py`). Neither
package had it; the JAX package swapped in a from-scratch U-Net. On one
(3, tile, tile) input tile (published: 256, patch 8, so a 32 x 32 grid of
tokens):

- patch embedding: Conv2d(3 -> width, kernel = stride = patch, bias), then
  `pos_embed` (1, grid, grid, width) added;
- `depth` pre-norm blocks, all with global attention (Cellpose-SAM sets
  `window_size = 0` in every one): x += proj(attn(LN1(x))), then
  x += lin2(GELU(lin1(LN2(x)))); LayerNorm eps 1e-6, the exact GELU;
  qkv = Linear(width -> 3 width, bias), `heads` heads of width / heads;
  the logits carry SAM's decomposed relative-position bias
  (models/sam_attention.py, kernel 8 on the card);
- neck: Conv1x1(width -> neck, no bias), LayerNorm2d (eps 1e-6),
  Conv3x3(neck -> neck, pad 1, no bias), LayerNorm2d;
- readout: Conv1x1(neck -> maps * patch^2, bias), then `conv_transpose2d`
  with the fixed identity `W2` (maps * patch^2, maps, patch, patch) at
  stride patch: a pixel shuffle to (maps, tile, tile): dY, dX and the cell
  probability.

Weights come as a state dict in the published key layout
(`published_shapes`): `encoder.patch_embed.proj.*`, `encoder.pos_embed`,
`encoder.blocks.{i}.{norm1, attn.qkv, attn.proj, attn.rel_pos_h,
attn.rel_pos_w, norm2, mlp.lin1, mlp.lin2}.*`, `encoder.neck.{0,1,2,3}.*`,
`out.*`, `W2`, `diam_mean`, `diam_labels`. The relative-position tables
keep the rows SAM gave them (127 in SAM's global blocks 5, 11, 17, 23; 27
in its windowed ones) and are resized once, at load, to 2 grid - 1 rows by
SAM's `get_rel_pos` (linear interpolation, in float32).

Arithmetic, as Cellpose 4 runs the net (`use_bfloat16=True`, the whole
module cast to bfloat16): weights (LayerNorm's too) and activations in
bfloat16, matrix products through `F.linear` with float32 accumulation,
LayerNorm's statistics and GELU computed in float32 inside PyTorch's
bfloat16 kernels and rounded once to bfloat16; the attention's softmax is
float32 inside kernel 8, which reads q, k and v straight out of the qkv
projection. The residual stream is bfloat16, as in the bfloat16 module.
`dtype=torch.float32` runs the same equations in float32 (the CPU tests).

Departures from the sources:
- the readout's `conv_transpose2d` with `W2` runs as `pixel_shuffle`, which
  is the same map for the identity `W2`; loading refuses any other `W2`;
- the 3x3 neck conv is one matrix product over unfolded 3 x 3 neighbourhoods
  (zeros outside the token grid, as the conv's padding);
- the model returns only the maps, not Cellpose's second output (a tensor of
  zeros kept for backward compatibility); `diam_mean` and `diam_labels` are
  checked for shape, not used (the segmentation entry takes the diameter
  from its caller).
The input stretch and tiling are the segmentation entry's
(models/segmentation.py, models/sam_tiles.py), with their own departures.

`ViTEncoder` is the encoder alone, shared by both models: Cellpose-SAM's
(keys `encoder.*`, every block global) and Segment Anything's own
(models/sam_decoder.py, keys `image_encoder.*`, `SamConfig.window` 14: the
blocks outside `global_blocks` attend inside 14 x 14 windows). A windowed
block runs SAM's `window_partition`: LN1(x) is zero-padded at the bottom
and right to a multiple of the window (64 -> 70 at 1024^2), cut into
windows, and qkv, attention (kernel 8's window form, tables of 2 window - 1
rows used as stored) and proj run per window token; the windows are put
back and the padding cropped. The pad tokens are not masked: their q, k
and v are the qkv bias, and every edge window attends to them, as in SAM.
proj runs after the crop, which is the same per-token map.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .sam_attention import sam_attention

__all__ = [
    "CellposeSAM",
    "SamConfig",
    "ViTEncoder",
    "encoder_shapes",
    "published_shapes",
    "resize_rel_pos",
    "seeded_state_dict",
]

LN_EPS = 1e-6


@dataclass(frozen=True)
class SamConfig:
    """Sizes of the network; the defaults are Cellpose-SAM's published ones.

    `global_blocks` are the blocks whose stored relative-position tables
    have 2 * sam_grid - 1 rows (SAM's global blocks over its 64 x 64 grid);
    the others have 2 * sam_window - 1 (its 14 x 14 windows). `window` 0
    (Cellpose-SAM) runs every block with global attention over the tile's
    grid, the tables resized to 2 * grid - 1 rows; `window` > 0 (SAM) runs
    the blocks outside `global_blocks` in window x window windows."""

    width: int = 1024
    depth: int = 24
    heads: int = 16
    mlp: int = 4096
    patch: int = 8
    tile: int = 256
    neck: int = 256
    maps: int = 3
    global_blocks: tuple[int, ...] = (5, 11, 17, 23)
    sam_grid: int = 64
    sam_window: int = 14
    window: int = 0

    @property
    def grid(self) -> int:
        return self.tile // self.patch

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    def stored_rel_rows(self, block: int) -> int:
        return 2 * (self.sam_grid if block in self.global_blocks else self.sam_window) - 1

    def attention_grid(self, block: int) -> int:
        """The side of the token map block `block` attends over: its window,
        or the whole grid."""
        return self.window if self.window and block not in self.global_blocks else self.grid


def encoder_shapes(config: SamConfig, prefix: str) -> dict[str, tuple[int, ...]]:
    """The encoder's tensors (patch embedding, blocks, neck) under `prefix`
    with their shapes."""
    c, w = config, config.width
    shapes = {
        prefix + "pos_embed": (1, c.grid, c.grid, w),
        prefix + "patch_embed.proj.weight": (w, 3, c.patch, c.patch),
        prefix + "patch_embed.proj.bias": (w,),
    }
    for i in range(c.depth):
        p = f"{prefix}blocks.{i}."
        rows = c.stored_rel_rows(i)
        shapes.update({
            p + "norm1.weight": (w,), p + "norm1.bias": (w,),
            p + "attn.rel_pos_h": (rows, c.head_dim), p + "attn.rel_pos_w": (rows, c.head_dim),
            p + "attn.qkv.weight": (3 * w, w), p + "attn.qkv.bias": (3 * w,),
            p + "attn.proj.weight": (w, w), p + "attn.proj.bias": (w,),
            p + "norm2.weight": (w,), p + "norm2.bias": (w,),
            p + "mlp.lin1.weight": (c.mlp, w), p + "mlp.lin1.bias": (c.mlp,),
            p + "mlp.lin2.weight": (w, c.mlp), p + "mlp.lin2.bias": (w,),
        })
    shapes.update({
        prefix + "neck.0.weight": (c.neck, w, 1, 1),
        prefix + "neck.1.weight": (c.neck,), prefix + "neck.1.bias": (c.neck,),
        prefix + "neck.2.weight": (c.neck, c.neck, 3, 3),
        prefix + "neck.3.weight": (c.neck,), prefix + "neck.3.bias": (c.neck,),
    })
    return shapes


def published_shapes(config: SamConfig = SamConfig()) -> dict[str, tuple[int, ...]]:
    """Every tensor of Cellpose-SAM's published state dict with its shape."""
    c = config
    shapes = encoder_shapes(c, "encoder.")
    out = c.maps * c.patch**2
    shapes.update({
        "out.weight": (out, c.neck, 1, 1), "out.bias": (out,),
        "W2": (out, c.maps, c.patch, c.patch),
        "diam_labels": (1,), "diam_mean": (1,),
    })
    return shapes


def _identity_w2(config: SamConfig, device=None) -> torch.Tensor:
    n = config.maps * config.patch**2
    return torch.eye(n, device=device).reshape(n, config.maps, config.patch, config.patch)


def seeded_state_dict(config: SamConfig = SamConfig(), generator: torch.Generator | None = None,
                      device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """An untrained state dict in the published layout: weights of each
    matrix N(0, 1 / fan_in), biases and the relative-position tables
    N(0, 0.02^2), `pos_embed` N(0, 0.02^2), LayerNorms at (1, 0), the
    identity `W2`, diameters 30. On the "meta" device only the shapes."""
    out = {}
    for name, shape in published_shapes(config).items():
        if torch.device(device).type == "meta":
            out[name] = torch.empty(shape, device="meta")
            continue
        leaf = name.rsplit(".", 1)[-1]
        if name == "W2":
            t = _identity_w2(config)
        elif name.startswith("diam"):
            t = torch.full(shape, 30.0)
        elif ".norm" in name or ".neck.1." in name or ".neck.3." in name:
            t = torch.ones(shape) if leaf == "weight" else torch.zeros(shape)
        elif leaf == "weight":
            fan_in = int(torch.tensor(shape[1:]).prod())
            t = torch.randn(shape, generator=generator) * fan_in**-0.5
        else:
            t = torch.randn(shape, generator=generator) * 0.02
        out[name] = t.to(device)
    return out


def resize_rel_pos(table: torch.Tensor, rows: int) -> torch.Tensor:
    """SAM's `get_rel_pos` resize: a (r, d) table linearly interpolated to
    (rows, d) (F.interpolate, align_corners False), in float32; unchanged
    when it has `rows` already."""
    t = table.float()
    if t.shape[0] == rows:
        return t
    return F.interpolate(t.t()[None], size=rows, mode="linear")[0].t()


def _check_state(state: dict[str, torch.Tensor], config: SamConfig) -> None:
    want = published_shapes(config)
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise ValueError(f"Cellpose-SAM state dict: missing {missing[:5]}, unexpected {extra[:5]} "
                         f"({len(missing)} missing, {len(extra)} unexpected)")
    for name, shape in want.items():
        if tuple(state[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(state[name].shape)}, expected {shape}")
    if not torch.equal(state["W2"].float().cpu(), _identity_w2(config)):
        raise ValueError("W2 is not the identity pixel shuffle that Cellpose-SAM fixes")


class ViTEncoder:
    """SAM's image encoder on one device: `tokens` maps (T, 3, tile, tile)
    images to (T, grid^2, width) tokens after the blocks, `neck` those to
    (T, grid^2, neck) embeddings. `state` holds its tensors under `prefix`
    (checked by the caller)."""

    def __init__(self, state: dict[str, torch.Tensor], config: SamConfig, prefix: str,
                 device: torch.device, dtype: torch.dtype):
        self.config, self.dtype, self.device = config, dtype, device
        c = config

        def cast(t: torch.Tensor, to: torch.dtype = dtype) -> torch.Tensor:
            return t.to(device, to).contiguous()

        def w(name: str) -> torch.Tensor:
            return cast(state[prefix + name])

        self.patch_w = cast(state[prefix + "patch_embed.proj.weight"].reshape(c.width, -1))
        self.patch_b = w("patch_embed.proj.bias")
        self.pos = cast(state[prefix + "pos_embed"].reshape(1, c.grid * c.grid, c.width))
        self.blocks = []
        for i in range(c.depth):
            p = f"blocks.{i}."
            rows = 2 * c.attention_grid(i) - 1
            self.blocks.append({
                "grid": c.attention_grid(i),
                "norm1": (w(p + "norm1.weight"), w(p + "norm1.bias")),
                "qkv": (w(p + "attn.qkv.weight"), w(p + "attn.qkv.bias")),
                "rel_h": cast(resize_rel_pos(state[prefix + p + "attn.rel_pos_h"], rows)),
                "rel_w": cast(resize_rel_pos(state[prefix + p + "attn.rel_pos_w"], rows)),
                "proj": (w(p + "attn.proj.weight"), w(p + "attn.proj.bias")),
                "norm2": (w(p + "norm2.weight"), w(p + "norm2.bias")),
                "lin1": (w(p + "mlp.lin1.weight"), w(p + "mlp.lin1.bias")),
                "lin2": (w(p + "mlp.lin2.weight"), w(p + "mlp.lin2.bias")),
            })
        self.neck0 = cast(state[prefix + "neck.0.weight"].reshape(c.neck, c.width))
        self.neck1 = (w("neck.1.weight"), w("neck.1.bias"))
        # (Co, C, 3, 3) -> (Co, C * 9) in F.unfold's (c, ky, kx) order
        self.neck2 = cast(state[prefix + "neck.2.weight"].reshape(c.neck, -1))
        self.neck3 = (w("neck.3.weight"), w("neck.3.bias"))

    @staticmethod
    def _norm(x: torch.Tensor, wb) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), wb[0], wb[1], LN_EPS)

    def _windowed(self, h: torch.Tensor, blk: dict) -> torch.Tensor:
        """SAM's windowed attention of LN1(x) (T, grid^2, width): zero pad to
        a multiple of the window, qkv and attention per window, windows put
        back, padding cropped."""
        c, win = self.config, blk["grid"]
        t, g = h.shape[0], c.grid
        n = -(-g // win)
        h = F.pad(h.view(t, g, g, c.width), (0, 0, 0, n * win - g, 0, n * win - g))
        h = h.view(t, n, win, n, win, c.width).transpose(2, 3).reshape(t * n * n, win * win, -1)
        o = sam_attention(F.linear(h, *blk["qkv"]), blk["rel_h"], blk["rel_w"], c.heads, win)
        o = o.view(t, n, n, win, win, c.width).transpose(2, 3).reshape(t, n * win, n * win, -1)
        return o[:, :g, :g].reshape(t, g * g, c.width)

    def _block(self, x: torch.Tensor, blk: dict) -> torch.Tensor:
        c = self.config
        h = self._norm(x, blk["norm1"])
        if blk["grid"] != c.grid:
            o = self._windowed(h, blk)
        else:
            o = sam_attention(F.linear(h, *blk["qkv"]), blk["rel_h"], blk["rel_w"], c.heads, c.grid)
        x = x + F.linear(o, *blk["proj"])
        h = F.gelu(F.linear(self._norm(x, blk["norm2"]), *blk["lin1"]))
        return x + F.linear(h, *blk["lin2"])

    def tokens(self, tiles: torch.Tensor) -> torch.Tensor:
        """(T, 3, tile, tile) -> (T, grid^2, width) tokens after the blocks."""
        c = self.config
        t = tiles.shape[0]
        x = tiles.to(self.device, self.dtype)
        x = x.reshape(t, 3, c.grid, c.patch, c.grid, c.patch).permute(0, 2, 4, 1, 3, 5)
        x = F.linear(x.reshape(t, c.grid * c.grid, -1), self.patch_w, self.patch_b) + self.pos
        for blk in self.blocks:
            x = self._block(x, blk)
        return x

    def neck(self, x: torch.Tensor) -> torch.Tensor:
        """(T, grid^2, width) tokens -> (T, grid^2, neck) embeddings."""
        c = self.config
        t = x.shape[0]
        x = self._norm(F.linear(x, self.neck0), self.neck1)
        cols = F.unfold(x.transpose(1, 2).reshape(t, c.neck, c.grid, c.grid), 3, padding=1)
        return self._norm(F.linear(cols.transpose(1, 2), self.neck2), self.neck3)


class CellposeSAM:
    """The network on one device; `__call__` maps (T, 3, tile, tile) float
    tiles to (T, maps, tile, tile) float32 maps."""

    def __init__(self, state: dict[str, torch.Tensor], config: SamConfig = SamConfig(),
                 device: str | torch.device = "cpu", dtype: torch.dtype = torch.bfloat16):
        _check_state(state, config)
        self.config, self.dtype = config, dtype
        self.device = torch.device(device)
        self.encoder = ViTEncoder(state, config, "encoder.", self.device, dtype)
        self.out_w = state["out.weight"].reshape(-1, config.neck).to(self.device, dtype)
        self.out_w = self.out_w.contiguous()
        self.out_b = state["out.bias"].to(self.device, dtype).contiguous()

    def encode(self, tiles: torch.Tensor) -> torch.Tensor:
        """(T, 3, tile, tile) -> (T, grid^2, width) tokens after the blocks."""
        return self.encoder.tokens(tiles)

    def __call__(self, tiles: torch.Tensor) -> torch.Tensor:
        c = self.config
        if tiles.dim() != 4 or tuple(tiles.shape[1:]) != (3, c.tile, c.tile):
            raise ValueError(f"expected (T, 3, {c.tile}, {c.tile}) tiles, got {tuple(tiles.shape)}")
        t = tiles.shape[0]
        x = self.encoder.neck(self.encode(tiles))
        y = F.linear(x, self.out_w, self.out_b).float()
        y = y.transpose(1, 2).reshape(t, -1, c.grid, c.grid)
        return F.pixel_shuffle(y, c.patch)
