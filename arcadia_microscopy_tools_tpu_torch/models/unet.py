"""Cellpose-style U-Net in PyTorch, forward built from the fused kernels.

Counterpart of `arcadia_microscopy_tools_tpu/models/unet.py`: a residual
double-conv U-Net with GroupNorm, a global style vector injected into the
decoder, and three output maps (Y-flow, X-flow, cell-probability logits).
Tensors are NHWC (B, H, W, C), as in the JAX package.

The forward has the plain geometry of `apply_unet`, built from the fused
blocks of the JAX package's `unet_s2d.py`. The space-to-depth form itself
is `models/unet_s2d.py`, the slower of the two on an H100 (`chip_smoke.py`
phase 15, with both forwards' tails in kernel 9: 115.2-116.8 ms per batch
of 8 2048^2 wells against this forward's 85.6-86.0, its 13 conv calls
66.7 ms against these 16 calls' 36.5), so the plate runner and
`SegmentationModel` run this one. The blocks:

- every stride-1 3x3 conv with an activation input runs through
  `conv3x3_fused` (the CUDA kernel on the card): conv1 emits the moments of
  GN1, GN1 + ReLU ride conv2's prologue, conv2 emits the moments of GN2;
- the block tail applies GN2's affine, adds the residual, takes the ReLU
  and, in the decoder, adds the style row in one elementwise pass over
  conv2's output (`tail_cuda.unet_tail`, kernel 9 on the card), with the
  rounding points of `_fused_tail`;
- in the decoder, conv(concat(up, skip)) is split into conv(up, W_up)
  followed by conv(skip, W_skip, accum=...), so the concatenation is never
  built; the 1x1 projection is split the same way, its up part taken before
  the nearest upsample (the two commute exactly), which the tail reads at
  half resolution, so the upsampled projection is never built either;
- the one 3x3 conv with a 3-channel input (down0.conv1) is a float32
  `F.conv2d` rounded to the compute dtype, and its GN moments come from the
  `lane_moments` kernel;
- 1x1 projections, the head, max-pool, upsample and the style MLP are
  ordinary PyTorch; the two narrow ones (down0's 3-channel projection, the
  3-channel head) run as full-float32 GEMMs (`_narrow_project`), since
  cuBLAS's bf16 GEMM at those shapes rounds a row differently as the
  number of rows changes;
- the style vector is the mean of the deepest features from per-block sums
  (`_style_sums`: blocks of 2 rows, each added in a fixed pairwise order,
  then the blocks in one fixed-order sum), so row slabs send their blocks'
  sums rather than their features.

GroupNorm is one-pass (E[x^2] - mean^2, clamped at 0) in every dtype; the
JAX package's float32 path is two-pass, so the float32 forward agrees with
`apply_unet` to the tolerance stated in the tests, not bit for bit. The
bfloat16 forward is the one the CUDA kernels run. A float32 forward runs
the same blocks through the kernels' plain PyTorch versions on any device,
as the JAX package runs its float32 forward in XLA, outside its bfloat16
Pallas conv.

`forward(x, slab=...)` runs one row slab of the input on each rank of a
process group (the plate runner's space axis): before each 3x3 conv the
slabs trade one halo row of its input (the conv kernel takes it and pads
zeros only at the image's edges), each GroupNorm adds every slab's moment
partials in the whole image's order, and the style vector is the mean of
the deepest features' block sums (`_style_sums`); max-pool, upsample, the 1x1
projections and the head stay local. For slabs that start on multiples of
16 rows and of the moments kernel's run of rows (`gn_cuda.lane_rows`), the
concatenated slab outputs equal the whole-image forward bit for bit.

`training_forward` is the differentiable forward the trainer
(models/train.py) runs: the JAX package's `_apply` with its default
`_conv_block` and `_group_norm`, as plain PyTorch ops under autograd
(`F.conv2d`, reductions, elementwise ops; the JAX training forward is XLA,
not a Pallas kernel). It reads the same parameters as `forward`.

Parameters keep the names of `init_unet`. Layouts: 3x3 convs (3, 3, Co, C),
the layout the conv kernel stages; 1x1 convs and dense layers (C, Co).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_gather_rows, halo_rows_nhwc
from .conv_cuda import (
    conv2d_f32,
    conv3x3_fused,
    conv3x3_fused_plain,
    gn_affine_params,
    moment_tiles,
    pairwise_sum,
    sum_partials,
)
from .gn_cuda import lane_chunks, lane_moments, lane_moments_plain
from .tail_cuda import unet_tail, unet_tail_plain

__all__ = ["SlabRows", "UNet", "UNetConfig"]


class UNetConfig:
    """Static architecture configuration (same fields as the JAX package's).

    Attributes:
        in_channels: input image channels (3).
        base_channels: channel widths per resolution level.
        out_channels: output maps (dY, dX, cellprob).
        groups: GroupNorm group count.
        compute_dtype: activation dtype (bfloat16, the kernels' dtype, or
            float32 through the plain versions).
    """

    def __init__(
        self,
        in_channels: int = 3,
        base_channels: tuple[int, ...] = (32, 64, 128, 256),
        out_channels: int = 3,
        groups: int = 8,
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        self.in_channels = in_channels
        self.base_channels = tuple(base_channels)
        self.out_channels = out_channels
        self.groups = groups
        self.compute_dtype = compute_dtype

    def __repr__(self) -> str:
        return (
            f"UNetConfig(in={self.in_channels}, base={self.base_channels}, "
            f"out={self.out_channels})"
        )


class SlabRows(NamedTuple):
    """This rank's input is one row slab of an image whose slabs lie, in
    order, on the ranks of `group`; slab r holds heights[r] input rows."""

    group: Any
    heights: tuple[int, ...]


class _Rows:
    """What one forward exchanges between row slabs: nothing for a whole
    image (slab None), else halo rows, moment partials and the style's
    block sums over the slab's group. `level` is the resolution level (rows
    halve per level)."""

    def __init__(self, slab: SlabRows | None, h: int):
        self.group = None if slab is None else slab.group
        self.heights = (h,) if slab is None else tuple(slab.heights)

    def full(self, level: int) -> int:
        """The whole image's rows at `level`."""
        return sum(self.heights) >> level

    def halo(self, t: torch.Tensor) -> tuple[torch.Tensor, int, int]:
        return halo_rows_nhwc(t, self.group)

    def sums(self, part: torch.Tensor, level: int, count) -> tuple[torch.Tensor, torch.Tensor]:
        """Every slab's (B, count(rows), 2, C) partials, in the whole
        image's order, added up."""
        if self.group is not None:
            part = all_gather_rows(part, [count(h >> level) for h in self.heights], self.group)
        return sum_partials(part)

    def style(self, h: torch.Tensor, level: int) -> torch.Tensor:
        """(B, C) mean of the whole image's NHWC `h` at `level` from every
        slab's block sums (`_style_sums`), added in the whole image's order."""
        sums = _style_sums(h)
        if self.group is not None:
            counts = [-(-(r >> level) // _STYLE_ROWS) for r in self.heights]
            sums = all_gather_rows(sums, counts, self.group)
        return sums.sum(1) / (self.full(level) * h.shape[2])


class _ConvBlock(nn.Module):
    """Parameters of one residual double-conv block."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Parameter(torch.empty(3, 3, cout, cin))
        self.conv2 = nn.Parameter(torch.empty(3, 3, cout, cout))
        self.gn1_scale = nn.Parameter(torch.ones(cout))
        self.gn1_bias = nn.Parameter(torch.zeros(cout))
        self.gn2_scale = nn.Parameter(torch.ones(cout))
        self.gn2_bias = nn.Parameter(torch.zeros(cout))
        self.proj = nn.Parameter(torch.empty(cin, cout)) if cin != cout else None


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    return x[:, : 2 * h2, : 2 * w2].reshape(b, h2, 2, w2, 2, c).amax((2, 4))


def _max_pool2_first(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool of NHWC whose gradient goes to the first maximum of each
    window in row-major order, as the gradient of XLA's `reduce_window` max
    does (`amax` would split it between equal values)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _narrow_project(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w for NHWC `a` and a (K, N) weight with K or N below 32, as a
    full-float32 GEMM (TF32 off) rounded once to a's dtype: the products of
    bfloat16 values are exact in float32, and the float32 GEMM adds each
    pixel's K of them one after another whatever the number of rows (on the
    H100 as `chip_smoke.py`'s phase 3 probes it). cuBLAS's bf16 GEMM at
    these shapes changes its kernel, and a pixel's rounding with it, with
    the number of rows (a row slab got other bits than the whole image on
    the H100)."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        y = a.float() @ w.float()
    finally:
        torch.set_float32_matmul_precision(saved)
    return y.to(a.dtype)


_STYLE_ROWS = 2  # rows of the deepest features per style block: 16 input rows


def _style_sums(h: torch.Tensor) -> torch.Tensor:
    """(B, ceil(H / 2), C) float32 sums of NHWC `h` over each block of 2
    rows, each in a fixed pairwise order (`pairwise_sum`): the same
    additions whatever rows lie around the block."""
    b, h_, w, c = h.shape
    k = -(-h_ // _STYLE_ROWS)
    f = F.pad(h.float(), (0, 0, 0, 0, 0, k * _STYLE_ROWS - h_))
    return pairwise_sum(f.reshape(b, k, _STYLE_ROWS * w, c), 2)


def _project(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A 1x1 projection of NHWC `a` in a's dtype."""
    return _narrow_project(a, w) if min(w.shape) < 32 else a @ w


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """SAME 3x3 conv of NHWC `x` with a (3, 3, Co, C) weight, inputs and
    output in `dtype` (the JAX package's `_conv2d`)."""
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), w.to(dtype).permute(2, 3, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def _group_norm_train(x: torch.Tensor, scale, bias, groups: int) -> torch.Tensor:
    """The JAX package's `_group_norm`: float32 statistics, two-pass centred
    variance for float32 input and one-pass E[x^2] - mean^2 otherwise, eps
    1e-5, output in x's dtype."""
    b, h, w, c = x.shape
    g = min(groups, c)
    cg = c // g
    n = h * w * cg
    mean = x.sum((1, 2), dtype=torch.float32).reshape(b, g, cg).sum(2) / n
    if x.dtype == torch.float32:
        centred = x - mean.repeat_interleave(cg, 1)[:, None, None, :]
        var = centred.square().sum((1, 2)).reshape(b, g, cg).sum(2) / n
    else:
        s2 = x.float().square().sum((1, 2))
        var = s2.reshape(b, g, cg).sum(2) / n - mean * mean
    mean_c = mean.repeat_interleave(cg, 1)[:, None, None, :]
    inv_c = torch.rsqrt(var.clamp_min(0.0) + 1e-5).repeat_interleave(cg, 1)[:, None, None, :]
    return ((x.float() - mean_c) * (inv_c * scale) + bias).to(x.dtype)


class _FusedBlocks:
    """The fused conv blocks of the inference forwards, `UNet.forward` and
    `unet_s2d.UNetS2D`, on `self.config`. `rows` says what a call exchanges
    between row slabs, `level` that the tensor holds the image's rows >>
    level."""

    def _conv(self, *args, **kwargs):
        """`conv3x3_fused` in bfloat16 (the kernel on the card); its plain
        version in any other dtype."""
        if self.config.compute_dtype == torch.bfloat16:
            return conv3x3_fused(*args, **kwargs)
        return conv3x3_fused_plain(*args, **kwargs)

    def _moments(self, rows: _Rows, y, level: int):
        """The whole image's GN moments of `y` from `lane_moments` (the
        CUDA kernel in bfloat16 on the card, its plain version in any other
        dtype)."""
        moments = lane_moments if self.config.compute_dtype == torch.bfloat16 else lane_moments_plain
        wd = y.shape[2]
        return rows.sums(moments(y, partials=True), level, lambda r: lane_chunks(r, wd))

    def _conv_rows(self, rows: _Rows, x, w, level: int, moments: bool = False, **kwargs):
        """`_conv` of this slab's rows with the neighbours' halo rows; with
        `moments`, (y, the whole image's moments)."""
        xh, top, bottom = rows.halo(x)
        out = self._conv(xh, w, top=top, bottom=bottom, emit_moments=moments, partials=moments,
                         **kwargs)
        if not moments:
            return out
        y, part = out
        _, _, wd, co = y.shape
        return y, rows.sums(part, level, lambda h: moment_tiles(h, wd, co))

    def _tail(self, blk: nn.Module, y1, m1, skip, rows: _Rows, level: int, up=None, style=None):
        """GN1 + ReLU folded into conv2's prologue, conv2 with GN2 moments,
        then GN2 affine + residual + ReLU (rounding points of the JAX
        package's `_fused_tail`) and the style add, in one pass written
        over conv2's output: `unet_tail` (kernel 9 on the card) in
        bfloat16, its plain version in any other dtype. The residual is
        `skip`, or with `up` the decoder's split projection."""
        dt, groups = self.config.compute_dtype, self.config.groups
        _, _, w, c = y1.shape
        n = rows.full(level) * w * (c // min(groups, c))
        sc1, bi1 = gn_affine_params(m1[0], m1[1], blk.gn1_scale, blk.gn1_bias, groups, n)
        y2, m2 = self._conv_rows(
            rows, y1, blk.conv2.to(dt), level, moments=True, prologue=(sc1, bi1), relu=True
        )
        sc2, bi2 = gn_affine_params(m2[0], m2[1], blk.gn2_scale, blk.gn2_bias, groups, n)
        tail = unet_tail if dt == torch.bfloat16 else unet_tail_plain
        return tail(y2, sc2, bi2, skip.to(dt), up=up, style=style, out=y2)


class UNet(_FusedBlocks, nn.Module):
    """The segmentation U-Net. `forward` maps (B, H, W, in_channels) float
    input, H and W multiples of 2**(levels - 1), to (B, H, W, 3) float32.

    Seeded initialisation draws from an explicit `torch.Generator` with the
    JAX package's distributions (He-normal convs and dense layers, unit GN
    scales, zero biases); it does not reproduce the numbers `init_unet`
    draws from a JAX key, since `jax.random` and `torch.Generator` differ by
    design. What it does reproduce, for the same seed, is the leaf names,
    the shapes (after `weights.state_dict_from_tree`) and each large weight
    leaf's spread within 10%, which the tests pin. Trained or
    JAX-initialised weights come in through `models.weights`.
    """

    def __init__(self, config: UNetConfig | None = None, generator: torch.Generator | None = None):
        super().__init__()
        self.config = config or UNetConfig()
        nb = self.config.base_channels
        cins = (self.config.in_channels, *nb[:-1])
        self.down = nn.ModuleList(_ConvBlock(cin, cout) for cin, cout in zip(cins, nb))
        self.style_dense = nn.Parameter(torch.empty(nb[-1], nb[-1]))
        levels = list(reversed(range(len(nb) - 1)))
        self.up = nn.ModuleList(_ConvBlock(nb[lv + 1] + nb[lv], nb[lv]) for lv in levels)
        self.style_proj = nn.ParameterList(
            nn.Parameter(torch.empty(nb[-1], nb[lv])) for lv in levels
        )
        self.head = nn.Parameter(torch.empty(nb[0], self.config.out_channels))
        self.head_bias = nn.Parameter(torch.zeros(self.config.out_channels))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        def he(p: nn.Parameter, fan_in: int) -> None:
            p.copy_(torch.randn(p.shape, generator=generator) * math.sqrt(2.0 / fan_in))

        for blk in [*self.down, *self.up]:
            cin = blk.conv1.shape[3]
            he(blk.conv1, 9 * cin)
            he(blk.conv2, 9 * blk.conv2.shape[3])
            if blk.proj is not None:
                he(blk.proj, cin)
        he(self.style_dense, self.style_dense.shape[0])
        for p in self.style_proj:
            he(p, p.shape[0])
        he(self.head, self.head.shape[0])

    def _block_train(self, blk: _ConvBlock, x: torch.Tensor) -> torch.Tensor:
        """Residual double conv of the JAX package's `_conv_block`."""
        dt, groups = self.config.compute_dtype, self.config.groups
        h = _group_norm_train(_conv_nhwc(x, blk.conv1, dt), blk.gn1_scale, blk.gn1_bias, groups)
        h = _conv_nhwc(torch.relu(h), blk.conv2, dt)
        h = _group_norm_train(h, blk.gn2_scale, blk.gn2_bias, groups)
        skip = x if blk.proj is None else x.to(dt) @ blk.proj.to(dt)
        return torch.relu(h + skip.to(h.dtype))

    def training_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The differentiable forward of training: (B, H, W, in_channels)
        float input -> (B, H, W, 3) float32, as the JAX package's `_apply`
        computes it, activations in `config.compute_dtype`."""
        dt = self.config.compute_dtype
        skips = []
        h = x
        for i, blk in enumerate(self.down):
            h = self._block_train(blk, h)
            skips.append(h)
            if i < len(self.down) - 1:
                h = _max_pool2_first(h)

        style = h.float().mean((1, 2))
        style = style / (torch.linalg.vector_norm(style, dim=-1, keepdim=True) + 1e-6)
        style = torch.relu(style @ self.style_dense)

        n_levels = len(self.down)
        for i, blk in enumerate(self.up):
            h = torch.cat([_upsample2(h), skips[n_levels - 2 - i].to(h.dtype)], -1)
            h = self._block_train(blk, h)
            h = h + (style @ self.style_proj[i]).to(h.dtype)[:, None, None, :]
        out = h.to(dt) @ self.head.to(dt) + self.head_bias
        return out.float()

    @torch.no_grad()  # inference only: the kernels have no backward
    def forward(self, x: torch.Tensor, slab: SlabRows | None = None) -> torch.Tensor:
        """(B, H, W, in_channels) -> (B, H, W, 3) float32. With `slab`, x is
        this rank's row slab of the input and the result its rows of the
        whole image's output (every rank of the slab's group calls this)."""
        dt = self.config.compute_dtype
        rows = _Rows(slab, x.shape[1])

        def w(t: torch.Tensor) -> torch.Tensor:
            return t.to(dt).contiguous()

        # encoder
        skips = []
        h = x.to(dt)
        for i, blk in enumerate(self.down):
            if i == 0:
                hx, top, bottom = rows.halo(h)
                y1 = conv2d_f32(hx, w(blk.conv1), top, bottom).to(dt)
                del hx
                m1 = self._moments(rows, y1, 0)
            else:
                y1, m1 = self._conv_rows(rows, h, w(blk.conv1), i, moments=True)
            skip = h if blk.proj is None else _project(h, w(blk.proj))
            h = self._tail(blk, y1, m1, skip, rows, i)
            del y1, skip
            skips.append(h)
            if i < len(self.down) - 1:
                h = _max_pool2(h)

        # style vector from the deepest features
        style = rows.style(h, len(self.down) - 1)
        style = style / (torch.linalg.vector_norm(style, dim=-1, keepdim=True) + 1e-6)
        style = torch.relu(style @ self.style_dense)

        # decoder: conv(concat(up, skip)) as conv(up) accumulated into conv(skip)
        n_levels = len(self.down)
        for i, blk in enumerate(self.up):
            level = n_levels - 2 - i
            skip_t = skips[level]
            c_up = h.shape[-1]
            up = _upsample2(h)
            a = self._conv_rows(rows, up, w(blk.conv1[..., :c_up]), level)
            del up
            y1, m1 = self._conv_rows(rows, skip_t, w(blk.conv1[..., c_up:]), level, moments=True,
                                     accum=a)
            del a
            up = h @ w(blk.proj[:c_up])
            skip = skip_t @ w(blk.proj[c_up:])
            h = self._tail(blk, y1, m1, skip, rows, level, up=up,
                           style=(style @ self.style_proj[i]).to(dt))
            del y1, up, skip
        return _project(h, w(self.head)).float() + self.head_bias
