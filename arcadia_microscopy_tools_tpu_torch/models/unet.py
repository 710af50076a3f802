"""Cellpose-style U-Net in PyTorch, forward built from the fused kernels.

Counterpart of `arcadia_microscopy_tools_tpu/models/unet.py`: a residual
double-conv U-Net with GroupNorm, a global style vector injected into the
decoder, and three output maps (Y-flow, X-flow, cell-probability logits).
Tensors are NHWC (B, H, W, C), as in the JAX package.

The forward has the plain geometry of `apply_unet` (no space-to-depth
rewrite; that trick fills the TPU's 128 lanes and has no use here) built
from the fused blocks of the JAX package's `unet_s2d.py`:

- every stride-1 3x3 conv with an activation input runs through
  `conv3x3_fused` (the CUDA kernel on the card): conv1 emits the moments of
  GN1, GN1 + ReLU ride conv2's prologue, conv2 emits the moments of GN2;
- the block tail applies GN2's affine, adds the residual and takes the
  ReLU in one elementwise pass, with the rounding points of `_fused_tail`;
- in the decoder, conv(concat(up, skip)) is split into conv(up, W_up)
  followed by conv(skip, W_skip, accum=...), so the concatenation is never
  built; the 1x1 projection is split the same way, its up part taken before
  the nearest upsample (the two commute exactly);
- the one 3x3 conv with a 3-channel input (down0.conv1) is a float32
  `F.conv2d` rounded to the compute dtype, and its GN moments come from the
  `lane_moments` kernel;
- 1x1 projections, the head, max-pool, upsample and the style MLP are
  ordinary PyTorch.

GroupNorm is one-pass (E[x^2] - mean^2, clamped at 0) in every dtype; the
JAX package's float32 path is two-pass, so the float32 forward agrees with
`apply_unet` to the tolerance stated in the tests, not bit for bit. The
bfloat16 forward is the one the CUDA kernels run. A float32 forward runs
the same blocks through the kernels' plain PyTorch versions on any device,
as the JAX package runs its float32 forward in XLA, outside its bfloat16
Pallas conv.

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

import torch
import torch.nn.functional as F
from torch import nn

from .conv_cuda import conv2d_f32, conv3x3_fused, conv3x3_fused_plain, gn_affine_params
from .gn_cuda import lane_moments, lane_moments_plain

__all__ = ["UNet", "UNetConfig"]


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


class UNet(nn.Module):
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

    def _conv(self, *args, **kwargs):
        """`conv3x3_fused` in bfloat16 (the kernel on the card); its plain
        version in any other dtype."""
        if self.config.compute_dtype == torch.bfloat16:
            return conv3x3_fused(*args, **kwargs)
        return conv3x3_fused_plain(*args, **kwargs)

    def _moments(self, x):
        if self.config.compute_dtype == torch.bfloat16:
            return lane_moments(x)
        return lane_moments_plain(x)

    def _tail(self, blk: _ConvBlock, y1, m1, skip):
        """GN1 + ReLU folded into conv2's prologue, conv2 with GN2 moments,
        then GN2 affine + residual + ReLU (rounding points of the JAX
        package's `_fused_tail`)."""
        dt, groups = self.config.compute_dtype, self.config.groups
        _, h, w, c = y1.shape
        n = h * w * (c // min(groups, c))
        sc1, bi1 = gn_affine_params(m1[0], m1[1], blk.gn1_scale, blk.gn1_bias, groups, n)
        y2, m2 = self._conv(
            y1, blk.conv2.to(dt), prologue=(sc1, bi1), relu=True, emit_moments=True
        )
        sc2, bi2 = gn_affine_params(m2[0], m2[1], blk.gn2_scale, blk.gn2_bias, groups, n)
        f = y2.float()
        del y2
        # in place: at 2048^2 x 8 x 32 channels each float32 temporary is 4.3 GB
        f.mul_(sc2[:, None, None, :]).add_(bi2[:, None, None, :])
        out = f.to(dt)
        del f
        out += skip.to(dt)
        return out.relu_()

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
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.config.compute_dtype

        def w(t: torch.Tensor) -> torch.Tensor:
            return t.to(dt).contiguous()

        # encoder
        skips = []
        h = x.to(dt)
        for i, blk in enumerate(self.down):
            if i == 0:
                y1 = conv2d_f32(h, w(blk.conv1)).to(dt)
                m1 = self._moments(y1)
            else:
                y1, m1 = self._conv(h, w(blk.conv1), emit_moments=True)
            skip = h if blk.proj is None else h @ w(blk.proj)
            h = self._tail(blk, y1, m1, skip)
            del y1, skip
            skips.append(h)
            if i < len(self.down) - 1:
                h = _max_pool2(h)

        # style vector from the deepest features
        style = h.float().mean((1, 2))
        style = style / (torch.linalg.vector_norm(style, dim=-1, keepdim=True) + 1e-6)
        style = torch.relu(style @ self.style_dense)

        # decoder: conv(concat(up, skip)) as conv(up) accumulated into conv(skip)
        n_levels = len(self.down)
        for i, blk in enumerate(self.up):
            skip_t = skips[n_levels - 2 - i]
            c_up = h.shape[-1]
            up = _upsample2(h)
            a = self._conv(up, w(blk.conv1[..., :c_up]))
            del up
            y1, m1 = self._conv(skip_t, w(blk.conv1[..., c_up:]), accum=a, emit_moments=True)
            del a
            skip = _upsample2(h @ w(blk.proj[:c_up])) + skip_t @ w(blk.proj[c_up:])
            h = self._tail(blk, y1, m1, skip)
            del y1, skip
            h += (style @ self.style_proj[i]).to(dt)[:, None, None, :]
        return (h @ w(self.head)).float() + self.head_bias
