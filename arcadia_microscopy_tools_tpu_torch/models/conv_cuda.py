"""Fused 3x3 convolution: the CUDA kernel, its plain version, GN folding.

Counterpart of `arcadia_microscopy_tools_tpu/models/conv_pallas.py`.
`conv3x3_fused` computes, in one pass over an NHWC activation,

    y = conv3x3(relu(x * scale + bias)) + accum        (SAME, f32 accumulation)

with the prologue (the previous GroupNorm folded into a per-(image, channel)
affine, optionally followed by ReLU) and `accum` optional, and, on request,
the per-channel sums of y and y^2 that the next GroupNorm needs, taken of the
rounded output. Weights are laid out (3, 3, Co, C): tap, output channel,
input channel, the layout the kernel stages in shared memory.

The sums come as partials, one per output tile of the kernel's grid (64
columns by `tile_rows(Co)` rows, in row-major order: `moment_tiles`), which
the caller adds in one fixed order (`sum_partials`); the plain version
computes the same partials, each in a fixed pairwise order. For one row
slab of an image (`top` / `bottom`: x holds a halo row of the neighbouring
slab above / below the output rows) that starts on a multiple of the tile
height, the partials are the whole image's partials of those tiles, so the
slabs' partials, concatenated, add up to the whole image's sums bit for bit.

For CUDA tensors the wrapper launches the hand-written kernel of
`csrc/conv3x3_fused.cu` (bfloat16 in and out, C and Co multiples of 32); for
CPU tensors it runs the plain PyTorch version, which the tests and
`chip_smoke.py` hold the kernel against. The plain version also takes
float32 (the f32 forward on the CPU). There is no fallback: a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from .._build import check_launch, cuda_stream

__all__ = [
    "conv3x3_fused",
    "conv3x3_fused_plain",
    "conv2d_f32",
    "gn_affine_params",
    "launch_counts",
    "moment_tiles",
    "reset_launch_counts",
    "sum_partials",
    "tile_rows",
]

TILE_COLS = 64  # output columns of one kernel tile (the M of one wgmma)

# kernel launches; only a launch of the CUDA kernel counts
launch_counts = {"conv3x3_fused": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def gn_affine_params(s1, s2, scale, bias, groups: int, n: int):
    """Fold GroupNorm statistics and the learned affine into per-(image,
    channel) rows for the conv prologue (copy of the JAX package's
    `conv_pallas.gn_affine_params`).

    (s1, s2): (B, C) float32 channel sums / sums of squares over H * W
    pixels; `n = H * W * (C // groups)` values per group. Returns (B, C)
    float32 (eff_scale, eff_bias) with eff(x) = (x - mean_g) * rsqrt(var_g +
    1e-5) * scale_c + bias_c, the variance one-pass and clamped at 0.
    """
    b, c = s1.shape
    g = min(groups, c)
    cg = c // g
    mean = s1.reshape(b, g, cg).sum(2) / n
    var = s2.reshape(b, g, cg).sum(2) / n - mean * mean
    inv = torch.rsqrt(var.clamp_min(0.0) + 1e-5)
    mean_c = mean.repeat_interleave(cg, 1)
    inv_c = inv.repeat_interleave(cg, 1)
    eff_scale = inv_c * scale[None, :]
    eff_bias = bias[None, :] - mean_c * eff_scale
    return eff_scale.float(), eff_bias.float()


@contextlib.contextmanager
def _no_tf32():
    """cuDNN runs float32 convolutions in TF32 unless told otherwise."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def tile_rows(co: int) -> int:
    """Output rows of one kernel tile for Co output channels: 512 / N for
    the widest wgmma N (32..256) that divides Co (`tile_rows` of the .cu)."""
    n = next((n for n in (256, 128, 64) if co % n == 0), 32)
    return 512 // n


def moment_tiles(h: int, w: int, co: int) -> int:
    """Moment partials of one image of h x w output pixels: the kernel's
    tiles, `amt_conv3x3_tiles`."""
    return -(-w // TILE_COLS) * -(-h // tile_rows(co))


def pairwise_sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim` by halving, the dimension zero padded to a power of
    two: the same additions in the same order whatever the other dimensions
    hold."""
    n = t.shape[dim]
    t = t.movedim(dim, -1)
    t = F.pad(t, (0, (1 << max(0, (n - 1).bit_length())) - n)).movedim(-1, dim)
    while t.shape[dim] > 1:
        lo, hi = t.split(t.shape[dim] // 2, dim)
        t = lo + hi
    return t.squeeze(dim)


def sum_partials(part: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n, 2, C) moment partials -> (sum, sum of squares), each (B, C),
    added over n in one fixed order."""
    sums = part.sum(1)
    return sums[:, 0], sums[:, 1]


def _tile_partials(y: torch.Tensor) -> torch.Tensor:
    """(B, tiles, 2, Co) float32 sums of y and y^2 over each output tile of
    the kernel's grid, each in a fixed pairwise order."""
    b, h, w, co = y.shape
    th = tile_rows(co)
    nty, ntx = -(-h // th), -(-w // TILE_COLS)
    f = F.pad(y.float(), (0, 0, 0, ntx * TILE_COLS - w, 0, nty * th - h))
    f = f.reshape(b, nty, th, ntx, TILE_COLS, co)
    out = [pairwise_sum(pairwise_sum(v, 4), 2) for v in (f, f * f)]
    return torch.stack(out, 3).reshape(b, nty * ntx, 2, co)


def conv2d_f32(x: torch.Tensor, w: torch.Tensor, top: int = 0, bottom: int = 0) -> torch.Tensor:
    """SAME 3x3 convolution of NHWC `x` with (3, 3, Co, C) weights in full
    float32 (TF32 off); returns (B, H, W, Co) float32. With `top` / `bottom`
    x's first / last row is a halo row of a neighbouring row slab: the rows
    of the output stop short of it (past x the rows are zero)."""
    with _no_tf32():
        y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.permute(2, 3, 0, 1).float(), padding=1)
    return y.permute(0, 2, 3, 1)[:, top : y.shape[2] - bottom].contiguous()


def conv3x3_fused_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    prologue: tuple[torch.Tensor, torch.Tensor] | None = None,
    relu: bool = False,
    accum: torch.Tensor | None = None,
    emit_moments: bool = False,
    top: int = 0,
    bottom: int = 0,
    partials: bool = False,
):
    """Plain PyTorch version of `conv3x3_fused`, with the kernel's rounding
    points: the prologue in float32, rounded to x's dtype, on every row of x
    (halo rows too); the conv in float32; `accum` added in float32; one
    rounding to x's dtype; moments summed in float32 over the rounded
    output, per tile of the kernel's grid."""
    a = x
    if prologue is not None:
        scale, bias = prologue
        f = x.float() * scale[:, None, None, :] + bias[:, None, None, :]
        if relu:
            f = torch.relu(f)
        a = f.to(x.dtype)
    y = conv2d_f32(a, w, top, bottom)
    if accum is not None:
        y = y + accum.float()
    y = y.to(x.dtype)
    if not emit_moments:
        return y
    part = _tile_partials(y)
    return y, (part if partials else sum_partials(part))


@functools.cache
def _library() -> ctypes.CDLL:
    from .._build import load_kernel_library

    lib = load_kernel_library("conv3x3_fused").lib
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.amt_conv3x3_fused.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, vp]
    lib.amt_conv3x3_fused.restype = i
    lib.amt_conv3x3_tiles.argtypes = [i, i, i]
    lib.amt_conv3x3_tiles.restype = i
    return lib


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _check_cuda_operand(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(
            f"{name} must be {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def conv3x3_fused(
    x: torch.Tensor,
    w: torch.Tensor,
    prologue: tuple[torch.Tensor, torch.Tensor] | None = None,
    relu: bool = False,
    accum: torch.Tensor | None = None,
    emit_moments: bool = False,
    top: int = 0,
    bottom: int = 0,
    partials: bool = False,
):
    """SAME 3x3 conv with fused affine(+ReLU) prologue, accumulate and
    GroupNorm moments.

    Args:
        x: (B, top + H + bottom, W, C) activation (bfloat16 on the card).
        w: (3, 3, Co, C) weights in x's dtype.
        prologue: optional (scale, bias), each (B, C) float32.
        relu: apply ReLU after the prologue.
        accum: optional (B, H, W, Co) tensor in x's dtype, added before
            the rounding of the output.
        emit_moments: also return the per-channel moments.
        top, bottom: 0, or 1 when x's first / last row is a halo row of the
            neighbouring row slab above / below (an image pixel, which the
            prologue takes); the H output rows lie between them.
        partials: return the moments as (B, moment_tiles(H, W, Co), 2, Co)
            per-tile partials instead of their sums.

    Returns:
        y (B, H, W, Co) in x's dtype, or (y, (s1, s2)) with (B, Co) float32
        sums of y and y^2 when `emit_moments` (or (y, partials)).
    """
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[3] != x.shape[3]:
        raise ValueError(
            f"expected x (B, H, W, C) and w (3, 3, Co, C), got {tuple(x.shape)} and "
            f"{tuple(w.shape)}"
        )
    if relu and prologue is None:
        raise ValueError("relu applies to the prologue; pass a prologue")
    if top not in (0, 1) or bottom not in (0, 1) or x.shape[1] < top + bottom:
        raise ValueError(f"top and bottom are 0 or 1 halo rows of x, got {top} and {bottom}")
    if x.device.type == "cpu":
        return conv3x3_fused_plain(x, w, prologue, relu, accum, emit_moments, top, bottom, partials)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, hx, wd, c = x.shape
    h = hx - top - bottom
    co = w.shape[2]
    dev, bf = x.device, torch.bfloat16
    if c % 32 or co % 32:
        raise ValueError(f"the CUDA kernel takes C and Co multiples of 32, got {c} and {co}")
    if b > 65535:
        raise ValueError(f"batch of {b} images exceeds the kernel grid")
    _check_cuda_operand("x", x, (b, hx, wd, c), bf, dev)
    _check_cuda_operand("w", w, (3, 3, co, c), bf, dev)
    scale = bias = None
    if prologue is not None:
        scale, bias = prologue
        _check_cuda_operand("prologue scale", scale, (b, c), torch.float32, dev)
        _check_cuda_operand("prologue bias", bias, (b, c), torch.float32, dev)
    if accum is not None:
        _check_cuda_operand("accum", accum, (b, h, wd, co), bf, dev)
    lib = _library()
    y = torch.empty((b, h, wd, co), dtype=bf, device=dev)
    tiles = lib.amt_conv3x3_tiles(h, wd, co)
    part = torch.empty((b, tiles, 2, co), dtype=torch.float32, device=dev) if emit_moments else None
    if y.numel():
        with torch.cuda.device(dev):
            err = lib.amt_conv3x3_fused(
                _ptr(x), _ptr(w), _ptr(scale), _ptr(bias), _ptr(accum), _ptr(y), _ptr(part),
                b, h, wd, c, co, int(relu), top, bottom, cuda_stream(x),
            )
        check_launch(err, "conv3x3_fused")
        launch_counts["conv3x3_fused"] += 1
    if not emit_moments:
        return y
    return y, (part if partials else sum_partials(part))
