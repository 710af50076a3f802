"""U-Net block tail: the CUDA kernel (kernel 9) and its plain version.

After conv2 of a residual block, `unet_tail` applies GroupNorm-2's folded
affine (the (B, C) float32 rows of `conv_cuda.gn_affine_params`), adds the
residual, takes the ReLU and, in the decoder, adds the style row:

    t = (y * scale + bias) in float32, rounded to y's dtype
    r = skip,  or  upsample2(up)[:, :H, :W] + skip     (the decoder's split skip)
    o = relu(t + r)  [+ style]                          (each sum rounded to y's dtype)

`up` is the half-resolution part of the decoder's 1x1 projection, taken
before the nearest upsample (the two commute), and is read at (y // 2,
x // 2). The plain version is the PyTorch sequence the forward ran before
the kernel, six passes and a float32 temporary; it also takes float32 (the
float32 forward). For CUDA tensors the wrapper launches the hand-written
kernel of `csrc/unet_tail.cu` (bfloat16, one read of each operand and one
write), which has the same rounding points and equals the plain version
bit for bit; for CPU tensors it runs the plain version. There is no
fallback: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._build import check_launch, cuda_stream
from .conv_cuda import _check_cuda_operand, _ptr

__all__ = ["launch_counts", "reset_launch_counts", "unet_tail", "unet_tail_plain"]

# kernel launches; only a launch of the CUDA kernel counts
launch_counts = {"unet_tail": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def unet_tail_plain(
    y: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    skip: torch.Tensor,
    up: torch.Tensor | None = None,
    style: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of `unet_tail`, in y's dtype."""
    dt = y.dtype
    # in place (in y itself where y is float32 and the output): at 2048^2 x
    # 8 x 32 channels each float32 temporary is 4.3 GB
    f = y.to(torch.float32, copy=out is not y)
    f.mul_(scale[:, None, None, :]).add_(bias[:, None, None, :])
    t = f.to(dt)
    del f
    if up is not None:
        h, w = skip.shape[1:3]
        skip = up.repeat_interleave(2, 1).repeat_interleave(2, 2)[:, :h, :w] + skip
    t += skip.to(dt)
    t.relu_()
    if style is not None:
        t += style.to(dt)[:, None, None, :]
    return t if out is None or out is t else out.copy_(t)


@functools.cache
def _library() -> ctypes.CDLL:
    from .._build import load_kernel_library

    lib = load_kernel_library("unet_tail").lib
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.amt_unet_tail.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i, vp]
    lib.amt_unet_tail.restype = i
    return lib


def unet_tail(
    y: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    skip: torch.Tensor,
    up: torch.Tensor | None = None,
    style: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """GroupNorm-2 affine, residual, ReLU and style add of a U-Net block.

    Args:
        y: (B, H, W, C) conv2 output (bfloat16 on the card).
        scale, bias: (B, C) float32 rows of GroupNorm-2's folded affine.
        skip: (B, H, W, C) residual in y's dtype; with `up`, its
            full-resolution part.
        up: optional (B, ceil(H / 2), ceil(W / 2), C) half-resolution part
            of the residual, nearest-upsampled onto `skip`.
        style: optional (B, C) row in y's dtype, added after the ReLU.
        out: optional (B, H, W, C) tensor in y's dtype to write, y itself
            included; a new tensor otherwise.

    On the card every tensor is contiguous and 16-byte aligned, C a multiple
    of 8 and at most 2048.
    """
    if y.dim() != 4:
        raise ValueError(f"expected y (B, H, W, C), got shape {tuple(y.shape)}")
    if y.device.type == "cpu":
        return unet_tail_plain(y, scale, bias, skip, up, style, out)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    b, h, w, c = y.shape
    dev, bf = y.device, torch.bfloat16
    if c % 8 or c > 2048:
        raise ValueError(f"the CUDA kernel takes C % 8 == 0 and C <= 2048, got C={c}")
    if b > 65535 or h * w >= 2**31:
        raise ValueError(f"the CUDA kernel takes at most 65535 images of fewer than 2^31 pixels, "
                         f"got {tuple(y.shape)}")
    _check_cuda_operand("y", y, (b, h, w, c), bf, dev)
    _check_cuda_operand("scale", scale, (b, c), torch.float32, dev)
    _check_cuda_operand("bias", bias, (b, c), torch.float32, dev)
    _check_cuda_operand("skip", skip, (b, h, w, c), bf, dev)
    if up is not None:
        _check_cuda_operand("up", up, (b, (h + 1) // 2, (w + 1) // 2, c), bf, dev)
    if style is not None:
        _check_cuda_operand("style", style, (b, c), bf, dev)
    if out is None:
        out = torch.empty_like(y)
    else:
        _check_cuda_operand("out", out, (b, h, w, c), bf, dev)
    if y.numel():
        with torch.cuda.device(dev):
            err = _library().amt_unet_tail(_ptr(y), _ptr(scale), _ptr(bias), _ptr(skip), _ptr(up),
                                           _ptr(style), _ptr(out), b, h, w, c, cuda_stream(y))
        check_launch(err, "unet_tail")
        launch_counts["unet_tail"] += 1
    return out
