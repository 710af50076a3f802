"""GroupNorm moments: the CUDA kernel, its plain version, and GroupNorm.

Counterpart of `arcadia_microscopy_tools_tpu/models/gn_pallas.py`.
`lane_moments` computes per-(image, channel) sums of x and x^2 over the
spatial axes of an NHWC activation in one pass, accumulated in float32. For
CUDA tensors it launches the hand-written kernel of `csrc/gn_moments.cu`; for
CPU tensors it runs the plain PyTorch version, which the tests and
`chip_smoke.py` hold the kernel against. There is no fallback: a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._build import check_launch, cuda_stream

__all__ = [
    "group_norm",
    "lane_moments",
    "lane_moments_plain",
    "launch_counts",
    "reset_launch_counts",
]

# kernel launches; only a launch of the CUDA kernel counts
launch_counts = {"lane_moments": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def lane_moments_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `lane_moments`: float32 sums over (H, W)."""
    f = x.float()
    return f.sum((1, 2)), (f * f).sum((1, 2))


@functools.cache
def _library() -> ctypes.CDLL:
    from .._build import load_kernel_library

    lib = load_kernel_library("gn_moments").lib
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.amt_lane_moments.argtypes = [vp, vp, i, ll, i, vp]
    lib.amt_lane_moments.restype = i
    lib.amt_lane_moments_chunks.argtypes = [ll]
    lib.amt_lane_moments_chunks.restype = i
    return lib


def lane_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (sum, sum of squares) over the spatial axes of an NHWC
    tensor: (B, H, W, C) -> two (B, C) float32 tensors.

    On the card `x` must be contiguous bfloat16 with C a multiple of 8 and
    at most 2048; on the CPU any float dtype runs the plain version.
    """
    if x.dim() != 4:
        raise ValueError(f"expected (B, H, W, C), got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return lane_moments_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, h, w, c = x.shape
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous bfloat16 tensor")
    if c % 8 or c > 2048 or x.data_ptr() % 16:
        raise ValueError(f"the CUDA kernel takes C % 8 == 0, C <= 2048, 16-byte aligned; C={c}")
    if b > 65535:
        raise ValueError(f"batch of {b} images exceeds the kernel grid")
    lib = _library()
    n = h * w
    part = torch.empty((b, lib.amt_lane_moments_chunks(n), 2, c), dtype=torch.float32,
                       device=x.device)
    if x.numel() == 0:
        zeros = torch.zeros((b, c), dtype=torch.float32, device=x.device)
        return zeros, zeros.clone()
    with torch.cuda.device(x.device):
        err = lib.amt_lane_moments(x.data_ptr(), part.data_ptr(), b, n, c, cuda_stream(x))
    check_launch(err, "lane_moments")
    launch_counts["lane_moments"] += 1
    sums = part.sum(1)  # fixed-order reduction over the CTA partials
    return sums[:, 0], sums[:, 1]


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int):
    """GroupNorm of an NHWC activation with the moments from `lane_moments`
    (counterpart of `group_norm_pallas`, same expression): one-pass
    variance clamped at 0, eps 1e-5, the normalize in float32, the result in
    x's dtype."""
    b, h, w, c = x.shape
    g = min(groups, c)
    cg = c // g
    n = h * w * cg
    s1, s2 = lane_moments(x)
    mean = s1.reshape(b, g, cg).sum(2) / n
    var = s2.reshape(b, g, cg).sum(2) / n - mean * mean
    mean_c = mean.repeat_interleave(cg, 1)[:, None, None, :]
    inv_c = torch.rsqrt(var.clamp_min(0.0) + 1e-5).repeat_interleave(cg, 1)[:, None, None, :]
    return ((x.float() - mean_c) * (inv_c * scale) + bias).to(x.dtype)
