"""GroupNorm moments: the CUDA kernel, its plain version, and GroupNorm.

Counterpart of `arcadia_microscopy_tools_tpu/models/gn_pallas.py`.
`lane_moments` computes per-(image, channel) sums of x and x^2 over the
spatial axes of an NHWC activation in one pass, accumulated in float32. For
CUDA tensors it launches the hand-written kernel of `csrc/gn_moments.cu`; for
CPU tensors it runs the plain PyTorch version, which the tests and
`chip_smoke.py` hold the kernel against. There is no fallback: a CUDA tensor
launches the kernel or raises.

Both return partial sums over runs of `lane_rows(W)` whole rows (the most
rows, a power of two, within 4096 pixels; 4096 pixels whenever W divides
4096), which one fixed-order sum adds up (`conv_cuda.sum_partials`): a row
slab that starts on a multiple of the run gives the whole image's partials
of those runs, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

import torch.nn.functional as F

from .._build import check_launch, cuda_stream
from .conv_cuda import pairwise_sum, sum_partials

__all__ = [
    "group_norm",
    "lane_chunks",
    "lane_rows",
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


_RUN_PIXELS = 4096  # the most pixels of one partial's run of rows


def lane_rows(w: int) -> int:
    """Rows of one partial's run in an image w pixels wide: the largest
    power of two whose rows hold at most 4096 pixels, at least 1."""
    return 1 << max(0, (_RUN_PIXELS // max(w, 1)).bit_length() - 1)


def lane_chunks(h: int, w: int) -> int:
    """Partials of one image of h x w pixels."""
    return -(-h // lane_rows(w))


def lane_moments_plain(x: torch.Tensor, partials: bool = False):
    """Plain PyTorch version of `lane_moments`: float32 sums over each run
    of lane_rows(W) rows, each in a fixed pairwise order."""
    b, h, w, c = x.shape
    r, k = lane_rows(w), lane_chunks(h, w)
    f = F.pad(x.float(), (0, 0, 0, 0, 0, k * r - h)).reshape(b, k, r * w, c)
    part = torch.stack([pairwise_sum(v, 2) for v in (f, f * f)], 2)
    return part if partials else sum_partials(part)


@functools.cache
def _library() -> ctypes.CDLL:
    from .._build import load_kernel_library

    lib = load_kernel_library("gn_moments").lib
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.amt_lane_moments.argtypes = [vp, vp, i, ll, i, i, vp]
    lib.amt_lane_moments.restype = i
    lib.amt_lane_moments_chunks.argtypes = [ll, i]
    lib.amt_lane_moments_chunks.restype = i
    return lib


def lane_moments(x: torch.Tensor, partials: bool = False):
    """Per-channel (sum, sum of squares) over the spatial axes of an NHWC
    tensor: (B, H, W, C) -> two (B, C) float32 tensors, or with `partials`
    the (B, lane_chunks(H, W), 2, C) partial sums they add up from.

    On the card `x` must be contiguous bfloat16 with C a multiple of 8 and
    at most 2048; on the CPU any float dtype runs the plain version.
    """
    if x.dim() != 4:
        raise ValueError(f"expected (B, H, W, C), got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return lane_moments_plain(x, partials)
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
    n, run = h * w, lane_rows(w) * w
    part = torch.zeros((b, lane_chunks(h, w), 2, c), dtype=torch.float32, device=x.device)
    if x.numel():
        if lib.amt_lane_moments_chunks(n, run) != part.shape[1]:
            raise RuntimeError("the moments kernel's partials differ from lane_chunks")
        with torch.cuda.device(x.device):
            err = lib.amt_lane_moments(x.data_ptr(), part.data_ptr(), b, n, c, run,
                                       cuda_stream(x))
        check_launch(err, "lane_moments")
        launch_counts["lane_moments"] += 1
    return part if partials else sum_partials(part)


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
