"""Segment Anything's mask head: the CUDA kernel (kernel 10) and its plain
version.

`sam_upscale(keys, up0, up0_bias, ln_weight, ln_bias, up3, up3_bias, hyper,
grid)` is the end of `SegmentAnything.decode` (models/sam_decoder.py) for a
batch of P prompts: SAM's `output_upscaling` on the two-way transformer's
image side `keys` (ConvT 2 x 2 stride 2 to width / 4, LayerNorm2d eps 1e-6,
GELU, ConvT to width / 8, GELU) and the product of the upscaled map with
the hypernetwork rows of mask tokens 1-3, giving (P, 3, 4 grid, 4 grid) mask
logits. The ConvTs come as `decode` holds them, one product each: `up0`
(4 width / 4, width) with rows c * 4 + dy * 2 + dx, `up3` (4 width / 8,
width / 4) likewise.

The plain version is the PyTorch sequence `decode` ran before the kernel,
moved here as it was; it runs every dtype and width (the float32 decoder,
the CPU, the tests' small decoders). For CUDA tensors the wrapper launches
the hand-written kernel of `csrc/sam_upscale.cu` (bfloat16, SAM's widths 256
-> 64 -> 32, SAM's grid 64 and the tests' 16): it reads `keys` once and writes only
the logits, with the plain version's rounding points; only the order of the
sums inside its three products, and the LayerNorm's statistics (two passes,
not Welford's), differ, and every GELU has the bits of PyTorch's. For CPU
tensors it runs the plain version. There is no fallback: a CUDA tensor
launches the kernel or raises.

Kernel 10 replaces no Pallas kernel: the JAX package runs no mask decoder.
It exists because the plain sequence makes ten passes over tensors of
134-268 MB per prompt batch, strided permute copies and a LayerNorm over 64
channels among them. Design: persistent blocks of two warpgroups, each on
its own tiles of 64 tokens; both ConvT weights resident in shared memory;
the first product on wgmma (m64n256k16) from shared memory, the bias,
LayerNorm and GELU on its accumulators, which become the register A
operand of the second product (m64n64k16 halves), whose epilogue feeds the
third on mma.sync; a GELU table in shared memory patched without a branch
outside its range. The source's head comment has the details.

Bound at P = 64 and grid 64: operations, 52.4 GFLOP (0.053 ms at 989
TFLOP/s), and bytes alike, 134 MB of keys and 25 MB of logits (0.047 ms at
3.35 TB/s); `chip_smoke.py` phase 18 times it against both.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .._build import check_launch, cuda_stream

__all__ = [
    "LN2D_EPS",
    "kernel_takes",
    "launch_counts",
    "reset_launch_counts",
    "sam_upscale",
    "sam_upscale_plain",
]

LN2D_EPS = 1e-6
_WIDTH = 256  # the kernel's keys; the ConvTs take them to 64 channels, then 32
_GRIDS = (16, 64)  # the kernel's instances: SAM's 64 x 64 tokens, and 16 x 16
_MASKS = 3

# kernel launches; only a launch of the CUDA kernel counts
launch_counts = {"sam_upscale": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def kernel_takes(width: int, grid: int, dtype: torch.dtype) -> bool:
    """Whether the kernel computes a decoder of this width, token grid and
    dtype: SAM's widths, bfloat16, one of the kernel's grids."""
    return width == _WIDTH and dtype == torch.bfloat16 and grid in _GRIDS


def sam_upscale_plain(keys: torch.Tensor, up0: torch.Tensor, up0_bias: torch.Tensor,
                      ln_weight: torch.Tensor, ln_bias: torch.Tensor, up3: torch.Tensor,
                      up3_bias: torch.Tensor, hyper: torch.Tensor, grid: int) -> torch.Tensor:
    """Plain PyTorch version of `sam_upscale`, in keys' dtype, channels
    last: ConvT, LayerNorm2d, GELU, ConvT, GELU, the hypernetwork product."""
    _check(keys, up0, up0_bias, ln_weight, ln_bias, up3, up3_bias, hyper, grid)
    n, g = keys.shape[0], grid
    x = F.linear(keys, up0).view(n, g, g, -1, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3).reshape(n, 2 * g, 2 * g, -1) + up0_bias
    x = F.gelu(F.layer_norm(x, (x.shape[-1],), ln_weight, ln_bias, LN2D_EPS))
    x = F.linear(x, up3).view(n, 2 * g, 2 * g, -1, 2, 2)
    x = F.gelu(x.permute(0, 1, 4, 2, 5, 3).reshape(n, 4 * g, 4 * g, -1) + up3_bias)
    masks = torch.matmul(hyper, x.view(n, 16 * g * g, -1).transpose(1, 2))
    return masks.view(n, hyper.shape[1], 4 * g, 4 * g)


def _check(keys, up0, up0_bias, ln_weight, ln_bias, up3, up3_bias, hyper, grid: int) -> None:
    if keys.dim() != 3 or keys.shape[1] != grid * grid:
        raise ValueError(f"keys must be (P, {grid}^2, width), got {tuple(keys.shape)}")
    n, _, w = keys.shape
    if w % 8:
        raise ValueError(f"the width {w} is not a multiple of 8")
    want = {"up0": (up0, (w, w)), "up0_bias": (up0_bias, (w // 4,)),
            "ln_weight": (ln_weight, (w // 4,)), "ln_bias": (ln_bias, (w // 4,)),
            "up3": (up3, (w // 2, w // 4)), "up3_bias": (up3_bias, (w // 8,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if hyper.dim() != 3 or hyper.shape[0] != n or hyper.shape[2] != w // 8:
        raise ValueError(f"hyper must be ({n}, masks, {w // 8}), got {tuple(hyper.shape)}")
    operands = (keys, up0, up0_bias, ln_weight, ln_bias, up3, up3_bias, hyper)
    if len({t.device for t in operands}) != 1 or len({t.dtype for t in operands}) != 1:
        raise ValueError("the operands lie on different devices or have different dtypes")
    if not keys.dtype.is_floating_point:
        raise ValueError(f"the operands must be floating point, got {keys.dtype}")


@functools.cache
def _library() -> ctypes.CDLL:
    from .._build import load_kernel_library

    lib = load_kernel_library("sam_upscale").lib
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.amt_sam_upscale.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, vp]
    lib.amt_sam_upscale.restype = i
    return lib


def sam_upscale(keys: torch.Tensor, up0: torch.Tensor, up0_bias: torch.Tensor,
                ln_weight: torch.Tensor, ln_bias: torch.Tensor, up3: torch.Tensor,
                up3_bias: torch.Tensor, hyper: torch.Tensor, grid: int) -> torch.Tensor:
    """SAM's `output_upscaling` and hypernetwork product.

    Args:
        keys: (P, grid^2, width) the two-way transformer's image side.
        up0, up0_bias: (width, width) and (width / 4,): the first ConvT as
            one product, rows c * 4 + dy * 2 + dx.
        ln_weight, ln_bias: (width / 4,) the LayerNorm2d's affine.
        up3, up3_bias: (width / 2, width / 4) and (width / 8,): the second
            ConvT likewise.
        hyper: (P, masks, width / 8) hypernetwork rows (on the card: the 3
            of mask tokens 1-3).
        grid: the token grid's side.

    Returns (P, masks, 4 grid, 4 grid) mask logits in keys' dtype. On the
    card every tensor is bfloat16 and contiguous, the widths SAM's (256 ->
    64 -> 32) and grid 64 or 16.
    """
    dev = keys.device
    if dev.type == "cpu":
        return sam_upscale_plain(keys, up0, up0_bias, ln_weight, ln_bias, up3, up3_bias, hyper,
                                 grid)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check(keys, up0, up0_bias, ln_weight, ln_bias, up3, up3_bias, hyper, grid)
    operands = (keys, up0, up0_bias, ln_weight, ln_bias, up3, up3_bias, hyper)
    if not kernel_takes(keys.shape[2], grid, keys.dtype):
        raise ValueError(f"the CUDA kernel takes bfloat16, width {_WIDTH} and a grid of "
                         f"{_GRIDS}, got {keys.dtype}, width {keys.shape[2]}, grid {grid}")
    if hyper.shape[1] != _MASKS:
        raise ValueError(f"the CUDA kernel takes {_MASKS} hypernetwork rows, got {hyper.shape[1]}")
    if not all(t.is_contiguous() for t in operands) or any(t.data_ptr() % 16 for t in operands):
        raise ValueError("the CUDA kernel takes contiguous operands at 16-byte aligned addresses")
    n = keys.shape[0]
    out = torch.empty((n, _MASKS, 4 * grid, 4 * grid), dtype=keys.dtype, device=dev)
    if n:
        with torch.cuda.device(dev):
            err = _library().amt_sam_upscale(*(t.data_ptr() for t in operands), out.data_ptr(), n,
                                             grid, cuda_stream(keys))
        check_launch(err, "sam_upscale")
        launch_counts["sam_upscale"] += 1
    return out
