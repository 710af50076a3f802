"""Masked heat diffusion for the flow-error QC: CUDA kernel and plain version.

Counterpart of `arcadia_microscopy_tools_tpu/models/flows_pallas.py`. Each
of `n_iter` Jacobi iterations does, per image of a (B, H, W) batch,

    T <- where(lbl > 0, fma(T + up + down + left + right, 0.2, src), 0)

where a 4-neighbour contributes its T only if it has the same label (the
image edge counts as another label), summed in that order, starting from
T = src. The JAX loop writes `(...) / 5.0 + src`; XLA compiles that into a
multiplication by the float32 constant 0.2 fused with the add (one
rounding), and the port computes the same.

For CUDA tensors `diffuse` runs the temporally blocked kernel of
`csrc/diffuse.cu`: ceil(n_iter / 8) launches of up to 8 iterations each
(`DIFFUSE_HALO`), the last one running the remainder. For CPU tensors it runs the plain
PyTorch loop, which the tests and `chip_smoke.py` hold the kernel against
bit for bit. There is no fallback: a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .._build import check_launch, cuda_stream

__all__ = [
    "DIFFUSE_HALO",
    "diffuse",
    "diffuse_plain",
    "launch_counts",
    "reset_launch_counts",
    "same_label_masks",
]

DIFFUSE_HALO = 8  # iterations per launch; the kernel's 128^2 window keeps 112^2
F32_FIFTH = 0.20000000298023224  # the float32 nearest 1/5, which XLA multiplies by
_OFFSETS = ((-1, 0), (1, 0), (0, -1), (0, 1))

# kernel launches; only a launch of the CUDA kernel counts
launch_counts = {"diffuse": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def same_label_masks(lbl: torch.Tensor) -> list[torch.Tensor]:
    """For (B, H, W) labels, one bool mask per neighbour offset (up, down,
    left, right): the neighbour lies in the image and has the same label."""
    h, w = lbl.shape[-2:]
    padded = F.pad(lbl, (1, 1, 1, 1), value=-1)
    return [padded[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] == lbl for dy, dx in _OFFSETS]


def diffuse_plain(lbl: torch.Tensor, src: torch.Tensor, n_iter: int) -> torch.Tensor:
    """Plain PyTorch version of `diffuse` (the JAX package's `diffuse_xla`,
    batched): the dense loop, one full-image pass per iteration."""
    h, w = lbl.shape[-2:]
    fg = lbl > 0
    same = same_label_masks(lbl)
    zero = torch.zeros((), dtype=src.dtype, device=src.device)
    src64 = src.double()
    t = src
    for _ in range(n_iter):
        tp = F.pad(t, (1, 1, 1, 1))
        acc = t
        for (dy, dx), s in zip(_OFFSETS, same):
            acc = acc + torch.where(s, tp[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w], zero)
        # fma(acc, 0.2f, src) in float64: the product is exact, and with the
        # QC's 0/1 sources the sum is too, so the one rounding is the fma's
        t = torch.where(fg, (acc.double() * F32_FIFTH + src64).float(), zero)
    return t


@functools.cache
def _library() -> ctypes.CDLL:
    from .._build import load_kernel_library

    lib = load_kernel_library("diffuse").lib
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.amt_diffuse_pass.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.amt_diffuse_pass.restype = i
    return lib


def diffuse(lbl: torch.Tensor, src: torch.Tensor, n_iter: int) -> torch.Tensor:
    """`n_iter` masked diffusion iterations from T = src.

    Args:
        lbl: (B, H, W) int32 labels (0 = background).
        src: (B, H, W) float32 source, also the starting T.
        n_iter: iterations (>= 0).

    Returns:
        (B, H, W) float32 T.
    """
    if lbl.dim() != 3 or src.shape != lbl.shape:
        raise ValueError(f"expected (B, H, W) lbl and src, got {tuple(lbl.shape)}, {tuple(src.shape)}")
    if lbl.dtype != torch.int32 or src.dtype != torch.float32 or src.device != lbl.device:
        raise ValueError("lbl must be int32 and src float32, on one device")
    if n_iter < 0:
        raise ValueError(f"need n_iter >= 0, got {n_iter}")
    if lbl.device.type == "cpu":
        return diffuse_plain(lbl, src, n_iter)
    if lbl.device.type != "cuda":
        raise ValueError(f"unsupported device {lbl.device}")
    if not (lbl.is_contiguous() and src.is_contiguous()):
        raise ValueError("lbl and src must be contiguous")
    b, h, w = lbl.shape
    if b > 65535:
        raise ValueError(f"batch of {b} images exceeds the kernel grid")
    if n_iter == 0 or lbl.numel() == 0:
        return src.clone()
    lib = _library()
    bufs = [torch.empty_like(src), torch.empty_like(src)]
    t = src
    remaining = n_iter
    k = 0
    while remaining > 0:
        iters = min(DIFFUSE_HALO, remaining)
        remaining -= iters
        out = bufs[k % 2]
        with torch.cuda.device(lbl.device):
            err = lib.amt_diffuse_pass(
                lbl.data_ptr(), t.data_ptr(), src.data_ptr(), out.data_ptr(),
                b, h, w, DIFFUSE_HALO, iters, cuda_stream(lbl),
            )
        check_launch(err, "diffuse")
        launch_counts["diffuse"] += 1
        t = out
        k += 1
    return t
