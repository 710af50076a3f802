"""Masked heat diffusion for the flow-error QC: CUDA kernel and plain version.

Counterpart of `arcadia_microscopy_tools_tpu/models/flows_pallas.py`. Each
of `n_iter` Jacobi iterations does, per image of a (B, H, W) batch,

    T <- where(lbl > 0, fma(T + up + down + left + right, 0.2, src), 0)

where a 4-neighbour contributes its T only if it has the same label (the
image edge counts as another label), summed in that order, starting from
T = src. The JAX loop writes `(...) / 5.0 + src`; XLA compiles that into a
multiplication by the float32 constant 0.2 fused with the add (one
rounding), and the port computes the same.

For CUDA tensors `diffuse` runs the kernels of `csrc/diffuse.cu`. Labels
never exchange heat, so each label is diffused alone. The cell pass finds
every label's bounding box (a box pass over the labels, which also zeroes
the output) and runs all `n_iter` iterations of each label whose box,
padded by one pixel, fits its shared memory, on chip. The pixels of the
other labels (a box too large, or a label above the box table's depth) go
through the dense branch, the blocked stencil over the windows they touch:
ceil(n_iter / 8) launches of up to 8 iterations each (`DIFFUSE_HALO`). The
data chooses the branch; `branch_counts` adds up what the kernels' box pass
counted for each one. For CPU tensors it runs the plain PyTorch loop, which the tests and `chip_smoke.py` hold the kernels against bit for
bit. There is no fallback: a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .._build import check_launch, cuda_stream

__all__ = [
    "DIFFUSE_HALO",
    "branch_counts",
    "diffuse",
    "diffuse_plain",
    "launch_counts",
    "reset_launch_counts",
    "same_label_masks",
]

DIFFUSE_HALO = 8  # iterations per dense launch; the kernel's 128^2 window keeps 112^2
F32_FIFTH = 0.20000000298023224  # the float32 nearest 1/5, which XLA multiplies by
_OFFSETS = ((-1, 0), (1, 0), (0, -1), (0, 1))

# kernel launches per branch; only a launch of a CUDA kernel counts
launch_counts = {"diffuse": 0, "diffuse_dense": 0}
# what the kernels' box pass found, over the CUDA calls since the last reset:
# labels (per image) in the cell pass and in the dense branch, and pixels of
# labels above the box table's depth (dense, not counted as labels)
branch_counts = {"cell_labels": 0, "dense_labels": 0, "pixels_above_table": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, branch_counts):
        for k in counts:
            counts[k] = 0


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
    lib.amt_diffuse_ctl_words.argtypes = [i, i, i, i]
    lib.amt_diffuse_ctl_words.restype = ctypes.c_longlong
    lib.amt_diffuse_boxes.argtypes = [vp, vp, vp, i, i, i, i, vp]
    lib.amt_diffuse_boxes.restype = i
    lib.amt_diffuse_cells.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.amt_diffuse_cells.restype = i
    lib.amt_diffuse_dense.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, vp]
    lib.amt_diffuse_dense.restype = i
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
    if lbl.data_ptr() % 16:  # the box pass reads the labels 16 bytes at a time
        lbl = lbl.clone()
    out = torch.empty_like(src)
    ctl = torch.empty(lib.amt_diffuse_ctl_words(b, h, w, DIFFUSE_HALO), dtype=torch.int32,
                      device=lbl.device)
    stream = cuda_stream(lbl)
    found = torch.empty(4, dtype=torch.int32, pin_memory=True)
    listed = torch.cuda.Event()
    with torch.cuda.device(lbl.device):
        err = lib.amt_diffuse_boxes(lbl.data_ptr(), out.data_ptr(), ctl.data_ptr(), b, h, w,
                                    DIFFUSE_HALO, stream)
        check_launch(err, "diffuse")
        # the windows that hold labels the cell pass leaves and the counts per
        # branch, read while it runs
        found.copy_(ctl[2:6], non_blocking=True)
        listed.record()
        err = lib.amt_diffuse_cells(lbl.data_ptr(), src.data_ptr(), out.data_ptr(),
                                    ctl.data_ptr(), b, h, w, DIFFUSE_HALO, n_iter, stream)
    check_launch(err, "diffuse")
    launch_counts["diffuse"] += 1
    listed.synchronize()
    n_windows, dense_labels, cell_labels, pixels_above = found.tolist()
    branch_counts["cell_labels"] += cell_labels
    branch_counts["dense_labels"] += dense_labels
    branch_counts["pixels_above_table"] += pixels_above
    if n_windows == 0:
        return out
    t = src
    bufs = [torch.empty_like(src), torch.empty_like(src)]
    n_launch = -(-n_iter // DIFFUSE_HALO)
    for k in range(n_launch):
        iters = min(DIFFUSE_HALO, n_iter - k * DIFFUSE_HALO)
        dst = out if k == n_launch - 1 else bufs[k % 2]
        with torch.cuda.device(lbl.device):
            err = lib.amt_diffuse_dense(
                lbl.data_ptr(), t.data_ptr(), src.data_ptr(), dst.data_ptr(), ctl.data_ptr(),
                b, h, w, DIFFUSE_HALO, iters, n_windows, stream,
            )
        check_launch(err, "diffuse_dense")
        launch_counts["diffuse_dense"] += 1
        t = dst
    return out
