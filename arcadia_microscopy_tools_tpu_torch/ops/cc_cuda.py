"""Block-local connected-components sweeps: CUDA kernels and plain versions.

Counterpart of `arcadia_microscopy_tools_tpu/ops/cc_pallas.py`. Phases 1
and 3 of the two-phase labeler (ops/labeling.py) compute, per 128x128 tile,
the in-tile min-label fixpoint of a foreground mask:

- `local_cc` starts every foreground pixel at its own per-image linear
  index y*W + x;
- `local_resweep` starts from a seed label image.

Background and tile-external neighbours hold the sentinel 2^30. The loop is
Jacobi-ordered, two sweeps per iteration, ends early when an iteration
changes nothing, and stops at 256 sweeps.

For CUDA tensors the wrappers launch the hand-written kernels of
`csrc/cc_local.cu`; for CPU tensors they run the plain PyTorch versions,
which the tests and `chip_smoke.py` hold the kernels against bit for bit.
There is no fallback: a CUDA tensor launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .._build import check_launch, cuda_stream

__all__ = [
    "CC_BLOCK",
    "SENTINEL",
    "local_cc",
    "local_resweep",
    "local_cc_plain",
    "local_resweep_plain",
    "tile_sweep_counts",
    "launch_counts",
    "reset_launch_counts",
]

CC_BLOCK = 128  # square tile; also the merge-phase block size
SENTINEL = 1 << 30
_MAX_SWEEPS = 256

_NEIGHBORS_8 = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]
_NEIGHBORS_4 = [(-1, 0), (0, -1), (0, 1), (1, 0)]

# kernel launches per wrapper; only a launch of the CUDA kernel counts
launch_counts = {"local_cc": 0, "local_resweep": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# -- plain PyTorch versions --------------------------------------------------------


def _to_tiles(x: torch.Tensor, fill) -> torch.Tensor:
    """(B, H, W) -> (B * ty * tx, T, T), padding the ragged edge with `fill`."""
    b, h, w = x.shape
    t = CC_BLOCK
    ph, pw = (-h) % t, (-w) % t
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), value=fill)
    ty, tx = (h + ph) // t, (w + pw) // t
    return x.reshape(b, ty, t, tx, t).permute(0, 1, 3, 2, 4).reshape(-1, t, t)


def _from_tiles(tiles: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    t = CC_BLOCK
    ty, tx = -(-h // t), -(-w // t)
    x = tiles.reshape(b, ty, tx, t, t).permute(0, 1, 3, 2, 4).reshape(b, ty * t, tx * t)
    return x[:, :h, :w].contiguous()


def neighbor_offsets(connectivity: int) -> list[tuple[int, int]]:
    """(dy, dx) neighbour offsets: 4-neighbours for connectivity 1, 8 for 2."""
    if connectivity not in (1, 2):
        raise ValueError(f"connectivity must be 1 or 2, got {connectivity}")
    return _NEIGHBORS_8 if connectivity == 2 else _NEIGHBORS_4


def neighbor_min(lbl: torch.Tensor, sentinel: int, offsets) -> torch.Tensor:
    """Minimum label over each pixel and its neighbours at `offsets` for
    (N, H, W) labels; neighbours outside the image hold `sentinel`."""
    h, w = lbl.shape[-2:]
    padded = F.pad(lbl, (1, 1, 1, 1), value=sentinel)
    out = lbl
    for dy, dx in offsets:
        out = torch.minimum(out, padded[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w])
    return out


def _tile_fixpoint(
    lbl: torch.Tensor, fg: torch.Tensor, connectivity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Jacobi min-label sweeps on (N, T, T) tiles. A tile that converged is
    a fixed point of further sweeps, so running every tile until all have
    converged (or the cap) equals a per-tile early exit.

    Returns (labels, sweeps): sweeps is the number of sweeps each tile runs
    with the early exit, the iteration that detects convergence included.
    """
    offsets = neighbor_offsets(connectivity)
    sentinel = torch.tensor(SENTINEL, dtype=lbl.dtype, device=lbl.device)
    sweeps = torch.zeros(lbl.shape[0], dtype=torch.int32, device=lbl.device)
    active = torch.ones(lbl.shape[0], dtype=torch.bool, device=lbl.device)

    def sweep(cur):
        return torch.where(fg, neighbor_min(cur, SENTINEL, offsets), sentinel)

    for _ in range(0, _MAX_SWEEPS, 2):
        new = sweep(sweep(lbl))
        sweeps += 2 * active.to(torch.int32)
        active &= (new != lbl).flatten(1).any(1)
        lbl = new
        if not bool(active.any()):
            break
    return lbl, sweeps


def _plain(
    fg: torch.Tensor, init: torch.Tensor | None, connectivity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tile fixpoint from `init` (None: each pixel's linear index y*W + x).
    Returns (labels (B, H, W), sweeps per tile)."""
    b, h, w = fg.shape
    if init is None:
        init = torch.arange(h * w, dtype=torch.int32, device=fg.device).reshape(1, h, w)
    lbl0 = torch.where(fg, init.to(torch.int32), SENTINEL)
    out, sweeps = _tile_fixpoint(_to_tiles(lbl0, SENTINEL), _to_tiles(fg, False), connectivity)
    return _from_tiles(out, b, h, w), sweeps


def local_cc_plain(fg: torch.Tensor, connectivity: int = 2) -> torch.Tensor:
    """Plain PyTorch version of `local_cc` (same sweeps, same cap)."""
    return _plain(fg, None, connectivity)[0]


def local_resweep_plain(
    fg: torch.Tensor, init: torch.Tensor, connectivity: int = 2
) -> torch.Tensor:
    """Plain PyTorch version of `local_resweep` (same sweeps, same cap)."""
    return _plain(fg, init, connectivity)[0]


def tile_sweep_counts(
    fg: torch.Tensor, connectivity: int = 2, init: torch.Tensor | None = None
) -> torch.Tensor:
    """Sweeps each tile of `local_cc` (or, given `init`, `local_resweep`)
    runs on this mask: the data-dependent work behind a kernel's bound."""
    return _plain(fg, init, connectivity)[1]


# -- CUDA wrappers -----------------------------------------------------------------


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (pointers and
    the stream as void*, sizes as int)."""
    from .._build import load_kernel_library

    lib = load_kernel_library("cc_local").lib
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.amt_cc_local.argtypes = [vp, vp, i, i, i, i, vp]
    lib.amt_cc_local.restype = i
    lib.amt_cc_resweep.argtypes = [vp, vp, vp, i, i, i, i, vp]
    lib.amt_cc_resweep.restype = i
    return lib


def _check_fg(fg: torch.Tensor, connectivity: int) -> None:
    if fg.dim() != 3:
        raise ValueError(f"expected a (B, H, W) mask, got shape {tuple(fg.shape)}")
    if fg.dtype != torch.bool:
        raise TypeError(f"mask must be torch.bool, got {fg.dtype}")
    neighbor_offsets(connectivity)  # validates it
    b, h, w = fg.shape
    if h * w >= SENTINEL:
        raise ValueError(f"image of {h}x{w} pixels reaches the label sentinel 2^30")
    if fg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {fg.device}")
    if fg.device.type == "cuda":
        if not fg.is_contiguous():
            raise ValueError("mask must be contiguous")
        if b > 65535:
            raise ValueError(f"batch of {b} images exceeds the kernel grid")


def local_cc(fg: torch.Tensor, connectivity: int = 2) -> torch.Tensor:
    """In-tile root indices (B, H, W) int32 for a (B, H, W) bool mask.

    Sentinel 2^30 on background. Any H and W: pixels past the ragged edge
    count as background.
    """
    _check_fg(fg, connectivity)
    if fg.device.type == "cpu":
        return local_cc_plain(fg, connectivity)
    b, h, w = fg.shape
    out = torch.empty(fg.shape, dtype=torch.int32, device=fg.device)
    if fg.numel() == 0:
        return out
    with torch.cuda.device(fg.device):
        err = _library().amt_cc_local(
            fg.data_ptr(), out.data_ptr(), b, h, w, connectivity, cuda_stream(fg)
        )
    check_launch(err, "local_cc")
    launch_counts["local_cc"] += 1
    return out


def local_resweep(
    fg: torch.Tensor, init: torch.Tensor, connectivity: int = 2
) -> torch.Tensor:
    """Min-propagate the seed labels `init` to the in-tile fixpoint.

    `init` is int32 (B, H, W) on the mask's device; the result is int32 with
    sentinel 2^30 on background.
    """
    _check_fg(fg, connectivity)
    if init.shape != fg.shape or init.dtype != torch.int32 or init.device != fg.device:
        raise ValueError(
            f"init must be int32 {tuple(fg.shape)} on {fg.device}, got "
            f"{init.dtype} {tuple(init.shape)} on {init.device}"
        )
    if fg.device.type == "cpu":
        return local_resweep_plain(fg, init, connectivity)
    if not init.is_contiguous():
        raise ValueError("init must be contiguous")
    b, h, w = fg.shape
    out = torch.empty(fg.shape, dtype=torch.int32, device=fg.device)
    if fg.numel() == 0:
        return out
    with torch.cuda.device(fg.device):
        err = _library().amt_cc_resweep(
            fg.data_ptr(), init.data_ptr(), out.data_ptr(), b, h, w, connectivity, cuda_stream(fg)
        )
    check_launch(err, "local_resweep")
    launch_counts["local_resweep"] += 1
    return out
