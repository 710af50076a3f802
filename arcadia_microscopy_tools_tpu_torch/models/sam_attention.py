"""Attention with SAM's decomposed relative-position bias: kernel 8 (CUDA)
and its plain version.

`sam_attention(qkv, rel_h, rel_w, heads, grid)` is the attention of one
block of a SAM ViT encoder (models/vit_sam.py) over the grid x grid tokens
of each tile, every head at once: Cellpose-SAM's global blocks on its
tiles (grids 8, 16, 32), SAM's global blocks over its 64 x 64 grid, and
SAM's windowed blocks, where each "tile" is one 14 x 14 window of the
zero-padded token map (grid 14; the caller gathers the windows). For query i = (iy, ix) and key
j = (jy, jx) of a grid x grid token map the logits are

    S[i, j] = (q_i / sqrt(d)) . k_j + q_i . Rh[iy - jy + grid - 1]
                                    + q_i . Rw[ix - jx + grid - 1]

(the bias with the unscaled q, as SAM's `add_decomposed_rel_pos`), then a
softmax over j and the weighted sum of v. q, k and v are read where the
block's qkv Linear put them, a bfloat16 (T, grid^2, 3 W) tensor (q, k, v
side by side, each `heads` heads of d = W / heads), and the output is
written as (T, grid^2, W), heads side by side, the layout the proj Linear
reads: no copy on either side. rel_h and rel_w are the block's
(2 grid - 1, d) tables, already resized to that many rows.

Kernel 8 (`csrc/sam_attention.cu`) replaces no Pallas kernel: the JAX
package runs no vision transformer. It exists because the bias cannot go to
a library attention (`scaled_dot_product_attention` is not the port's, and a
materialised bias would be (N, grid^2, grid^2): 32 MiB of bfloat16 per tile
and block at the published sizes, ~600 GiB of traffic per call of 8
images). It is a flash-attention forward on mma.sync: a block of 4 warps
takes 16 queries a warp of one (tile, head), computes Q Rh^T and
Q Rw^T for them on the tensor cores, keeps each thread's Rw terms in
registers (a key's column repeats in every step of 64 keys) and Q Rh^T in
shared memory, then walks the keys 64 at a time (whole rows of the grid)
through a two-stage cp.async ring, the bias added to the float32 scores, an
online softmax in float32 and P V with P in bfloat16. Neither the bias nor S
ever leaves the chip. Grid 64 stages its 127-row tables in 128. Grid 14
runs a second kernel of the same loop, `sam_window_kernel`: 196 tokens fill
neither its 64-query blocks nor its 64-key steps, so keys past them score
-inf, queries past them are not stored, and each score looks both bias
terms up in shared memory. The source's head comment has the details.

Bound: operations. Per tile and block at the published sizes (16 heads,
1024 tokens, d = 64) Q K^T and P V are 4.295 GFLOP and the two table
products 0.134, 4.478 us at the bf16 peak, against 8.4 MB of q, k, v and o,
2.51 us at 3.35 TB/s (`benchmark/sam_arithmetic.py` counts both).

On a CPU tensor the plain version runs; it materialises the bias in float32
as SAM does and is what the tests and `chip_smoke.py` hold the kernel
against. A CUDA tensor launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._build import check_launch, cuda_stream

__all__ = [
    "launch_counts",
    "reset_launch_counts",
    "sam_attention",
    "sam_attention_plain",
    "split_qkv",
]

# kernel launches (one per call: every tile or window and head of a block):
# the global kernel's instances, and the window kernel's
launch_counts = {"sam_attention": 0, "sam_window_attention": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


_GRIDS = (8, 16, 32, 64)  # the global kernel's instances
_WINDOWS = (14,)  # the window kernel's
_HEAD = 64
_LOG2E = 1.4426950408889634


def _relative_tables(rel: torch.Tensor, grid: int) -> torch.Tensor:
    """(grid, grid, d) table[a, b] = rel[a - b + grid - 1]."""
    idx = torch.arange(grid, device=rel.device)
    return rel[idx[:, None] - idx[None, :] + grid - 1]


def split_qkv(qkv: torch.Tensor, heads: int) -> tuple[torch.Tensor, ...]:
    """(T, L, 3 W) projections -> q, k, v, each (T * heads, L, W / heads)."""
    t, length, w3 = qkv.shape
    qkv = qkv.view(t, length, 3, heads, w3 // (3 * heads)).permute(2, 0, 3, 1, 4)
    return tuple(x.reshape(t * heads, length, -1) for x in qkv)


def sam_attention_plain(qkv: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor, heads: int,
                        grid: int) -> torch.Tensor:
    """Plain PyTorch version: the logits and the bias materialised in
    float32, SAM's `add_decomposed_rel_pos`, softmax, P V; returns qkv's
    dtype, (T, L, W)."""
    _check(qkv, rel_h, rel_w, heads, grid)
    t, length, w3 = qkv.shape
    q, k, v = (x.float() for x in split_qkv(qkv, heads))
    n, _, d = q.shape
    s = (q * d**-0.5) @ k.transpose(1, 2)
    r_q = q.view(n, grid, grid, d)
    bias_h = torch.einsum("nhwc,hkc->nhwk", r_q, _relative_tables(rel_h.float(), grid))
    bias_w = torch.einsum("nhwc,wkc->nhwk", r_q, _relative_tables(rel_w.float(), grid))
    s = s.view(n, grid, grid, grid, grid) + bias_h[..., :, None] + bias_w[..., None, :]
    p = torch.softmax(s.view(n, length, length), dim=-1)
    o = (p @ v).view(t, heads, length, d).transpose(1, 2)
    return o.reshape(t, length, w3 // 3).to(qkv.dtype)


def _check(qkv, rel_h, rel_w, heads: int, grid: int) -> None:
    if qkv.dim() != 3 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"qkv must be (T, L, 3 W) with W a multiple of {heads} heads, got "
                         f"{tuple(qkv.shape)}")
    _, length, w3 = qkv.shape
    if length != grid * grid:
        raise ValueError(f"{length} tokens are not a {grid} x {grid} grid")
    want = (2 * grid - 1, w3 // (3 * heads))
    if tuple(rel_h.shape) != want or tuple(rel_w.shape) != want:
        raise ValueError(f"relative-position tables must be {want}, got {tuple(rel_h.shape)} "
                         f"and {tuple(rel_w.shape)}")
    if len({x.device for x in (qkv, rel_h, rel_w)}) != 1:
        raise ValueError("qkv and the tables lie on different devices")


@functools.cache
def _library() -> ctypes.CDLL:
    from .._build import load_kernel_library

    lib = load_kernel_library("sam_attention").lib
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.amt_sam_attention.argtypes = [vp, vp, vp, vp, i, i, i, ll, ll, ll, ll, ctypes.c_float,
                                      vp]
    lib.amt_sam_attention.restype = i
    return lib


def sam_attention(qkv: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor, heads: int,
                  grid: int) -> torch.Tensor:
    """(T, grid^2, 3 W) qkv projections (q, k, v, each `heads` heads of
    W / heads, as SAM's qkv Linear lays them out) and (2 grid - 1, W / heads)
    tables -> (T, grid^2, W) attention output, heads side by side, in qkv's
    dtype (see the module docstring)."""
    _check(qkv, rel_h, rel_w, heads, grid)
    dev = qkv.device
    if dev.type == "cpu":
        return sam_attention_plain(qkv, rel_h, rel_w, heads, grid)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    t, length, w3 = qkv.shape
    d = w3 // (3 * heads)
    if not all(x.dtype == torch.bfloat16 for x in (qkv, rel_h, rel_w)):
        raise ValueError("the CUDA kernel takes bfloat16 qkv and tables")
    if not all(x.is_contiguous() for x in (qkv, rel_h, rel_w)):
        raise ValueError("the CUDA kernel takes contiguous qkv and tables")
    if any(x.data_ptr() % 16 for x in (qkv, rel_h, rel_w)):
        raise ValueError("the CUDA kernel takes qkv and tables at 16-byte aligned addresses")
    if grid not in _GRIDS + _WINDOWS or d != _HEAD:
        raise ValueError(f"the CUDA kernel takes a grid of {_GRIDS + _WINDOWS} and heads of "
                         f"{_HEAD}, got grid {grid}, head {d}")
    if t * heads > 65535:
        raise ValueError(f"{t * heads} tile-heads exceed the kernel grid")
    out = torch.empty((t, length, w3 // 3), dtype=qkv.dtype, device=dev)
    with torch.cuda.device(dev):
        err = _library().amt_sam_attention(
            qkv.data_ptr(), out.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), t, heads, grid,
            qkv.stride(0), qkv.stride(1), out.stride(0), out.stride(1),
            d**-0.5 * _LOG2E, cuda_stream(qkv))
    kernel = "sam_window_attention" if grid in _WINDOWS else "sam_attention"
    check_launch(err, kernel)
    launch_counts[kernel] += 1
    return out
