"""Foreground compaction: group foreground pixels by component root.

Counterpart of `arcadia_microscopy_tools_tpu/ops/compaction.py`. One stable
sort of each image's root values puts the foreground first, grouped by
component in scan order of the components' first pixels, and ties (the
pixels of one component) in linear-index order - `measure_compacted` reads
each segment's bbox rows from its first and last slot.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CompactSegments", "compact_by_root"]


class CompactSegments(NamedTuple):
    """Foreground pixels grouped by component, padded to a fixed capacity.

    Attributes (leading batch axis B when the roots were batched):
        seg: (B, cap) int32 segment id per slot, 1..num_components in
            component scan order; 0 on padding slots.
        idx: (B, cap) int32 linear pixel index into the source image.
        valid: (B, cap) bool - True where the slot holds a real pixel.
        num_components: (B,) int32 distinct components in the image.
        fg_count: (B,) int32 foreground pixels in the image.
        overflow: (B,) bool - True when fg_count > cap (pixels were dropped).
    """

    seg: torch.Tensor
    idx: torch.Tensor
    valid: torch.Tensor
    num_components: torch.Tensor
    fg_count: torch.Tensor
    overflow: torch.Tensor


def compact_by_root(roots: torch.Tensor, cap: int) -> CompactSegments:
    """Group foreground pixels by root into a `cap`-slot prefix per image.

    Args:
        roots: (B, H, W) or (H, W) int32 root image from
            `labeling.component_roots` (sentinel = H*W on background).
        cap: foreground capacity per image, at most H*W.
    """
    single = roots.dim() == 2
    r = roots[None] if single else roots
    b = r.shape[0]
    n = r.shape[-2] * r.shape[-1]
    flat = r.reshape(b, n)
    s, p = torch.sort(flat, dim=1, stable=True)

    prev = torch.cat([s.new_full((b, 1), -1), s[:, :-1]], 1)
    is_new = s != prev
    fg_sorted = s < n
    num_components = (is_new & fg_sorted).sum(1, dtype=torch.int32)
    fg_count = fg_sorted.sum(1, dtype=torch.int32)

    valid = fg_sorted[:, :cap]
    seg = torch.cumsum((is_new[:, :cap] & valid).to(torch.int32), 1)
    seg = torch.where(valid, seg, 0).to(torch.int32)
    out = CompactSegments(
        seg=seg,
        idx=p[:, :cap].to(torch.int32),
        valid=valid,
        num_components=num_components,
        fg_count=fg_count,
        overflow=fg_count > cap,
    )
    if single:
        return CompactSegments(*(t[0] for t in out))
    return out
