"""Per-segment reductions and table lookups, batched over images.

Counterpart of the three functions of
`arcadia_microscopy_tools_tpu/ops/segment_reduce.py` that the segmentation
path calls. The JAX package computes them as one-hot matmuls with bf16
hi/lo splits because scatters and gathers are slow on the TPU; here they
are what they compute: float64 `index_add_` for sums (exact for the counts
and coordinate sums the path takes), `scatter_reduce` for minimums, and
plain indexing for lookups.
"""

from __future__ import annotations

import torch

__all__ = ["segment_min", "segment_sums", "table_lookup"]


def _flat_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(B, N) ids in [0, num_segments) -> (B * N,) ids into one flat table."""
    b = segment_ids.shape[0]
    offset = torch.arange(b, device=segment_ids.device, dtype=torch.int64)[:, None] * num_segments
    return (segment_ids.long() + offset).reshape(-1)


def segment_sums(
    quantities: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    where: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sums of (B, Q, N) `quantities` over each image's (B, N) segment ids
    in [0, num_segments): (B, Q, num_segments) float64. With a (B, N) bool
    `where`, only those elements count (on the card, leaving out a large
    background segment spares millions of atomics on one address)."""
    b, q, n = quantities.shape
    flat = _flat_ids(segment_ids, num_segments)
    vals = quantities.double().permute(0, 2, 1).reshape(b * n, q)
    if where is not None:
        keep = where.reshape(-1)
        flat, vals = flat[keep], vals[keep]
    out = torch.zeros((b * num_segments, q), dtype=torch.float64, device=quantities.device)
    out.index_add_(0, flat, vals)
    return out.reshape(b, num_segments, q).permute(0, 2, 1)


def segment_min(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    empty,
    where: torch.Tensor | None = None,
) -> torch.Tensor:
    """Minimum of (B, N) `values` over each image's segments: (B,
    num_segments) in values' dtype, `empty` where a segment has no member;
    `where` as in `segment_sums`."""
    b = values.shape[0]
    flat, vals = _flat_ids(segment_ids, num_segments), values.reshape(-1)
    if where is not None:
        keep = where.reshape(-1)
        flat, vals = flat[keep], vals[keep]
    out = torch.full((b * num_segments,), empty, dtype=values.dtype, device=values.device)
    out.scatter_reduce_(0, flat, vals, "amin")
    return out.reshape(b, num_segments)


def table_lookup(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`tables[b, ids[b]]` for (B, S) tables and (B, N) ids: (B, N)."""
    return torch.gather(tables, 1, ids.long())
