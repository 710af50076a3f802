"""Per-segment reductions and table lookups, batched over images.

Counterpart of `arcadia_microscopy_tools_tpu/ops/segment_reduce.py`. The
JAX package computes its reductions as one-hot matmuls with bf16 hi/lo
splits because scatters and gathers are slow on the TPU; here they are what
they compute, and every one gives the same bits on every run:

- sums of integer quantities are int64 `index_add_`: exact, so the order of
  the card's atomics cannot show, and partial sums over any split of the
  pixels add up to the whole;
- sums of float quantities are float64 in a fixed order (`index_put_` with
  accumulate sorts by segment on the card; the CPU adds in index order);
- minimums and maximums are `scatter_reduce`, which no order changes;
- lookups are plain indexing.
"""

from __future__ import annotations

import torch

__all__ = ["segment_max", "segment_min", "segment_sums", "table_lookup"]


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
    in [0, num_segments): (B, Q, num_segments), int64 for integer (and
    bool) quantities, exact while each sum stays below 2^63 (the sum of
    squares of a 2048^2 uint16 well stays below 2^54), and float64 in a
    fixed order for float quantities. With a (B, N) bool `where`, only
    those elements count (on the card, leaving out a large background
    segment spares millions of atomics on one address)."""
    b, q, n = quantities.shape
    exact = not quantities.dtype.is_floating_point
    dtype = torch.int64 if exact else torch.float64
    flat = _flat_ids(segment_ids, num_segments)
    vals = quantities.to(dtype).permute(0, 2, 1).reshape(b * n, q)
    if where is not None:
        keep = where.reshape(-1)
        flat, vals = flat[keep], vals[keep]
    out = torch.zeros((b * num_segments, q), dtype=dtype, device=quantities.device)
    if exact or not out.is_cuda:
        out.index_add_(0, flat, vals)
    else:  # the card's index_add_ adds floats in the order its atomics land
        out.index_put_((flat,), vals, accumulate=True)
    return out.reshape(b, num_segments, q).permute(0, 2, 1)


def _segment_extreme(values, segment_ids, num_segments, empty, where, how) -> torch.Tensor:
    b = values.shape[0]
    flat, vals = _flat_ids(segment_ids, num_segments), values.reshape(-1)
    if where is not None:
        keep = where.reshape(-1)
        flat, vals = flat[keep], vals[keep]
    out = torch.full((b * num_segments,), empty, dtype=values.dtype, device=values.device)
    out.scatter_reduce_(0, flat, vals, how)
    return out.reshape(b, num_segments)


def segment_min(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    empty,
    where: torch.Tensor | None = None,
) -> torch.Tensor:
    """Minimum of (B, N) `values` over each image's segments: (B,
    num_segments) in values' dtype, `empty` where a segment has no member
    (`empty` must not be below any value); `where` as in `segment_sums`."""
    return _segment_extreme(values, segment_ids, num_segments, empty, where, "amin")


def segment_max(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    empty,
    where: torch.Tensor | None = None,
) -> torch.Tensor:
    """Maximum of (B, N) `values` over each image's segments, as
    `segment_min` (`empty` must not be above any value)."""
    return _segment_extreme(values, segment_ids, num_segments, empty, where, "amax")


def table_lookup(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`tables[b, ids[b]]` for (B, S) tables and (B, N) ids: (B, N)."""
    return torch.gather(tables, 1, ids.long())
