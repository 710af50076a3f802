"""Connected-components labeling, batched over images.

Counterpart of `component_roots` and `label` in
`arcadia_microscopy_tools_tpu/ops/labeling.py`, with the same two-phase
structure and the same results:

1. **Tile-local phase** - `cc_cuda.local_cc` labels every foreground pixel
   with the smallest linear index of its component inside its 128x128 tile.
2. **Boundary merge** - label pairs adjacent across tile edges (both sides
   foreground, labels differ) are capped at `pair_cap` per image, in the
   reference's order, and drive a min-label propagation over their distinct
   labels for at most 32 rounds.
3. **Seed + re-sweep** - tile-edge pixels take their merged global roots and
   `cc_cuda.local_resweep` spreads them into tile interiors.

A convergence certificate (no foreground pixel sees a smaller neighbour
label) tells the caller whether the result is exact. The reference's
sort-merge joins, which avoid scatters on the TPU, become `torch.unique`,
`searchsorted` and `scatter_reduce`. The merge loop checks for early exit
on the host.

`relabel_sequential` and `relabel_sequential_filtered` renumber label
images per image of a batch with one stable sort each, as the JAX
functions do. `clear_border`, `num_labels` and `compact_labels` act on one
(H, W) label image. Label values keep their integer dtype: values at or
above 2^31 stay distinct labels, where the JAX package's int32 arithmetic
wraps them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cc_cuda import CC_BLOCK, local_cc, local_resweep, neighbor_min, neighbor_offsets

__all__ = [
    "clear_border",
    "compact_labels",
    "component_roots",
    "label",
    "num_labels",
    "relabel_sequential",
    "relabel_sequential_filtered",
    "resweep_seeds",
]

# the merge propagates minima one boundary-graph hop per round; 32 covers a
# component spanning every tile of a 4096-pixel axis, and the certificate
# catches anything beyond
_MERGE_ITERS = 32


def _shift_cols(b: torch.Tensor, d: int, sentinel: int) -> torch.Tensor:
    """Column d of the result holds b[..., x + d]; sentinel past the edge."""
    if d == 0:
        return b
    if d == 1:
        return F.pad(b[..., 1:], (0, 1), value=sentinel)
    return F.pad(b[..., :-1], (1, 0), value=sentinel)


def _boundary_pairs(lbl: torch.Tensor, sentinel: int, offsets, block: int):
    """Label pairs adjacent across tile edges, flattened per image in the
    reference's order. Returns (La, Lb), each (B, P) int32."""
    b, h, w = lbl.shape
    diag = any(dy != 0 and dx != 0 for dy, dx in offsets)
    shifts = (-1, 0, 1) if diag else (0,)
    pairs_a, pairs_b = [], []
    if h > block:
        a = lbl[:, block - 1 : h - 1 : block, :]  # (B, nb_y, W)
        bb = lbl[:, block:h:block, :]
        for d in shifts:
            pairs_a.append(a.reshape(b, -1))
            pairs_b.append(_shift_cols(bb, d, sentinel).reshape(b, -1))
    if w > block:
        a = lbl[:, :, block - 1 : w - 1 : block]  # (B, H, nb_x)
        bb = lbl[:, :, block:w:block]
        for d in shifts:
            shifted = _shift_cols(bb.transpose(1, 2), d, sentinel).transpose(1, 2)
            pairs_a.append(a.reshape(b, -1))
            pairs_b.append(shifted.reshape(b, -1))
    if not pairs_a:
        empty = lbl.new_full((b, 1), sentinel)
        return empty, empty
    return torch.cat(pairs_a, 1), torch.cat(pairs_b, 1)


def _merge_boundary_pairs(La: torch.Tensor, Lb: torch.Tensor, n: int, pair_cap: int):
    """Min-label propagation over the real boundary edges of each image.

    Labels are made unique across the batch as b * (n + 1) + label. Keeps
    the first `pair_cap` real edges of each image (the reference's stable
    compaction) and runs at most `_MERGE_ITERS` Jacobi rounds.

    Returns (keys, roots): the sorted distinct batch-global labels and the
    batch-global root of each.
    """
    b = La.shape[0]
    real = (La < n) & (Lb < n) & (La != Lb)
    keep = real & (torch.cumsum(real.to(torch.int32), 1) <= pair_cap)
    offset = torch.arange(b, device=La.device, dtype=torch.int64)[:, None] * (n + 1)
    ga = (La.to(torch.int64) + offset)[keep]
    gb = (Lb.to(torch.int64) + offset)[keep]
    keys, inv = torch.unique(torch.cat([ga, gb]), return_inverse=True)
    ua, ub = inv[: ga.numel()], inv[ga.numel() :]
    pv = keys.clone()
    for _ in range(_MERGE_ITERS):
        m = torch.minimum(pv[ua], pv[ub])
        new = pv.scatter_reduce(0, ua, m, "amin").scatter_reduce_(0, ub, m, "amin")
        changed = bool((new != pv).any())
        pv = new
        if not changed:
            break
    return keys, pv


def _strip_mask(h: int, w: int, block: int, device) -> torch.Tensor:
    """Pixels on either side of every internal tile edge."""
    mask = torch.zeros((h, w), dtype=torch.bool, device=device)
    if h > block:
        mask[block - 1 :: block, :] = True
        mask[block::block, :] = True
    if w > block:
        mask[:, block - 1 :: block] = True
        mask[:, block::block] = True
    return mask


def _seed_boundary_strips(lbl, keys, roots, n: int, block: int) -> torch.Tensor:
    """Overwrite every tile-edge pixel's label with its merged global root
    (labels that took no part in a merge keep their value)."""
    b, h, w = lbl.shape
    strips = _strip_mask(h, w, block, lbl.device)
    if not bool(strips.any()) or keys.numel() == 0:
        return lbl
    vals = lbl[:, strips]  # (B, S)
    offset = torch.arange(b, device=lbl.device, dtype=torch.int64)[:, None] * (n + 1)
    gv = vals.to(torch.int64) + offset
    pos = torch.searchsorted(keys, gv).clamp_max(keys.numel() - 1)
    hit = (keys[pos] == gv) & (vals < n)
    resolved = torch.where(hit, (roots[pos] - offset).to(lbl.dtype), vals)
    out = lbl.clone()
    out[:, strips] = resolved
    return out


def _default_pair_cap(n: int) -> int:
    return max(16384, min(65536, n // 64))


def resweep_seeds(fg: torch.Tensor, connectivity: int = 2, pair_cap: int | None = None):
    """Phases 1 and 2 for a (B, H, W) bool mask: tile-local roots with every
    tile-edge pixel replaced by its merged global root - the label image
    the re-sweep starts from (sentinel H*W on background)."""
    offsets = neighbor_offsets(connectivity)
    _, h, w = fg.shape
    n = h * w
    if pair_cap is None:
        pair_cap = _default_pair_cap(n)
    lbl = torch.where(fg, local_cc(fg, connectivity), n)
    La, Lb = _boundary_pairs(lbl, n, offsets, CC_BLOCK)
    keys, roots = _merge_boundary_pairs(La, Lb, n, pair_cap)
    return _seed_boundary_strips(lbl, keys, roots, n, CC_BLOCK).contiguous()


def component_roots(
    fg: torch.Tensor, connectivity: int = 2, pair_cap: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel component root indices for a (B, H, W) or (H, W) mask.

    Returns:
        (roots, converged): `roots` is int32 of the mask's shape holding each
        pixel's component-minimum per-image linear index y*W + x, with
        sentinel H*W on background; `converged` is a bool per image ((B,) or
        ()) certifying the fixpoint - True guarantees the labeling is exact
        even for adversarial shapes or a `pair_cap` overflow.
    """
    offsets = neighbor_offsets(connectivity)
    single = fg.dim() == 2
    fg = (fg[None] if single else fg).to(torch.bool).contiguous()
    n = fg.shape[1] * fg.shape[2]
    seeds = resweep_seeds(fg, connectivity, pair_cap)
    lbl = torch.where(fg, local_resweep(fg, seeds, connectivity), n)

    nb = neighbor_min(lbl, n, offsets)
    converged = ~(fg & (nb < lbl)).flatten(1).any(1)
    if single:
        return lbl[0], converged[0]
    return lbl, converged


def _propagate_checked(fg: torch.Tensor, lbl: torch.Tensor, n: int, offsets) -> torch.Tensor:
    """Global neighbour-min + pointer-jump iteration to the exact fixpoint."""
    b = lbl.shape[0]
    sentinel = lbl.new_full((b, 1), n)

    def jump(cur):
        flat = torch.cat([cur.reshape(b, -1), sentinel], 1)
        return torch.where(fg, torch.gather(flat, 1, cur.reshape(b, -1).long()).view_as(cur), n)

    while True:
        new = torch.where(fg, neighbor_min(lbl, n, offsets), n)
        new = jump(jump(new))
        if not bool((new != lbl).any()):
            return new
        lbl = new


def _rank_roots(roots_flat: torch.Tensor) -> torch.Tensor:
    """Lookup table (B, n + 1): mapping[root] = 1-based rank of the root in
    scan order, 0 elsewhere (a pixel is a root iff its label is its own
    linear index)."""
    b, n = roots_flat.shape
    idx = torch.arange(n, device=roots_flat.device, dtype=roots_flat.dtype)
    is_root = roots_flat == idx
    ranks = torch.cumsum(is_root.to(torch.int32), 1)
    mapping = torch.where(is_root, ranks, 0).to(torch.int32)
    return torch.cat([mapping, mapping.new_zeros((b, 1))], 1)


def label(mask: torch.Tensor, connectivity: int = 2, checked: bool = True) -> torch.Tensor:
    """Label connected components of a (H, W) or (B, H, W) boolean mask.

    Returns int32 labels 1..N per image in scan order of each component's
    first pixel (background 0), matching `skimage.measure.label`. `checked`
    runs the global fixpoint verification, which makes the labels exact for
    any component shape.
    """
    offsets = neighbor_offsets(connectivity)
    single = mask.dim() == 2
    fg = (mask[None] if single else mask).to(torch.bool).contiguous()
    b, h, w = fg.shape
    n = h * w
    roots, _ = component_roots(fg, connectivity)
    if checked:
        roots = _propagate_checked(fg, roots, n, offsets)
    mapping = _rank_roots(roots.reshape(b, n))
    out = torch.gather(mapping, 1, roots.reshape(b, n).long()).reshape(b, h, w)
    out = torch.where(fg, out, 0).to(torch.int32)
    return out[0] if single else out


def _sorted_runs(label_image: torch.Tensor):
    """Stable per-image sort of the flattened labels of a (B, H, W) batch.
    Returns (values, positions, is_new): is_new marks the first slot of each
    run of equal values."""
    b = label_image.shape[0]
    s, pos = torch.sort(label_image.reshape(b, -1), dim=1, stable=True)
    is_new = torch.ones_like(s, dtype=torch.bool)
    is_new[:, 1:] = s[:, 1:] != s[:, :-1]
    return s, pos, is_new


def _scatter_ranks(ranks: torch.Tensor, pos: torch.Tensor, shape) -> torch.Tensor:
    out = torch.empty_like(ranks)
    out.scatter_(1, pos, ranks)
    return out.reshape(shape)


def relabel_sequential(label_image: torch.Tensor) -> torch.Tensor:
    """Relabel each image of a (H, W) or (B, H, W) label batch to
    consecutive labels 1..N, keeping the ascending order of the original
    values (`skimage.segmentation.relabel_sequential`); values <= 0 become
    background. Returns int32."""
    single = label_image.dim() == 2
    lbl = label_image[None] if single else label_image
    s, pos, is_new = _sorted_runs(lbl)
    positive = s > 0
    ranks = torch.where(positive, torch.cumsum((is_new & positive).to(torch.int32), 1), 0)
    out = _scatter_ranks(ranks.to(torch.int32), pos, lbl.shape)
    return out[0] if single else out


def relabel_sequential_filtered(label_image: torch.Tensor, min_size: int) -> torch.Tensor:
    """Drop labels of fewer than `min_size` pixels and relabel the survivors
    to consecutive 1..N in ascending order of their values, per image, in
    one sort (sizes are the run lengths of the sorted labels). Returns int32."""
    single = label_image.dim() == 2
    lbl = label_image[None] if single else label_image
    s, pos, is_new = _sorted_runs(lbl)
    b, n = s.shape
    iota = torch.arange(n, device=s.device).expand(b, n)
    is_last = torch.ones_like(is_new)
    is_last[:, :-1] = is_new[:, 1:]
    first = torch.cummax(torch.where(is_new, iota, 0), 1).values
    last = n - 1 - torch.cummax(torch.where(is_last.flip(1), iota, 0), 1).values.flip(1)
    keep = (s > 0) & (last - first + 1 >= min_size)
    ranks = torch.where(keep, torch.cumsum((is_new & keep).to(torch.int32), 1), 0)
    out = _scatter_ranks(ranks.to(torch.int32), pos, lbl.shape)
    return out[0] if single else out


def clear_border(label_image: torch.Tensor) -> torch.Tensor:
    """Zero every label that occurs on the outer rows or columns of a
    (H, W) label image (`skimage.segmentation.clear_border` for label
    inputs). Raises TypeError for a bool mask: label it first."""
    if label_image.dtype == torch.bool:
        raise TypeError("clear_border expects an integer label image; call label() first")
    lbl = label_image
    border = torch.cat([lbl[0], lbl[-1], lbl[:, 0], lbl[:, -1]]).unique()
    return torch.where(torch.isin(lbl, border) & (lbl > 0), 0, lbl)


def num_labels(label_image: torch.Tensor) -> torch.Tensor:
    """Maximum label value as a 0-dim tensor on the image's device: the
    number of cells of a consecutively labeled image; a sparse label set
    (after `clear_border`) counts its gaps."""
    return label_image.max()


def compact_labels(label_image: torch.Tensor, max_labels: int) -> torch.Tensor:
    """Relabel to consecutive 1..N for labels that lie in [0, max_labels]
    (others are clipped into that range first) without a sort: count each
    value, then map through the running count of the values present.
    Returns int32."""
    clipped = label_image.to(torch.int64).clamp(0, max_labels)
    present = torch.bincount(clipped.reshape(-1), minlength=max_labels + 1)[1:] > 0
    ranks = torch.cumsum(present.to(torch.int32), 0, dtype=torch.int32)
    mapping = F.pad(torch.where(present, ranks, 0), (1, 0))
    return mapping[clipped]
