"""Flow-field mask reconstruction, batched over images.

Counterpart of `arcadia_microscopy_tools_tpu/models/flows.py` (the Cellpose
recipe): pixels whose cell probability exceeds the threshold are advected
along the predicted flow; pixels that land in the same sink form one cell;
masks whose flows, recomputed from the mask itself, disagree with the
network's (per-mask mean squared error above `flow_threshold`) are dropped;
labels are renumbered 1..N.

Two routes give the same labels:

- the dense route (`compute_masks`): pointer doubling over the whole image,
  sinks labeled by the connected-components kernels of ops/cc_cuda.py, the
  QC over every pixel;
- the compact route (`compute_masks_sparse_compact`, the plate runner's):
  the active pixels are listed once (`cap` slots per image) and every later
  stage - the doubling, the arrival counts, the sink clustering, the size
  filter, the QC's per-label reductions, the border filter - runs on that
  list. Sinks are clustered by a union-find over the sink pixels, not by a
  labeling of the image. `compute_masks_sparse_compact_s2d` is the same
  route reading the S2D head output of `models/unet_s2d.py`.

Every function takes a leading batch axis B and computes each image as the
JAX function computes it alone. Flat pixel indices are int64 (the JAX
package's float32 indices are exact only up to 2^24 pixels). Per-label
reductions are exact integer sums or float64 sums in a fixed order, and
lookups plain indexing (ops/segment_reduce.py). The flow-error QC's diffusion runs
the CUDA kernel of `flows_cuda.diffuse` on the card in both routes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.labeling import label, relabel_sequential, relabel_sequential_filtered
from ..ops.segment_reduce import segment_min, segment_sums, table_lookup
from .flows_cuda import diffuse, same_label_masks
from .unet_s2d import _d2s

__all__ = [
    "CompactMasks",
    "compute_masks",
    "compute_masks_sparse",
    "compute_masks_sparse_compact",
    "compute_masks_sparse_compact_s2d",
    "flow_error",
    "follow_flows",
    "follow_flows_indices",
    "follow_flows_indices_sparse",
    "masks_from_flows",
    "masks_from_landing",
    "masks_to_flows",
]

_QC_ITERS = 128  # diffusion iterations of the flow-error QC (JAX: n_iter=128)
_F32_MAX = torch.finfo(torch.float32).max


def _sum_of_squares(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p*p + q*q as the JAX package computes it on XLA: fma(p, p, RN(q*q)),
    one rounding after the first product (float64 holds p*p exactly)."""
    return (p.double() * p.double() + (q * q).double()).float()


def _grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None].expand(h, w)
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :].expand(h, w)
    return yy, xx


def _bilinear_sample(field: torch.Tensor, py: torch.Tensor, px: torch.Tensor, h: int, w: int):
    """(B, N) samples of the flattened (B, H * W) `field` at float positions
    by bilinear interpolation, indices clamped to the image (the arithmetic
    of `jax.scipy.ndimage.map_coordinates(order=1, mode="nearest")`: corner
    weights (1 - f) and f of the floor, products of the two axes' weights,
    summed in the corner order (y0, x0), (y0, x1), (y1, x0), (y1, x1))."""
    y0f, x0f = torch.floor(py), torch.floor(px)
    wy1, wx1 = py - y0f, px - x0f
    wy0, wx0 = 1 - wy1, 1 - wx1
    y0, x0 = y0f.long(), x0f.long()
    ys = (y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1))
    xs = (x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1))
    out = None
    for wy, y in zip((wy0, wy1), ys):
        for wx, x in zip((wx0, wx1), xs):
            term = (wy * wx) * torch.gather(field, 1, y * w + x)
            out = term if out is None else out + term
    return out


def follow_flows(flows: torch.Tensor, active: torch.Tensor, niter: int = 200) -> torch.Tensor:
    """Advect every active pixel along the flow field for `niter` Euler
    steps with bilinear sampling (the sub-pixel variant; mask reconstruction
    uses `follow_flows_indices`).

    flows: (B, H, W, 2) [dY, dX]; active: (B, H, W) bool. Returns (B, H, W,
    2) float32 final positions; inactive pixels stay put.
    """
    b, h, w = active.shape
    yy, xx = _grid(h, w, active.device)
    py = yy.reshape(1, h * w).expand(b, -1)
    px = xx.reshape(1, h * w).expand(b, -1)
    fy = flows[..., 0].float().reshape(b, h * w)
    fx = flows[..., 1].float().reshape(b, h * w)
    act = active.reshape(b, h * w)
    zero = torch.zeros((), device=active.device)
    for _ in range(niter):
        dy = _bilinear_sample(fy, py, px, h, w)
        dx = _bilinear_sample(fx, py, px, h, w)
        py = (py + torch.where(act, dy, zero)).clamp(0.0, h - 1)
        px = (px + torch.where(act, dx, zero)).clamp(0.0, w - 1)
    return torch.stack([py, px], -1).reshape(b, h, w, 2)


def follow_flows_indices(flows: torch.Tensor, active: torch.Tensor, niter: int = 200) -> torch.Tensor:
    """Flat landing index of each active pixel after >= `niter` steps of
    the rounded dynamics p <- round(p + F[p]), by pointer doubling with an
    early exit, capped at ceil(log2 niter) compositions.

    flows: (B, H, W, 2) [dY, dX]; active: (B, H, W) bool. Returns (B, H, W)
    int64; inactive pixels map to themselves.
    """
    nxt = _successors(flows, active)
    for _ in range(_doubling_steps(niter)):
        new = torch.gather(nxt, 1, nxt)
        changed = bool((new != nxt).any())
        nxt = new
        if not changed:
            break
    return nxt.reshape(active.shape)


def _neighbourhood_max(x: torch.Tensor) -> torch.Tensor:
    """Maximum over each pixel's 3x3 neighbourhood of (B, H, W), zero outside."""
    h, w = x.shape[-2:]
    padded = F.pad(x, (1, 1, 1, 1))
    out = x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = torch.maximum(out, padded[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w])
    return out


def masks_from_landing(
    landing: torch.Tensor, active: torch.Tensor, min_size: int = 15, sink_count: int = 3
) -> torch.Tensor:
    """Cluster converged pixels into instance masks.

    Landing pixels with at least `sink_count` arrivals are sinks; sinks one
    3x3 dilation apart merge through 8-connected labeling; every active
    pixel takes the label at its landing pixel, or, where that pixel is no
    sink, the largest label of its 3x3 neighbourhood. Masks of fewer than
    `min_size` pixels are dropped (without renumbering). Returns (B, H, W)
    int32.
    """
    b, h, w = active.shape
    n = h * w
    act = active.reshape(b, n)
    land = landing.reshape(b, n).long()
    # inactive pixels add 0 at index n - 1, as in the JAX package
    counts = torch.zeros((b, n), dtype=torch.int32, device=active.device)
    counts.scatter_add_(1, torch.where(act, land, n - 1), act.to(torch.int32))
    sink_map = (counts >= sink_count).reshape(b, h, w)
    sink_dil = _neighbourhood_max(sink_map.to(torch.uint8)).bool()
    sink_labels = torch.where(sink_map, label(sink_dil), 0)
    composite = torch.where(sink_labels > 0, sink_labels, _neighbourhood_max(sink_labels))
    labels = torch.gather(composite.reshape(b, n), 1, land)
    labels = torch.where(act, labels, 0).reshape(b, h, w)
    if min_size > 0:
        sizes = torch.zeros((b, n + 1), dtype=torch.int64, device=labels.device)
        flat = labels.reshape(b, n).long()
        sizes.scatter_add_(1, flat, torch.ones_like(flat))
        keep = torch.gather(sizes, 1, flat) >= min_size
        labels = torch.where(keep.reshape(b, h, w), labels, 0)
    return labels


def masks_from_flows(
    final_positions: torch.Tensor, active: torch.Tensor, min_size: int = 15, sink_count: int = 3
) -> torch.Tensor:
    """`masks_from_landing` for the float positions of `follow_flows`:
    each position rounded (half to even) and clamped to the image."""
    b, h, w = active.shape
    land_y = torch.round(final_positions[..., 0]).long().clamp(0, h - 1)
    land_x = torch.round(final_positions[..., 1]).long().clamp(0, w - 1)
    return masks_from_landing(land_y * w + land_x, active, min_size, sink_count)


def _centre_sources(lbl: torch.Tensor, max_cells: int) -> torch.Tensor:
    """1.0 at each label's centre pixel, the pixel closest to the label's
    centroid (ties to the smaller flat index); labels above `max_cells`
    share one segment, as in the JAX package. Background (segment 0) takes
    no part: its centre is never used."""
    b, h, w = lbl.shape
    n = h * w
    nseg = max_cells + 1
    seg = lbl.reshape(b, n).clamp(0, max_cells)
    fg = seg > 0
    yy, xx = _grid(h, w, lbl.device)
    yf = yy.reshape(1, n).expand(b, n)
    xf = xx.reshape(1, n).expand(b, n)
    grid = torch.stack([torch.ones_like(yf), yf, xf], 1).long()  # exact integer sums
    sums = segment_sums(grid, seg, nseg, fg).float()
    area = sums[:, 0].clamp_min(1.0)
    cy, cx = sums[:, 1] / area, sums[:, 2] / area
    d2 = _sum_of_squares(yf - table_lookup(cy, seg), xf - table_lookup(cx, seg))
    d2 = torch.where(fg, d2, _F32_MAX)
    dmin = segment_min(d2, seg, nseg, _F32_MAX, fg)
    candidate = (d2 == table_lookup(dmin, seg)) & fg
    idx = torch.arange(n, device=lbl.device).expand(b, n)
    centre = segment_min(torch.where(candidate, idx, n), seg, nseg, n, fg)
    is_centre = candidate & (idx == table_lookup(centre, seg))
    return is_centre.reshape(b, h, w).float()


def _diffuse_and_gradient(lbl: torch.Tensor, source: torch.Tensor, n_iter: int) -> torch.Tensor:
    """Diffuse heat from `source` within each label, then the unit gradient
    of log1p(T) by central differences inside the label: (B, H, W, 2)."""
    fg = lbl > 0
    t = torch.log1p(diffuse(lbl, source, n_iter))
    h, w = lbl.shape[-2:]
    tp = F.pad(t, (1, 1, 1, 1))  # never read: the edge is another label
    up, down, left, right = (
        torch.where(s, tp[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w], t)
        for (dy, dx), s in zip(((-1, 0), (1, 0), (0, -1), (0, 1)), same_label_masks(lbl))
    )
    gy = (down - up) / 2.0
    gx = (right - left) / 2.0
    norm = torch.sqrt(_sum_of_squares(gy, gx))
    ok = fg & (norm > 1e-6)
    denom = norm.clamp_min(1e-6)
    zero = torch.zeros((), device=t.device)
    return torch.stack([torch.where(ok, gy / denom, zero), torch.where(ok, gx / denom, zero)], -1)


def masks_to_flows(labels: torch.Tensor, max_cells: int, n_iter: int = _QC_ITERS):
    """Flows a label image implies (the Cellpose target construction):
    heat diffused from each cell's centre within the cell, then the unit
    gradient. Returns ((B, H, W, 2) float32 flows, (B, H, W) bool fg)."""
    lbl = labels.to(torch.int32).contiguous()
    source = _centre_sources(lbl, max_cells)
    return _diffuse_and_gradient(lbl, source, n_iter), lbl > 0


def flow_error(labels: torch.Tensor, predicted_flows: torch.Tensor, max_cells: int) -> torch.Tensor:
    """Per-mask mean squared error between predicted unit flows (B, H, W, 2)
    and the flows the masks imply: (B, max_cells) float32 for labels
    1..max_cells (labels above share the last entry)."""
    computed, _ = masks_to_flows(labels, max_cells)
    b, h, w = labels.shape
    seg = labels.reshape(b, h * w).long().clamp(0, max_cells)
    se = ((predicted_flows.float() - computed) ** 2).sum(-1).reshape(b, h * w)
    # segment 0 (background) is dropped from the result, so it is not summed
    sums = segment_sums(torch.stack([se, torch.ones_like(se)], 1), seg, max_cells + 1, seg > 0)
    err = (sums[:, 0] / sums[:, 1].clamp_min(1.0)).float()
    return err[:, 1:]


def _finish_masks(landing, active, flows, flow_threshold: float, max_cells: int, min_size: int):
    """Sink clustering, size filter, flow-error QC, sequential relabel."""
    labels = relabel_sequential_filtered(masks_from_landing(landing, active, min_size=0), min_size)
    if flow_threshold > 0:
        bad = flow_error(labels, flows, max_cells) > flow_threshold
        bad = F.pad(bad, (1, 0))  # label 0 is never bad
        keep = ~table_lookup(bad, labels.reshape(labels.shape[0], -1).clamp(0, max_cells))
        labels = relabel_sequential(torch.where(keep.reshape(labels.shape), labels, 0))
    return labels


def _successors(flows: torch.Tensor, active: torch.Tensor, row0: int = 0,
                height: int | None = None) -> torch.Tensor:
    """(B, H * W) flat index of each pixel's one-step successor under the
    rounded dynamics; inactive pixels are their own successors. For the rows
    [row0, row0 + H) of an image of `height` rows the indices are the whole
    image's."""
    b, h, w = active.shape
    height = h if height is None else height
    yy, xx = _grid(h, w, active.device)
    yy = yy + row0  # exact: row indices are small integers
    ny = torch.round(yy + flows[..., 0].float()).long().clamp(0, height - 1)
    nx = torch.round(xx + flows[..., 1].float()).long().clamp(0, w - 1)
    own = torch.arange(row0 * w, (row0 + h) * w, device=active.device).reshape(h, w)
    return torch.where(active, ny * w + nx, own).reshape(b, h * w)


def _doubling_steps(niter: int) -> int:
    return max(1, math.ceil(math.log2(max(niter, 2))))


def _segments_fit(act: torch.Tensor, cap: int, n: int | None = None, reduce=None) -> torch.Tensor:
    """(B,) bool: the JAX package's two-stage compaction keeps every active
    8-pixel segment. It takes that route when n >= 2^20, cap <= n and 8 | n,
    and then keeps at most max(1, min(cap // 4, n // 8)) segments; a well
    with more reports a capacity overflow, so the port reports the same.
    `act` may be a run of the image's n pixels that starts and ends on
    segment edges, and `reduce` then sums the runs' segment counts."""
    b, p = act.shape
    n = p if n is None else n
    if not (n >= (1 << 20) and cap <= n and n % 8 == 0):
        return torch.ones(b, dtype=torch.bool, device=act.device)
    segments = act.reshape(b, p // 8, 8).any(-1).sum(-1)
    if reduce is not None:
        segments = reduce(segments, "sum")
    return segments <= max(1, min(cap // 4, n // 8))


def _follow_sparse_core(flows: torch.Tensor, active: torch.Tensor, niter: int, cap: int):
    """Compact-domain flow integration shared by the sparse entry points.

    Returns (idx, valid, landing_compact, ok), each with a leading batch
    axis: `idx` (B, cap) int64 holds the active flat indices in ascending
    order, n on padding slots; `landing_compact` the flat landing index of
    each listed pixel after >= `niter` steps; `ok` is False when the active
    pixels exceed `cap` (or the reference's segment budget, see
    `_segments_fit`), and the list is then incomplete.

    The list is read off the running count of active pixels (a search for
    each slot's rank), and a pixel's slot is its running count - 1, so no
    scatter writes twice to one place. The doubling runs all ceil(log2
    niter) rounds: after the fixpoint a round changes nothing, so the bits
    equal the reference's early exit without a read back to the host.
    """
    b, h, w = active.shape
    n = h * w
    dev = active.device
    nxt = _successors(flows, active)
    act = active.reshape(b, n)
    count = torch.cumsum(act, 1)
    ok = (count[:, -1] <= cap) & _segments_fit(act, cap)
    ranks = torch.arange(1, cap + 1, device=dev).expand(b, cap).contiguous()
    idx = torch.searchsorted(count, ranks)  # n past the last active pixel
    valid = idx < n
    succ = torch.gather(nxt, 1, torch.where(valid, idx, 0))
    return idx, valid, _land_listed(idx, valid, succ, niter), ok


def _land_listed(idx, valid, succ, niter: int) -> torch.Tensor:
    """(B, cap) landing index of each listed pixel after >= `niter` steps:
    `idx` the listed active pixels in ascending order (n on padding slots),
    `succ` each one's one-step successor. A successor outside the list (an
    inactive pixel, or one past the cap) is a fixpoint; the doubling runs
    all ceil(log2 niter) rounds."""
    b, cap = idx.shape
    iota = torch.arange(cap, device=idx.device).expand(b, cap)
    pos = torch.searchsorted(idx, succ).clamp_max(cap - 1)  # the successor's slot, if listed
    comp = torch.where(valid & (torch.gather(idx, 1, pos) == succ), pos, iota)
    for _ in range(_doubling_steps(niter)):
        comp = torch.gather(comp, 1, comp)
    return torch.gather(torch.where(valid, idx, 0), 1, comp)


def follow_flows_indices_sparse(
    flows: torch.Tensor, active: torch.Tensor, niter: int = 200, cap: int = 65536
) -> tuple[torch.Tensor, torch.Tensor]:
    """`follow_flows_indices` over the active pixels only (at most `cap`
    per image). Returns ((B, H, W) int64 landing indices, inactive pixels
    mapping to themselves; (B,) bool ok, False when the list overflowed
    and the landings are incomplete)."""
    b, h, w = active.shape
    n = h * w
    idx, valid, landing_c, ok = _follow_sparse_core(flows, active, niter, cap)
    landing = torch.arange(n + 1, device=active.device).repeat(b, 1)
    landing.scatter_(1, torch.where(valid, idx, n), torch.where(valid, landing_c, n))
    return landing[:, :n].reshape(b, h, w), ok


_UF_ROUNDS_PER_CHECK = 4  # union-find rounds between reads of the fixpoint test
# Chebyshev offsets within 3 pixels: sinks this close share a cluster (the
# dense route's one-pixel dilation plus 8-connected labeling)
_NEAR = [(dy, dx) for dy in range(-3, 4) for dx in range(-3, 4) if dy or dx]


def _sink_neighbours(sink_pos: torch.Tensor, real: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, S, 48) slot of each sink's sinks within Chebyshev distance 3
    (the sink itself where there is none), found by binary search in the
    ascending sink positions."""
    b, s = sink_pos.shape
    n = h * w
    off = torch.tensor(_NEAR, device=sink_pos.device)
    ty = (sink_pos // w)[..., None] + off[:, 0]
    tx = (sink_pos % w)[..., None] + off[:, 1]
    inside = real[..., None] & (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)
    target = torch.where(inside, ty * w + tx, n + 1).reshape(b, -1)
    j = torch.searchsorted(sink_pos, target).clamp_max(s - 1)
    found = torch.gather(sink_pos, 1, j) == target
    own = torch.arange(s, device=sink_pos.device).expand(b, s)[..., None]
    return torch.where(found.reshape(b, s, -1), j.reshape(b, s, -1), own)


def _union_find(nbr: torch.Tensor) -> torch.Tensor:
    """Each sink's cluster root, the smallest slot in its connected
    component: min-label propagation over the neighbour table, then one
    pointer jump, per round, run to the fixpoint (the reference's
    `while_loop` has no round cap). A round at the fixpoint is the
    identity, so the host looks only every `_UF_ROUNDS_PER_CHECK` rounds."""
    b, s, k = nbr.shape
    flat = nbr.reshape(b, s * k)
    rep = torch.arange(s, device=nbr.device).repeat(b, 1)
    while True:
        for _ in range(_UF_ROUNDS_PER_CHECK):
            prev = rep
            new = torch.minimum(rep, torch.gather(rep, 1, flat).reshape(b, s, k).amin(-1))
            rep = torch.gather(new, 1, new)
        if torch.equal(rep, prev):
            return rep


def _cluster_landings_compact(idx, valid, landing_compact, h: int, w: int, sink_count: int,
                              sink_cap: int):
    """Sink clustering in the compact domain: the labels of
    `masks_from_landing(min_size=0)` for each listed pixel.

    - Arrival counts are the run lengths of one sort of the landings.
    - Sinks within Chebyshev distance 3 share a cluster (the dense route's
      dilation by one pixel and 8-connected labeling); a union-find over at
      most `sink_cap` sink pixels replaces the labeling of the image.
    - Clusters are numbered in the dense labeling's scan order: by the
      smallest clamped top-left corner (y - 1, x - 1) over their sinks.
    - Each listed pixel takes the label of its landing pixel if that is a
      sink, else the largest label of the landing pixel's 3x3 neighbourhood.

    Returns ((B, cap) int32 labels, 0 for none; (B,) bool, set when the
    sink pixels exceed `sink_cap` and the labels are incomplete).
    """
    b, cap = idx.shape
    n = h * w
    dev = idx.device
    ls = torch.sort(torch.where(valid, landing_compact, n), 1).values
    iota = torch.arange(cap, device=dev).expand(b, cap)
    edge = torch.ones((b, 1), dtype=torch.bool, device=dev)
    differs = ls[:, 1:] != ls[:, :-1]
    is_new = torch.cat([edge, differs], 1)
    is_last = torch.cat([differs, edge], 1)
    first = torch.cummax(torch.where(is_new, iota, 0), 1).values
    last = cap - 1 - torch.cummax(torch.where(is_last.flip(1), iota, 0), 1).values.flip(1)
    sink_run = is_new & (last - first + 1 >= sink_count) & (ls < n)
    rank = torch.cumsum(sink_run, 1)
    overflow = rank[:, -1] > sink_cap

    # ascending sink positions, n on padding slots
    at = torch.searchsorted(rank, torch.arange(1, sink_cap + 1, device=dev).expand(b, sink_cap)
                            .contiguous())
    sink_pos = torch.where(at < cap, torch.gather(ls, 1, at.clamp_max(cap - 1)), n)
    real = sink_pos < n
    rep = _union_find(_sink_neighbours(sink_pos, real, h, w))

    iota_s = torch.arange(sink_cap, device=dev).expand(b, sink_cap)
    sy, sx = sink_pos // w, sink_pos % w
    tl = torch.where(real, (sy - 1).clamp_min(0) * w + (sx - 1).clamp_min(0), n)
    key_root = torch.full((b, sink_cap), n, dtype=torch.int64, device=dev)
    key_root.scatter_reduce_(1, rep, tl, "amin")
    root_key = torch.where((rep == iota_s) & real, key_root, n)
    order = torch.argsort(root_key, dim=1, stable=True)
    numbered = torch.where(torch.gather(root_key, 1, order) < n, iota_s + 1, 0)
    root_label = torch.zeros((b, sink_cap), dtype=torch.int64, device=dev).scatter_(1, order, numbered)
    lab_sink = torch.where(real, torch.gather(root_label, 1, rep), 0).to(torch.int32)

    img = torch.zeros((b, n + 1), dtype=torch.int32, device=dev)
    img.scatter_(1, sink_pos, lab_sink)  # padding slots write 0 at n
    img = img[:, :n].reshape(b, h, w)
    composite = torch.where(img > 0, img, _neighbourhood_max(img)).reshape(b, n)
    lab_c = torch.gather(composite, 1, torch.where(valid, landing_compact, 0))
    return torch.where(valid, lab_c, 0), overflow


def _flow_error_compact(idx, valid, lab_c, labels, predicted_flows, max_cells: int,
                        n_iter: int = _QC_ITERS, pred_c=None) -> torch.Tensor:
    """`flow_error` with every per-label reduction on the listed pixels.

    Each label's centre is the pixel nearest its centroid, ties to the
    smallest flat index. The centroid sums are exact integer sums rounded
    to float32 (the reference's are exact in float32 below 2^24). The
    diffusion and the gradient run on the full image, through the same
    `_diffuse_and_gradient` as the dense route. `labels` must be the
    scatter of `lab_c` at `idx`. The predicted flows are the (B, H, W, 2)
    `predicted_flows`, or with `pred_c` (B, cap, 2) the listed pixels' own
    (`predicted_flows` is then not read). Returns (B, max_cells) float32."""
    b, h, w = labels.shape
    n = h * w
    nseg = max_cells + 1
    seg = torch.where(valid, lab_c.long().clamp(0, max_cells), 0)
    fg = seg > 0
    idx_safe = torch.where(valid, idx, 0)
    y, x = idx_safe // w, idx_safe % w
    sums = torch.zeros((b, 3, nseg), dtype=torch.int64, device=idx.device)
    for k, v in enumerate((fg.long(), y * fg, x * fg)):
        sums[:, k].scatter_add_(1, seg, v)
    area = sums[:, 0].float().clamp_min(1.0)
    cy, cx = sums[:, 1].float() / area, sums[:, 2].float() / area
    d2 = _sum_of_squares(y.float() - table_lookup(cy, seg), x.float() - table_lookup(cx, seg))
    d2 = torch.where(fg, d2, _F32_MAX)
    dmin = segment_min(d2, seg, nseg, _F32_MAX, fg)
    candidate = fg & (d2 == table_lookup(dmin, seg))
    centre = segment_min(torch.where(candidate, idx_safe, n), seg, nseg, n, fg)
    is_centre = candidate & (idx_safe == table_lookup(centre, seg))
    source = torch.zeros((b, n + 1), dtype=torch.float32, device=idx.device)
    source.scatter_(1, torch.where(is_centre, idx_safe, n), 1.0)
    source = source[:, :n].reshape(b, h, w).contiguous()

    computed = _diffuse_and_gradient(labels.to(torch.int32).contiguous(), source, n_iter)
    pick = idx_safe[..., None].expand(b, idx.shape[1], 2)
    if pred_c is None:
        pred_c = torch.gather(predicted_flows.float().reshape(b, n, 2), 1, pick)
    comp_c = torch.gather(computed.reshape(b, n, 2), 1, pick)
    se = ((pred_c - comp_c) ** 2).sum(-1)
    sums2 = segment_sums(torch.stack([se, torch.ones_like(se)], 1), seg, nseg, fg)
    return (sums2[:, 0] / sums2[:, 1].clamp_min(1.0)).float()[:, 1:]


def _scatter_labels(idx, valid, lab_c, h: int, w: int) -> torch.Tensor:
    """(B, H, W) int32 image with `lab_c` at the listed pixels, 0 elsewhere."""
    b = idx.shape[0]
    n = h * w
    img = torch.zeros((b, n + 1), dtype=torch.int32, device=idx.device)
    img.scatter_(1, torch.where(valid, idx, n), torch.where(valid, lab_c, 0).to(torch.int32))
    return img[:, :n].reshape(b, h, w).contiguous()


def _renumber(keep: torch.Tensor, lab_c: torch.Tensor) -> torch.Tensor:
    """Labels kept by the (B, L) per-label flags, renumbered 1.. in
    ascending order; the others 0."""
    mapping = torch.where(keep, torch.cumsum(keep, 1), 0)
    return torch.gather(mapping, 1, lab_c.long()).to(torch.int32)


def _finish_masks_compact(idx, valid, landing_compact, flows, h: int, w: int,
                          flow_threshold: float, max_cells: int, min_size: int,
                          sink_count: int = 3, sink_cap: int | None = None,
                          clear_border_labels: bool = False, pred_c=None):
    """Compact-domain tail: sink clustering, size filter and renumbering,
    flow-error QC and renumbering, and, with `clear_border_labels`, the
    removal (without renumbering, as `clear_border` does) of every label
    that owns a border pixel. The QC reads `flows` (B, H, W, 2), or the
    listed pixels' own `pred_c` (B, cap, 2) when given.

    Returns ((B, H, W) int32 labels, (B, cap) int32 label of each listed
    pixel, (B,) bool sink overflow)."""
    if sink_cap is None:
        sink_cap = max(1024, 16 * max_cells)
    b = idx.shape[0]
    lab_c, sink_overflow = _cluster_landings_compact(
        idx, valid, landing_compact, h, w, sink_count, sink_cap
    )
    ids = torch.arange(sink_cap + 1, device=idx.device).expand(b, -1)
    sizes = torch.zeros((b, sink_cap + 1), dtype=torch.int64, device=idx.device)
    sizes.scatter_add_(1, lab_c.long(), valid.long())
    lab_c = _renumber((ids > 0) & (sizes > 0) & (sizes >= min_size), lab_c)
    labels = _scatter_labels(idx, valid, lab_c, h, w)

    if flow_threshold > 0:
        err = _flow_error_compact(idx, valid, lab_c, labels, flows, max_cells, pred_c=pred_c)
        bad = err > flow_threshold
        bad = F.pad(bad, (1, 0))  # label 0 is never bad
        # labels above max_cells share the last entry, as in the reference
        keep = ~torch.gather(bad, 1, ids.clamp_max(max_cells)) & (ids > 0)
        lab_c = _renumber(keep, lab_c)

    if clear_border_labels:
        idx_safe = torch.where(valid, idx, 0)
        yy, xx = idx_safe // w, idx_safe % w
        on_border = valid & ((yy == 0) | (yy == h - 1) | (xx == 0) | (xx == w - 1))
        touched = torch.zeros((b, sink_cap + 1), dtype=torch.bool, device=idx.device)
        touched.scatter_(1, torch.where(on_border, lab_c.long(), 0), True)
        inner = ~touched
        inner[:, 0] = False
        lab_c = torch.where(torch.gather(inner, 1, lab_c.long()), lab_c, 0)

    if flow_threshold > 0 or clear_border_labels:
        labels = _scatter_labels(idx, valid, lab_c, h, w)
    return labels, lab_c, sink_overflow


class CompactMasks(NamedTuple):
    """Result of `compute_masks_sparse_compact`, each with a leading batch
    axis.

    Attributes:
        labels: (B, H, W) int32 label image.
        lab_c: (B, cap) int32 final label of each listed pixel (0 = none).
        idx: (B, cap) int64 flat index of each listed pixel, ascending, H * W
            on padding slots.
        valid: (B, cap) bool, False on padding slots.
        ok: (B,) bool, False on an active-pixel or sink capacity overflow.
    """

    labels: torch.Tensor
    lab_c: torch.Tensor
    idx: torch.Tensor
    valid: torch.Tensor
    ok: torch.Tensor


def compute_masks_sparse_compact(
    network_output: torch.Tensor,
    cap: int,
    cellprob_threshold: float = 0.0,
    flow_threshold: float = 0.4,
    niter: int = 200,
    max_cells: int = 1024,
    min_size: int = 15,
    clear_border_labels: bool = False,
) -> CompactMasks:
    """Mask reconstruction in the compact domain from (B, H, W, 3) network
    output, with the listed pixels exposed for compact measurement
    (`ops.regionprops.measure_compacted`). Where `ok` is False the labels
    are incomplete and the caller must escalate its capacities."""
    flows = network_output[..., :2] * 0.2  # the JAX package's `/ 5.0`, see flows_cuda
    active = network_output[..., 2] > cellprob_threshold
    _, h, w = active.shape
    idx, valid, landing_c, ok = _follow_sparse_core(flows, active, niter, cap)
    labels, lab_c, sink_overflow = _finish_masks_compact(
        idx, valid, landing_c, flows, h, w, flow_threshold, max_cells, min_size,
        clear_border_labels=clear_border_labels,
    )
    return CompactMasks(labels, lab_c, idx, valid, ok & ~sink_overflow)


def compute_masks_sparse_compact_s2d(
    out_s2d: torch.Tensor,
    cap: int,
    cellprob_threshold: float = 0.0,
    flow_threshold: float = 0.4,
    niter: int = 200,
    max_cells: int = 1024,
    min_size: int = 15,
    clear_border_labels: bool = False,
) -> CompactMasks:
    """`compute_masks_sparse_compact` on the head output on the S2D grid,
    (B, H/2, W/2, 12) in (c, a) order from `UNetS2D(...)(x, out_s2d=True)`:
    the same CompactMasks as the planar route fed the planar tensor this one
    permutes, but for the segment budget behind `ok`. Above 2^20 pixels the
    reference compacts the S2D grid in segments of 8 consecutive (i, j, a)
    elements (2 x 4 pixel blocks), and only when W/2 is even, so near the
    budget a well can be `ok` on one route and not on the other."""
    b, h2, w2, ch = out_s2d.shape
    if ch != 12:
        raise ValueError(f"expected 12 S2D channels, got {ch}")
    network_output = _d2s(out_s2d, 3)
    flows = network_output[..., :2] * 0.2  # the JAX package's `/ 5.0`, see flows_cuda
    active = network_output[..., 2] > cellprob_threshold
    idx, valid, landing_c, _ = _follow_sparse_core(flows, active, niter, cap)
    act = (out_s2d[..., 8:12] > cellprob_threshold).reshape(b, -1)  # in (i, j, a) order
    ok = act.sum(1) <= cap
    if w2 % 2 == 0:
        ok &= _segments_fit(act, cap)
    labels, lab_c, sink_overflow = _finish_masks_compact(
        idx, valid, landing_c, flows, 2 * h2, 2 * w2, flow_threshold, max_cells, min_size,
        clear_border_labels=clear_border_labels,
    )
    return CompactMasks(labels, lab_c, idx, valid, ok & ~sink_overflow)


def compute_masks_sparse(
    network_output: torch.Tensor,
    cap: int,
    cellprob_threshold: float = 0.0,
    flow_threshold: float = 0.4,
    niter: int = 200,
    max_cells: int = 1024,
    min_size: int = 15,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`compute_masks` through the compact domain, whatever the count:
    ((B, H, W) int32 labels, (B,) bool ok); where ok is False the labels
    are incomplete."""
    out = compute_masks_sparse_compact(
        network_output, cap, cellprob_threshold=cellprob_threshold,
        flow_threshold=flow_threshold, niter=niter, max_cells=max_cells, min_size=min_size,
    )
    return out.labels, out.ok


def compute_masks(
    network_output: torch.Tensor,
    cellprob_threshold: float = 0.0,
    flow_threshold: float = 0.4,
    niter: int = 200,
    max_cells: int = 1024,
    min_size: int = 15,
    sparse_cap: int | None = None,
) -> torch.Tensor:
    """Full mask reconstruction from (B, H, W, 3) network output (dY, dX
    scaled by 5, cell-probability logits): threshold, integrate the flows,
    cluster sinks, QC by flow error, relabel. `flow_threshold <= 0`
    disables the QC. With `sparse_cap`, images whose active pixels fit
    the cap integrate their flows in the compact domain (the same landings;
    one read of the counts to the host decides). Returns (B, H, W) int32
    labels."""
    # the JAX package's `/ 5.0`, as XLA compiles it (see flows_cuda)
    flows = network_output[..., :2] * 0.2
    active = network_output[..., 2] > cellprob_threshold
    if sparse_cap is None:
        landing = follow_flows_indices(flows, active, niter=niter)
    else:
        fits = (active.flatten(1).sum(1) <= sparse_cap).tolist()  # the one read to the host
        landing = torch.empty(active.shape, dtype=torch.int64, device=active.device)
        for sparse in (True, False):
            sel = [k for k, f in enumerate(fits) if f == sparse]
            if sel:
                landing[sel] = (
                    follow_flows_indices_sparse(flows[sel], active[sel], niter, sparse_cap)[0]
                    if sparse else follow_flows_indices(flows[sel], active[sel], niter)
                )
    return _finish_masks(landing, active, flows, flow_threshold, max_cells, min_size)
