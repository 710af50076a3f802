"""Flow-field mask reconstruction, batched over images.

Counterpart of the dense path of `arcadia_microscopy_tools_tpu/models/flows.py`
(the Cellpose recipe): pixels whose cell probability exceeds the threshold
are advected along the predicted flow; pixels that land in the same sink
form one cell; masks whose flows, recomputed from the mask itself, disagree
with the network's (per-mask mean squared error above `flow_threshold`) are
dropped; labels are renumbered 1..N.

Every function takes a leading batch axis B and computes each image as the
JAX function computes it alone. Flat pixel indices are int64 (the JAX
package's float32 indices are exact only up to 2^24 pixels). Per-label
reductions are float64 `index_add_` and lookups plain indexing
(ops/segment_reduce.py). The flow-error QC's diffusion runs the CUDA kernel
of `flows_cuda.diffuse` on the card; the connected-components labeling of
the sinks runs the CC kernels of ops/cc_cuda.py.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.labeling import label, relabel_sequential, relabel_sequential_filtered
from ..ops.segment_reduce import segment_min, segment_sums, table_lookup
from .flows_cuda import diffuse, same_label_masks

__all__ = [
    "compute_masks",
    "flow_error",
    "follow_flows_indices",
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


def follow_flows_indices(flows: torch.Tensor, active: torch.Tensor, niter: int = 200) -> torch.Tensor:
    """Flat landing index of each active pixel after >= `niter` steps of
    the rounded dynamics p <- round(p + F[p]), by pointer doubling with an
    early exit, capped at ceil(log2 niter) compositions.

    flows: (B, H, W, 2) [dY, dX]; active: (B, H, W) bool. Returns (B, H, W)
    int64; inactive pixels map to themselves.
    """
    b, h, w = active.shape
    yy, xx = _grid(h, w, active.device)
    ny = torch.round(yy + flows[..., 0].float()).long().clamp(0, h - 1)
    nx = torch.round(xx + flows[..., 1].float()).long().clamp(0, w - 1)
    own = torch.arange(h * w, device=active.device).reshape(h, w)
    nxt = torch.where(active, ny * w + nx, own).reshape(b, h * w)
    steps = max(1, math.ceil(math.log2(max(niter, 2))))
    for _ in range(steps):
        new = torch.gather(nxt, 1, nxt)
        changed = bool((new != nxt).any())
        nxt = new
        if not changed:
            break
    return nxt.reshape(b, h, w)


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
    sums = segment_sums(torch.stack([torch.ones_like(yf), yf, xf], 1), seg, nseg, fg).float()
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


def compute_masks(
    network_output: torch.Tensor,
    cellprob_threshold: float = 0.0,
    flow_threshold: float = 0.4,
    niter: int = 200,
    max_cells: int = 1024,
    min_size: int = 15,
) -> torch.Tensor:
    """Full mask reconstruction from (B, H, W, 3) network output (dY, dX
    scaled by 5, cell-probability logits): threshold, integrate the flows,
    cluster sinks, QC by flow error, relabel. `flow_threshold <= 0`
    disables the QC. Returns (B, H, W) int32 labels."""
    # the JAX package's `/ 5.0`, as XLA compiles it (see flows_cuda)
    flows = network_output[..., :2] * 0.2
    active = network_output[..., 2] > cellprob_threshold
    landing = follow_flows_indices(flows, active, niter=niter)
    return _finish_masks(landing, active, flows, flow_threshold, max_cells, min_size)
