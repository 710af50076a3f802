"""Plain reference of the U-Net plate: per-cell tables of uint16 wells.

The semantics the plate states (the Cellpose recipe with the repository's
trained U-Net, as the port documents it), written out straight in PyTorch,
one well at a time, with no kernel, no compact list and no batching:

1. the segmentation channel stretched to [0, 1] between its 1st and 99th
   percentiles (numpy's linear percentile) and clipped;
2. the U-Net forward on that image repeated over 3 channels: residual
   double-conv blocks (3x3 conv, GroupNorm of 8 groups, ReLU, 3x3 conv,
   GroupNorm, + a 1x1 projection of the block input, ReLU), 2x2 max-pool
   between the 4 encoder levels, a style vector (the L2-normalised mean of
   the deepest features through a dense layer and ReLU) added after each
   decoder block, nearest 2x upsampling concatenated with the skip, and a
   1x1 head to (dY, dX, cell probability);
3. the pixels of positive cell probability follow p <- round(p + flow / 5)
   for 256 steps (200 rounded up to a power of two); landing pixels with 3
   or more arrivals are sinks; sinks within one pixel's dilation of each
   other form one cluster; each pixel takes the cluster at its landing
   pixel or, where that is no sink, the largest label around it; masks of
   fewer than `min_size` pixels are dropped;
4. the flow-error check: heat diffused 128 times within each mask from the
   pixel nearest its centroid, the unit gradient of log(1 + heat) by
   central differences inside the mask, and every mask whose mean squared
   gap to the predicted flow / 5 exceeds `flow_threshold` dropped;
5. the classical reference's per-cell table of what is left.

The reference runs the forward in float32 (TF32 off) and the rest in
float64. A control steps one stage one precision below what the
configuration states and leaves the others as the reference computes them.
`LOWERED` names the three: `forward`, the forward's activations and
weights stored in float8 (e4m3) with float32 accumulation, below the
bfloat16 forward; `stretch`, the stretch stored in bfloat16 with float32
accumulation, below float32; `measure`, each per-cell value but the area
and the centroid stored in bfloat16 (see `classical`). The mask
reconstruction stays at the reference's precision in all. `CONTROLS` are
those the comparison has to fail. The stretch is not among them: the bfloat16 forward rounds its input
to bfloat16 anyway, so a bfloat16 stretch reads as the program does.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import manifest, tables
from benchmark.references import classical

# storage and accumulation dtypes of the forward, per precision
FORWARD = {"reference": (torch.float32, torch.float32),
           "control": (torch.float8_e4m3fn, torch.float32)}
# each stage stepped down alone: the stages computed at "control" precision,
# the rest at "reference"; CONTROLS, those the comparison has to fail
LOWERED = {"forward": {"forward": "control"}, "stretch": {"stretch": "control"},
           "measure": {"measure": "control"}}
CONTROLS = ["forward", "measure"]


def load_weights(path) -> dict[str, torch.Tensor]:
    """The checkpoint's arrays (the JAX tree's dotted names and layouts)."""
    with np.load(manifest.REPO / path) as z:
        return {k: torch.from_numpy(z[k].astype(np.float32)) for k in z.files}


class Forward:
    """The U-Net forward on one (H, W) image, NCHW internally."""

    def __init__(self, weights: dict[str, torch.Tensor], device, precision: str, groups: int):
        self.store, self.acc = FORWARD[precision]
        self.groups = groups
        self.w = {k: v.to(device) for k, v in weights.items()}

    def q(self, t):
        return t.to(self.store).to(self.acc)

    def conv3(self, x, name):
        k = self.w[name].permute(3, 2, 0, 1)  # HWIO -> (Co, C, 3, 3)
        return F.conv2d(self.q(x), self.q(k), padding=1)

    def conv1(self, x, name):
        k = self.w[name][0, 0].t()[:, :, None, None]  # (1, 1, C, Co) -> (Co, C, 1, 1)
        return F.conv2d(self.q(x), self.q(k))

    def gn(self, x, prefix):
        b, c, h, w = x.shape
        g = x.reshape(b, self.groups, -1)
        mean = g.mean(-1, keepdim=True)
        var = ((g - mean) ** 2).mean(-1, keepdim=True)
        y = ((g - mean) / torch.sqrt(var + 1e-5)).reshape(b, c, h, w)
        return y * self.w[prefix + "_scale"][None, :, None, None] + self.w[prefix + "_bias"][
            None, :, None, None]

    def block(self, x, p):
        h = torch.relu(self.gn(self.conv3(x, p + "conv1"), p + "gn1"))
        h = self.gn(self.conv3(h, p + "conv2"), p + "gn2")
        return torch.relu(h + self.conv1(x, p + "proj"))

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        """(H, W) image -> (H, W, 3) float32 (dY, dX, cell probability)."""
        h = img.to(torch.float32)[None, None].expand(1, 3, *img.shape)
        skips = []
        n_down = sum(1 for k in self.w if k.startswith("down.") and k.endswith(".conv1"))
        for i in range(n_down):
            h = self.block(h, f"down.{i}.")
            skips.append(h)
            if i < n_down - 1:
                h = F.max_pool2d(h, 2)
        style = h.mean((2, 3))
        style = style / (torch.linalg.vector_norm(style, dim=-1, keepdim=True) + 1e-6)
        style = torch.relu(self.q(style) @ self.q(self.w["style_dense"]))
        for i in range(n_down - 1):
            up = F.interpolate(h, scale_factor=2, mode="nearest")
            h = self.block(torch.cat([up, skips[n_down - 2 - i]], 1), f"up.{i}.")
            h = h + (self.q(style) @ self.q(self.w[f"style_proj.{i}"]))[:, :, None, None]
        out = self.conv1(h, "head") + self.w["head_bias"][None, :, None, None]
        return out[0].permute(1, 2, 0)


def stretch(seg: torch.Tensor, ar: classical._Arith) -> torch.Tensor:
    s = torch.sort(seg.flatten().to(ar.acc)).values
    p1, p99 = classical._percentile(s, 1.0, ar), classical._percentile(s, 99.0, ar)
    x = ar.q((seg.to(ar.acc) - p1) / ar.q((p99 - p1).clamp_min(1e-6)))
    return x.clamp(0.0, 1.0)


def _nbr_max(x: torch.Tensor) -> torch.Tensor:
    """Maximum over each pixel's 3 x 3 neighbourhood, zero outside."""
    return F.max_pool2d(x[None, None].double(), 3, 1, 1)[0, 0].clamp_min(0).to(x.dtype)


def masks(out: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(H, W) int64 labels of one (H, W, 3) network output."""
    h, w = out.shape[:2]
    n = h * w
    out = out.double()
    flows = out[..., :2] * 0.2
    active = out[..., 2] > cfg["cellprob_threshold"]
    yy, xx = torch.meshgrid(torch.arange(h, device=out.device), torch.arange(w, device=out.device),
                            indexing="ij")
    ny = torch.round(yy + flows[..., 0]).long().clamp(0, h - 1)
    nx = torch.round(xx + flows[..., 1]).long().clamp(0, w - 1)
    land = torch.where(active, ny * w + nx, yy * w + xx).flatten()
    for _ in range(math.ceil(math.log2(max(cfg["niter"], 2)))):  # 2^k >= niter steps
        land = land[land]
    act = active.flatten()
    arrivals = torch.bincount(land[act], minlength=n)
    sink = (arrivals >= 3).view(h, w)
    sink_lab = torch.where(sink, classical.components(_nbr_max(sink.long()) > 0), 0)
    composite = torch.where(sink_lab > 0, sink_lab, _nbr_max(sink_lab)).flatten()
    lab = torch.where(act, composite[land], 0)
    sizes = torch.bincount(lab, minlength=int(lab.max()) + 1)
    lab = torch.where(sizes[lab] >= cfg["min_size"], lab, 0)
    lab = _sequential(lab)
    if cfg["flow_threshold"] > 0:
        err = _flow_error(lab.view(h, w), flows)
        bad = torch.cat([torch.zeros(1, dtype=torch.bool, device=err.device),
                         err[1:] > cfg["flow_threshold"]])
        lab = _sequential(torch.where(bad[lab], 0, lab))
    return lab.view(h, w)


def _sequential(lab: torch.Tensor) -> torch.Tensor:
    keep = torch.unique(lab)
    keep = keep[keep > 0]
    out = torch.zeros_like(lab)
    fg = lab > 0
    out[fg] = torch.searchsorted(keep, lab[fg]) + 1
    return out


def _flow_error(lab: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """Per label (0 first) mean squared gap between `flows` and the unit
    flows that diffusion from the label's centre implies."""
    h, w = lab.shape
    n_lab = int(lab.max()) + 1
    fg = lab > 0
    ids = lab.flatten()
    yy, xx = torch.meshgrid(torch.arange(h, device=lab.device, dtype=torch.float64),
                            torch.arange(w, device=lab.device, dtype=torch.float64), indexing="ij")
    area = torch.bincount(ids, minlength=n_lab).double().clamp_min(1)
    cy = torch.zeros(n_lab, dtype=torch.float64, device=lab.device).index_add_(0, ids, yy.flatten()) / area
    cx = torch.zeros(n_lab, dtype=torch.float64, device=lab.device).index_add_(0, ids, xx.flatten()) / area
    d2 = torch.where(fg, (yy - cy[lab]) ** 2 + (xx - cx[lab]) ** 2, math.inf).flatten()
    dmin = torch.full((n_lab,), math.inf, dtype=torch.float64, device=lab.device).scatter_reduce(
        0, ids, d2, "amin")
    idx = torch.arange(h * w, device=lab.device)
    cand = torch.where(fg.flatten() & (d2 == dmin[ids]), idx, h * w)
    centre = torch.full((n_lab,), h * w, dtype=torch.int64, device=lab.device).scatter_reduce(
        0, ids, cand, "amin")
    src = (fg.flatten() & (idx == centre[ids])).double().view(h, w)

    pl = F.pad(lab, (1, 1, 1, 1), value=-1)
    offs = ((-1, 0), (1, 0), (0, -1), (0, 1))
    same = [pl[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] == lab for dy, dx in offs]

    def nb(t, k):
        dy, dx = offs[k]
        return F.pad(t, (1, 1, 1, 1))[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    heat = src
    for _ in range(128):
        acc = heat + sum(torch.where(same[k], nb(heat, k), 0.0) for k in range(4))
        heat = torch.where(fg, acc * 0.2 + src, 0.0)
    t = torch.log1p(heat)
    up, down, left, right = (torch.where(same[k], nb(t, k), t) for k in range(4))
    gy, gx = (down - up) / 2, (right - left) / 2
    norm = torch.sqrt(gy * gy + gx * gx)
    ok = fg & (norm > 1e-6)
    gy = torch.where(ok, gy / norm.clamp_min(1e-6), 0.0)
    gx = torch.where(ok, gx / norm.clamp_min(1e-6), 0.0)
    se = ((flows[..., 0] - gy) ** 2 + (flows[..., 1] - gx) ** 2).flatten()
    total = torch.zeros(n_lab, dtype=torch.float64, device=lab.device).index_add_(0, ids, se)
    return total / area


def well_table(well: np.ndarray, config: dict, device, net: Forward, stages: dict) -> dict:
    cfg = config["plate"]
    chans = torch.from_numpy(well.astype(np.int32)).to(device)
    x = stretch(chans[cfg["seg_channel_index"]], classical._Arith(stages.get("stretch", "reference")))
    with torch.no_grad():
        out = net(x)
    table = classical.cell_table(masks(out, cfg), chans, {"min_size": cfg["min_size"]},
                                 classical._Arith("reference"))
    return classical.stored_bf16(table) if stages.get("measure") == "control" else table


def forward_of(config: dict, device, stages: dict) -> Forward:
    return Forward(load_weights(config["weights"]), device, stages.get("forward", "reference"),
                   config["groups"])


@contextlib.contextmanager
def no_tf32():
    """TF32 off for the block, as the float32 reference needs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def reference_outputs(pool: np.ndarray, config: dict, device, stages: dict | None = None):
    """One table per pool well; `stages` maps a stage to its precision,
    "reference" where it is left out."""
    stages = stages or {}
    with no_tf32():
        net = forward_of(config, device, stages)
        return [well_table(w, config, device, net, stages) for w in pool]


def control_outputs(pool: np.ndarray, config: dict, device, name: str):
    """The tables of control `name`, in the program's place: (pool index, table)."""
    return list(enumerate(reference_outputs(pool, config, device, LOWERED[name])))


def compare(outputs, refs, pool: np.ndarray, config: dict, device) -> dict[str, float]:
    """`mask_gap`, `centroid_gap` and `value_gap`, as `tables` defines them."""
    return tables.plate_gaps(outputs, refs)
