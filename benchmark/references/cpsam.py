"""Plain reference of `batch_segment` with Cellpose-SAM: the maps of each
pool image, and the masks of given maps.

The semantics the cell states (the port's `network="cpsam"`, as
models/vit_sam.py and models/sam_tiles.py document it), written out
straight in PyTorch with no kernel and nothing of the program:

1. each of the image's three planes stretched to [0, 1] between its 1st and
   99th percentiles and clipped (the U-Net reference's `stretch`);
2. Cellpose's tiles: per axis n = ceil(1.2 L / 256) at
   np.linspace(0, L - 256, n).astype(int) (100 at 2048 x 2048);
3. per tile, SAM's ViT-L encoder as Cellpose-SAM runs it: Conv2d patch
   embedding (8 x 8, stride 8), + pos_embed, 24 blocks of
   x + proj(attn(LN(x))) and x + lin2(GELU(lin1(LN(x)))), global attention
   with logits (q * scale) k^T + the materialised decomposed
   relative-position bias (`get_rel_pos`'s linear resize of each stored
   table to 63 rows; q . Rh[iy - jy + 31] + q . Rw[ix - jx + 31]), softmax,
   the neck (Conv1x1, LayerNorm2d, Conv3x3, LayerNorm2d, eps 1e-6) and the
   readout (Conv1x1, `conv_transpose2d` with W2 at stride 8);
4. Cellpose's `average_tiles`: each tile weighted by `_taper_mask` (sigma
   7.5), the sum divided by the summed weights (float64);
5. masks of maps (`masks`): the U-Net reference's steps (flow following,
   sinks, size filter, flow-error QC) with the segment call's settings, the
   flows followed in float32 as the configuration states (p <- round(p +
   flow * 0.2) in float32, half to even), the QC in float64.

The reference runs 1-4 in float32 (TF32 off), several tiles of one image
at a time (each tile alone through the same operations; the grouping only
fits the work to the card), and 5 as stated there. The flows are followed
in float32, not float64 as the U-Net reference follows them: on seeded
maps the sinks are marginal (three arrivals), and a float64 landing that
falls on the other side of a half-pixel from the float32 one moves whole
cells (`mask_gap` 0-0.13 against the float64 reference on a program whose
masks a float32 reference reproduces). The weights are the
benchmark's seeded state dict (`sam_weights.py`), remade from the pool.
`LOWERED["forward"]`, the control, stores every operand of every product of
step 3 (weights, activations, q, k, v, the probabilities) in float8 e4m3
(saturated at +-448) with float32 accumulation, below the configuration's
bfloat16. `LOWERED["masks"]` rounds the reference's maps to bfloat16 (below
the float32 of the flow following) before step 5 and returns the
float32 maps beside those masks: a reading for the mask limits, not a
control the comparison has to fail. `LOWERED["shifted"]` and
`LOWERED["eroded"]` are planted faults of the mask tail, readings of the
upper ends of `centroid_gap` and `mask_gap` at the cell's size: the
reference's masks of its own maps moved down a row (`FAULTS`), or cut to
the pixels whose four neighbours share their label.

Compared (`compare`), over every image the window returned:
- `map_gap`: per image and map, the 99.9th percentile of |program -
  reference| over the reference map's standard deviation; the largest. A
  missing map reads inf.
- `mask_gap`, `centroid_gap`: the program's masks against the reference's
  masks (5) of the program's own maps, as tables of cells (`tables`), so
  the mask reconstruction is held to the reference whatever the maps.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import sam_weights, tables
from benchmark.references import classical, unet
from benchmark.references.segment import _table

FORWARD = {"reference": (torch.float32, torch.float32),
           "control": (torch.float8_e4m3fn, torch.float32)}
LOWERED = {"forward": {"forward": "control"}, "masks": {"masks": "control"},
           "shifted": {"fault": "shifted"}, "eroded": {"fault": "eroded"}}
CONTROLS = ["forward"]
MAP_QUANTILE = 0.999
TILE_GROUP = 10  # tiles of one image computed together
FP8_MAX = 448.0


class Forward:
    """SAM's encoder and Cellpose's readout on (T, 3, tile, tile) tiles."""

    def __init__(self, state: dict, cfg: dict, precision: str):
        self.store, self.acc = FORWARD[precision]
        self.cfg = cfg
        self.s = {k: v.float() for k, v in state.items()}
        self.grid = cfg["tile"] // cfg["patch"]
        self.rel = {}
        for i in range(cfg["depth"]):
            for axis in ("h", "w"):
                table = self.s[f"encoder.blocks.{i}.attn.rel_pos_{axis}"]
                self.rel[i, axis] = self._get_rel_pos(table)

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.store == torch.float8_e4m3fn:
            t = t.clamp(-FP8_MAX, FP8_MAX)
        return t.to(self.store).to(self.acc)

    def _get_rel_pos(self, rel_pos: torch.Tensor) -> torch.Tensor:
        size = 2 * self.grid - 1
        if rel_pos.shape[0] != size:
            rel_pos = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
                                    size=size, mode="linear").reshape(-1, size).permute(1, 0)
        idx = torch.arange(self.grid, device=rel_pos.device)
        return rel_pos[(idx[:, None] - idx[None, :]) + self.grid - 1]

    def linear(self, x, name, bias=True):
        w = self.q(self.s[name + ".weight"])
        return F.linear(self.q(x), w, self.s[name + ".bias"] if bias else None)

    def attention(self, x: torch.Tensor, i: int) -> torch.Tensor:
        b, h, w, _ = x.shape
        heads = self.cfg["heads"]
        p = f"encoder.blocks.{i}.attn"
        qkv = self.linear(x, p + ".qkv").reshape(b, h * w, 3, heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * heads, h * w, -1).unbind(0)
        scale = q.shape[-1] ** -0.5
        attn = self.q(q * scale) @ self.q(k).transpose(-2, -1)
        r_q = self.q(q).reshape(b * heads, h, w, -1)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, self.q(self.rel[i, "h"]))
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, self.q(self.rel[i, "w"]))
        attn = (attn.view(b * heads, h, w, h, w) + rel_h[:, :, :, :, None]
                + rel_w[:, :, :, None, :]).view(b * heads, h * w, h * w)
        attn = attn.softmax(dim=-1)
        o = (self.q(attn) @ self.q(v)).view(b, heads, h, w, -1).permute(0, 2, 3, 1, 4)
        return self.linear(o.reshape(b, h, w, -1), p + ".proj")

    def _ln2d(self, x, name):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.cfg["ln_eps"])
        return self.s[name + ".weight"][:, None, None] * x + self.s[name + ".bias"][:, None, None]

    def __call__(self, tiles: torch.Tensor) -> torch.Tensor:
        cfg, s, eps = self.cfg, self.s, self.cfg["ln_eps"]
        x = F.conv2d(self.q(tiles), self.q(s["encoder.patch_embed.proj.weight"]),
                     s["encoder.patch_embed.proj.bias"], stride=cfg["patch"])
        x = x.permute(0, 2, 3, 1) + s["encoder.pos_embed"]
        width = cfg["width"]
        for i in range(cfg["depth"]):
            p = f"encoder.blocks.{i}."
            h = F.layer_norm(x, (width,), s[p + "norm1.weight"], s[p + "norm1.bias"], eps)
            x = x + self.attention(h, i)
            h = F.layer_norm(x, (width,), s[p + "norm2.weight"], s[p + "norm2.bias"], eps)
            h = F.gelu(self.linear(h, p + "mlp.lin1"))
            x = x + self.linear(h, p + "mlp.lin2")
        x = F.conv2d(self.q(x.permute(0, 3, 1, 2)), self.q(s["encoder.neck.0.weight"]))
        x = self._ln2d(x, "encoder.neck.1")
        x = F.conv2d(self.q(x), self.q(s["encoder.neck.2.weight"]), padding=1)
        x = self._ln2d(x, "encoder.neck.3")
        x1 = F.conv2d(self.q(x), self.q(s["out.weight"]), s["out.bias"])
        return F.conv_transpose2d(x1, s["W2"], stride=cfg["patch"])


def _starts(length: int, cfg: dict) -> np.ndarray:
    b, overlap = cfg["tile"], min(0.5, max(0.05, cfg["tile_overlap"]))
    n = 1 if length <= b else int(np.ceil((1.0 + 2 * overlap) * length / b))
    return np.linspace(0, length - b, n).astype(int)


def _taper(cfg: dict, device) -> torch.Tensor:
    ly = lx = cfg["tile"]
    bsize = max(224, ly)
    xm = np.arange(bsize)
    xm = np.abs(xm - xm.mean())
    mask = 1 / (1 + np.exp((xm - (bsize / 2 - 20)) / cfg["taper_sigma"]))
    mask = mask * mask[:, np.newaxis]
    mask = mask[bsize // 2 - ly // 2 : bsize // 2 + ly // 2 + ly % 2,
                bsize // 2 - lx // 2 : bsize // 2 + lx // 2 + lx % 2]
    return torch.from_numpy(mask).to(device)


def image_maps(planes: torch.Tensor, net: Forward, cfg: dict) -> torch.Tensor:
    """(3, H, W) int32 planes, H and W >= tile -> (H, W, 3) float32 maps."""
    ar = classical._Arith("reference")
    img = torch.stack([unet.stretch(p, ar) for p in planes]).float()
    _, h, w = img.shape
    b = cfg["tile"]
    mask = _taper(cfg, img.device)
    yf = torch.zeros((3, h, w), dtype=torch.float64, device=img.device)
    navg = torch.zeros((h, w), dtype=torch.float64, device=img.device)
    corners = [(int(y0), int(x0)) for y0 in _starts(h, cfg) for x0 in _starts(w, cfg)]
    with torch.no_grad():
        for g in range(0, len(corners), TILE_GROUP):
            group = corners[g : g + TILE_GROUP]
            tiles = torch.stack([img[:, y0 : y0 + b, x0 : x0 + b] for y0, x0 in group])
            out = net(tiles).double()
            for (y0, x0), o in zip(group, out):
                yf[:, y0 : y0 + b, x0 : x0 + b] += o * mask
                navg[y0 : y0 + b, x0 : x0 + b] += mask
    return (yf / navg).float().permute(1, 2, 0).contiguous()


def _planes(pool: np.ndarray, k: int, config: dict, device) -> torch.Tensor:
    chans = config["segment"]["channels"]
    return torch.from_numpy(pool[k, chans].astype(np.int32)).to(device)


def _maps(pool: np.ndarray, config: dict, device, precision: str):
    with unet.no_tf32():
        net = Forward(sam_weights.seeded_state(config, pool, device), config, precision)
        for k in range(len(pool)):
            yield image_maps(_planes(pool, k, config, device), net, config)


def masks(out: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(H, W) int64 labels of one (H, W, 3) map: `unet.masks` with the flows
    followed in float32."""
    h, w = out.shape[:2]
    n = h * w
    flows = out[..., :2].float() * 0.2
    active = out[..., 2].float() > cfg["cellprob_threshold"]
    yy, xx = torch.meshgrid(torch.arange(h, device=out.device, dtype=torch.float32),
                            torch.arange(w, device=out.device, dtype=torch.float32), indexing="ij")
    ny = torch.round(yy + flows[..., 0]).long().clamp(0, h - 1)
    nx = torch.round(xx + flows[..., 1]).long().clamp(0, w - 1)
    own = torch.arange(n, device=out.device).view(h, w)
    land = torch.where(active, ny * w + nx, own).flatten()
    for _ in range(math.ceil(math.log2(max(cfg["niter"], 2)))):  # 2^k >= niter steps
        land = land[land]
    act = active.flatten()
    arrivals = torch.bincount(land[act], minlength=n)
    sink = (arrivals >= 3).view(h, w)
    sink_lab = torch.where(sink, classical.components(unet._nbr_max(sink.long()) > 0), 0)
    composite = torch.where(sink_lab > 0, sink_lab, unet._nbr_max(sink_lab)).flatten()
    lab = torch.where(act, composite[land], 0)
    sizes = torch.bincount(lab, minlength=int(lab.max()) + 1)
    lab = torch.where(sizes[lab] >= cfg["min_size"], lab, 0)
    lab = unet._sequential(lab)
    if cfg["flow_threshold"] > 0:
        err = unet._flow_error(lab.view(h, w), flows.double())
        bad = torch.cat([torch.zeros(1, dtype=torch.bool, device=err.device),
                         err[1:] > cfg["flow_threshold"]])
        lab = unet._sequential(torch.where(bad[lab], 0, lab))
    return lab.view(h, w)


def reference_outputs(pool: np.ndarray, config: dict, device, stages: dict | None = None):
    """Each pool image's float32 (H, W, 3) maps, on `device`."""
    return list(_maps(pool, config, device, (stages or {}).get("forward", "reference")))


def _eroded(m: np.ndarray) -> np.ndarray:
    inner = np.ones(m.shape, bool)
    inner[1:] &= m[1:] == m[:-1]
    inner[:-1] &= m[:-1] == m[1:]
    inner[:, 1:] &= m[:, 1:] == m[:, :-1]
    inner[:, :-1] &= m[:, :-1] == m[:, 1:]
    return np.where(inner, m, 0)


# planted faults of a label image (the benchmark's CPU tests plant them in the
# program's masks too)
FAULTS = {"shifted": lambda m: np.roll(m, 1, axis=0), "eroded": _eroded}


def control_outputs(pool: np.ndarray, config: dict, device, name: str):
    """Control `name` in the program's place: (pool index, (mask, maps))."""
    stages = LOWERED[name]
    fault = FAULTS.get(stages.get("fault"), lambda m: m)
    out = []
    for k, m in enumerate(_maps(pool, config, device, stages.get("forward", "reference"))):
        seen = m.bfloat16().float() if stages.get("masks") == "control" else m
        lab = fault(masks(seen, config["segment"]).cpu().numpy())
        out.append((k, (lab, m.cpu().numpy())))
    return out


def _map_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    if prog.shape != ref.shape or not torch.isfinite(prog).all():
        return float("inf")
    gaps = []
    for c in range(ref.shape[-1]):
        d = (prog[..., c] - ref[..., c]).abs().flatten()
        kth = min(d.numel(), max(1, int(np.ceil(MAP_QUANTILE * d.numel()))))
        q = d.kthvalue(kth).values
        gaps.append(float(q / ref[..., c].std().clamp_min(1e-12)))
    return max(gaps)


def compare(outputs, refs, pool: np.ndarray, config: dict, device) -> dict[str, float]:
    """`map_gap` of the returned maps against the reference's maps;
    `mask_gap` and `centroid_gap` of the returned masks against the
    reference's masks of the same maps. An image that never came back
    (None) is the harness's to count."""
    cfg = config["segment"]
    map_gap, progs, ref_tables, seen = 0.0, [], [], {}
    for k, got in outputs:
        if got is None:
            continue
        mask, maps = got
        if maps is None:
            map_gap = float("inf")
            continue
        prog_maps = torch.from_numpy(np.ascontiguousarray(maps)).to(device)
        gap = _map_gap(prog_maps, refs[k].to(device))
        map_gap = max(map_gap, gap)
        if not np.isfinite(gap):
            continue
        img = torch.from_numpy(pool[k, cfg["channels"][0]].astype(np.int32)).to(device)
        key = (k, hashlib.sha1(np.ascontiguousarray(maps).tobytes()).hexdigest())
        if key not in seen:  # identical maps of one image give identical reference masks
            seen[key] = _table(masks(prog_maps, cfg), img, cfg["min_size"])
        progs.append((len(ref_tables), _table(torch.from_numpy(np.asarray(mask)).to(device), img,
                                              cfg["min_size"])))
        ref_tables.append(seen[key])
    gaps = tables.plate_gaps(progs, ref_tables)
    return {"map_gap": map_gap, "mask_gap": gaps["mask_gap"], "centroid_gap": gaps["centroid_gap"]}
