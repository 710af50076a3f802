"""Seeded Cellpose-SAM weights for the benchmark: one state dict in the
published layout, made from the run's inputs, which the entry writes to the
run's work directory for the program and the reference remakes alike.

No trained `cpsam` checkpoint is in the repository, so the weights are
drawn, on the run's device, from a seed that hashes the pool's first well
(the same inputs give the same weights, on either side and in
`control.py`). The recipe (configuration `assumed` states it too) keeps every
tensor nonzero and every part of the network in play:

- each matrix N(0, 1 / fan_in), but the q and k rows of each qkv matrix
  1.5 times that: logits of spread ~2.25, attention peaked as a trained
  ViT's is. With the spread of ~1 that N(0, 1 / fan_in) gives, every query
  averages nearly every token, the maps are a seed's constant plus little
  (23-60% of pixels active by the seed) and the sink webs across the image
  sent the mask tail's CC fixpoint loop up to 1.8 s a call; with 3 times
  (logits of ~9) attention is nearly an argmax, and bfloat16 rounding flips
  its choices: the program's `map_gap` rose from ~0.12 to 1.07-1.69 against
  the float8 control's 3.5-3.7. Each bias N(0, 0.02^2); LayerNorm weights
  1 + N(0, 0.1^2);
- the relative-position tables N(0, 0.05^2), at their published rows (27,
  or 127 in blocks 5, 11, 17, 23): q . R then has a spread of ~0.6 against
  the logits' ~2.25;
- `pos_embed` smooth over the tile, 0.2 times a sum of 3 random planar
  waves of 0-2 cycles per tile per channel;
- the readout maps each 8 x 8 patch mostly alike (a shared row per map
  plus 0.25 of a row per pixel), then calibrated (`_calibrated`): each
  map's row scaled and its bias shifted so that the float32 reference's
  maps of the central tile of pool well 0 have flows of mean 0 and spread
  5 (as trained flows, unit vectors times 5) and a cell probability of
  spread 2 with 20% of its pixels above 0. Uncalibrated, the maps were a
  seed's constant plus a spread of ~1: flows that drift every pixel the
  same way (means of -5 to 4 by the seed), onto the image's edge, and 9-79%
  of pixels active, where sink webs across the image made the mask tail's
  CC fixpoint loop cost 0.7-1.8 s more in some calls, by the seed;
- `W2` the identity pixel shuffle, both diameters 30.
Stored in bfloat16, the configuration's precision (the reference reads the
same values in float32).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

QK_SPREAD = 1.5  # the q and k rows of each qkv matrix, times N(0, 1 / fan_in)
# the maps the calibrated readout gives one tile of pool well 0: the flows
# centred with this spread, the cell probability with this spread and this
# share of its pixels above 0
FLOW_SPREAD = 5.0
CELLPROB_SPREAD = 2.0
ACTIVE_SHARE = 0.2


def weights_seed(pool: np.ndarray) -> int:
    """The weights' seed: the first 8 bytes of the SHA-256 of pool well 0."""
    return int.from_bytes(hashlib.sha256(np.ascontiguousarray(pool[0]).tobytes()).digest()[:8],
                          "little") >> 1


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """The published state dict's tensors and shapes for the sizes of `cfg`."""
    g, w, d = cfg["tile"] // cfg["patch"], cfg["width"], cfg["width"] // cfg["heads"]
    out = {"encoder.pos_embed": (1, g, g, w),
           "encoder.patch_embed.proj.weight": (w, 3, cfg["patch"], cfg["patch"]),
           "encoder.patch_embed.proj.bias": (w,)}
    for i in range(cfg["depth"]):
        p = f"encoder.blocks.{i}."
        rows = cfg["rel_pos_rows"]["global" if i in cfg["global_blocks"] else "windowed"]
        out.update({p + "norm1.weight": (w,), p + "norm1.bias": (w,),
                    p + "attn.rel_pos_h": (rows, d), p + "attn.rel_pos_w": (rows, d),
                    p + "attn.qkv.weight": (3 * w, w), p + "attn.qkv.bias": (3 * w,),
                    p + "attn.proj.weight": (w, w), p + "attn.proj.bias": (w,),
                    p + "norm2.weight": (w,), p + "norm2.bias": (w,),
                    p + "mlp.lin1.weight": (cfg["mlp"], w), p + "mlp.lin1.bias": (cfg["mlp"],),
                    p + "mlp.lin2.weight": (w, cfg["mlp"]), p + "mlp.lin2.bias": (w,)})
    n, o = cfg["neck"], cfg["out_maps"] * cfg["patch"] ** 2
    out.update({"encoder.neck.0.weight": (n, w, 1, 1), "encoder.neck.1.weight": (n,),
                "encoder.neck.1.bias": (n,), "encoder.neck.2.weight": (n, n, 3, 3),
                "encoder.neck.3.weight": (n,), "encoder.neck.3.bias": (n,),
                "out.weight": (o, n, 1, 1), "out.bias": (o,),
                "W2": (o, cfg["out_maps"], cfg["patch"], cfg["patch"]),
                "diam_labels": (1,), "diam_mean": (1,)})
    return out


def seeded_state(cfg: dict, pool: np.ndarray, device) -> dict[str, torch.Tensor]:
    """The recipe above, bfloat16 on `device`."""
    g_ = torch.Generator(device=device)
    g_.manual_seed(weights_seed(pool))

    def randn(*shape):
        return torch.randn(shape, generator=g_, device=device, dtype=torch.float32)

    grid, patch, maps = cfg["tile"] // cfg["patch"], cfg["patch"], cfg["out_maps"]
    state = {}
    for name, shape in shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if name == "W2":
            t = torch.eye(maps * patch**2, device=device).reshape(shape)
        elif name.startswith("diam"):
            t = torch.full(shape, 30.0, device=device)
        elif name == "encoder.pos_embed":
            yy, xx = torch.meshgrid(torch.arange(grid, device=device),
                                    torch.arange(grid, device=device), indexing="ij")
            t = torch.zeros(shape[1:], device=device)
            for _ in range(3):
                f = torch.randint(0, 3, (2, shape[-1]), generator=g_, device=device).float()
                phase = torch.rand(shape[-1], generator=g_, device=device) * 2 * math.pi
                t += torch.sin(2 * math.pi * (f[0] * yy[..., None] + f[1] * xx[..., None]) / grid
                               + phase)
            t = (0.2 * t)[None]
        elif name == "out.weight":
            n = shape[1]
            shared = randn(maps, 1, n).expand(maps, patch**2, n)
            t = ((shared + 0.25 * randn(maps, patch**2, n)) * n**-0.5).reshape(shape)
        elif name.endswith("attn.qkv.weight"):
            t = randn(*shape) * shape[1] ** -0.5
            t[: 2 * shape[1]] *= QK_SPREAD
        elif leaf.startswith("rel_pos"):
            t = 0.05 * randn(*shape)
        elif ".norm" in name or name.startswith(("encoder.neck.1", "encoder.neck.3")):
            t = 1.0 + 0.1 * randn(*shape) if leaf == "weight" else 0.02 * randn(*shape)
        elif leaf == "weight":
            t = randn(*shape) * math.prod(shape[1:]) ** -0.5
        else:
            t = 0.02 * randn(*shape)
        state[name] = t.to(torch.bfloat16)
    return _calibrated(state, cfg, pool, device)


def _quantised(v: float, steps: int = 64) -> float:
    """v on a grid of 1 / steps, so that float noise between two
    computations of the same calibration does not move a stored weight."""
    return round(v * steps) / steps


def _calibrated(state: dict, cfg: dict, pool: np.ndarray, device) -> dict:
    """The readout scaled and shifted per map so that the float32
    reference's maps of the central tile of pool well 0 have flows of mean
    0 and spread FLOW_SPREAD, and a cell probability of spread
    CELLPROB_SPREAD with ACTIVE_SHARE of its pixels above 0."""
    from benchmark.references import classical, cpsam, unet

    planes = torch.from_numpy(pool[0, cfg["segment"]["channels"]].astype(np.int32)).to(device)
    img = torch.stack([unet.stretch(p, classical._Arith("reference")) for p in planes]).float()
    b = cfg["tile"]
    y0, x0 = (img.shape[1] - b) // 2, (img.shape[2] - b) // 2
    with unet.no_tf32(), torch.no_grad():
        out = cpsam.Forward(state, cfg, "reference")(img[None, :, y0 : y0 + b, x0 : x0 + b])[0]
    maps = cfg["out_maps"]
    weight = state["out.weight"].float().view(maps, -1, state["out.weight"].shape[1])
    bias = state["out.bias"].float().view(maps, -1)
    for c in range(maps):
        m = out[c].flatten().double()
        if c < maps - 1:  # a flow: centred
            spread, centre = FLOW_SPREAD, float(m.mean())
        else:  # the cell probability: its (1 - ACTIVE_SHARE) quantile at 0
            spread = CELLPROB_SPREAD
            centre = float(torch.quantile(m, 1.0 - ACTIVE_SHARE))
        scale = 2 ** _quantised(float(torch.log2(spread / m.std())))
        weight[c] *= scale
        bias[c] = (bias[c] - _quantised(centre)) * scale
    state["out.weight"] = weight.reshape(state["out.weight"].shape).to(torch.bfloat16)
    state["out.bias"] = bias.reshape(-1).to(torch.bfloat16)
    return state
