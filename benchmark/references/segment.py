"""Plain reference of `batch_segment`: the U-Net reference's stretch,
forward and dense mask reconstruction of one float image (see
`references/unet.py`), with the segment call's own settings.

The masks are compared as tables of cells (area and centroid from each
label image, computed alike for both sides by the classical reference's
measurement): `mask_gap` and `centroid_gap` as `tables` defines them. The
per-cell values beside them are the benchmark's own arithmetic on both
sides, not the program's, so they are not compared.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import tables
from benchmark.references import classical, unet


def _table(lab: torch.Tensor, image: torch.Tensor, min_size: int) -> dict:
    ar = classical._Arith("reference")
    return classical.cell_table(lab.to(torch.int64), image[None], {"min_size": min_size}, ar)


# each stage stepped down alone (see `unet`; the segment call has no
# measurement of its own); CONTROLS, those the comparison has to fail
LOWERED = {"forward": {"forward": "control"}, "stretch": {"stretch": "control"}}
CONTROLS = ["forward"]


def _masks(pool: np.ndarray, config: dict, device, stages: dict):
    """(label image, image) of each pool well's segmented channel."""
    cfg = config["segment"]
    with unet.no_tf32():
        net = unet.forward_of(config, device, stages)
        ar = classical._Arith(stages.get("stretch", "reference"))
        for well in pool:
            img = torch.from_numpy(well[cfg["channel"]].astype(np.int32)).to(device)
            with torch.no_grad():
                yield unet.masks(net(unet.stretch(img, ar)), cfg), img


def reference_outputs(pool: np.ndarray, config: dict, device, stages: dict | None = None):
    """One table per pool well's segmented channel."""
    return [_table(lab, img, config["segment"]["min_size"])
            for lab, img in _masks(pool, config, device, stages or {})]


def control_outputs(pool: np.ndarray, config: dict, device, name: str):
    """The masks of control `name`, in the program's place: (pool index, mask)."""
    return [(k, lab.cpu().numpy()) for k, (lab, _) in
            enumerate(_masks(pool, config, device, LOWERED[name]))]


def compare(outputs, refs, pool: np.ndarray, config: dict, device) -> dict[str, float]:
    """The program's masks as tables, against the reference's."""
    cfg = config["segment"]
    progs = []
    for k, mask in outputs:
        if mask is None:
            progs.append((k, None))
            continue
        img = torch.from_numpy(pool[k, cfg["channel"]].astype(np.int32)).to(device)
        lab = torch.from_numpy(np.asarray(mask)).to(device)
        progs.append((k, _table(lab, img, cfg["min_size"])))
    gaps = tables.plate_gaps(progs, refs)
    return {"mask_gap": gaps["mask_gap"], "centroid_gap": gaps["centroid_gap"]}
