"""PyTorch port: both paths on the five real ND2 fixtures must meet the
same gates as the JAX package's pinned golden masks
(tests/test_golden_masks.py): the classical path foreground IoU >= 0.999
and the same cell count; the U-Net path (the trained weights, bfloat16)
>= 0.8 of the pinned cells matched and a matched instance IoU >= 0.85.

The fixtures are decoded through the port's own ND2 reader, with the
channel, plane, scaling and diameter conventions of
tools/pin_golden_masks.py.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu_torch import (
    MicroscopyImage,
    SegmentationModel,
    fused_classical_mask,
    label,
)
from arcadia_microscopy_tools_tpu_torch.models.weights import DEFAULT_WEIGHTS
from test_golden_masks import _greedy_instance_iou

# the suite runs in several worker processes at once; one torch thread per
# process keeps them from oversubscribing the host's cores
torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
FIXTURES = [
    "example-multichannel",
    "example-timelapse",
    "example-zstack",
    "example-pbmc",
    "example-cerevisiae",
]


# tools/pin_golden_masks.py:42
FIXTURE_DIAMETERS = {"example-zstack": 70.0}


def _frame(nd2_path: Path) -> np.ndarray:
    image = MicroscopyImage.from_nd2_path(nd2_path)
    frame = np.asarray(image.get_channel_intensities(image.channels[0]))
    while frame.ndim > 2:
        frame = frame[frame.shape[0] // 2]  # middle frame/plane
    return frame


def _frame_u16(nd2_path: Path) -> np.ndarray:
    frame = _frame(nd2_path)
    img01 = frame.astype(np.float64) / max(float(frame.max()), 1.0)
    return (np.clip(img01, 0, 1) * 65535).astype(np.uint16)


@pytest.fixture(scope="module")
def unet_model():
    return SegmentationModel(checkpoint_path=DEFAULT_WEIGHTS, device="cpu")


@pytest.mark.parametrize("name", FIXTURES)
def test_classical_golden_gates(name):
    golden = np.load(DATA / "golden_masks" / f"{name}.npz")["classical"]
    u16 = _frame_u16(DATA / f"{name}.nd2")
    mask = fused_classical_mask(torch.from_numpy(u16), low_sigma=1.0, high_sigma=16.0)
    classical = label(mask, checked=False).numpy()
    sizes = np.bincount(classical.ravel())
    classical[np.isin(classical, np.nonzero(sizes < 15)[0])] = 0

    fg_iou = np.logical_and(golden > 0, classical > 0).sum() / max(
        np.logical_or(golden > 0, classical > 0).sum(), 1
    )
    assert fg_iou >= 0.999, f"{name}: classical fg-IoU {fg_iou:.4f}"
    assert int(classical.max()) == int(golden.max()), f"{name}: cell count"


@pytest.mark.parametrize("name", FIXTURES)
def test_unet_golden_gates(name, unet_model):
    golden = np.load(DATA / "golden_masks" / f"{name}.npz")["unet"]
    frame = _frame(DATA / f"{name}.nd2")
    unet = unet_model.segment(frame.astype(np.float64), cell_diameter_px=FIXTURE_DIAMETERS.get(name))
    miou, frac = _greedy_instance_iou(golden, unet)
    assert frac >= 0.8, f"{name}: {frac:.2f} of the pinned cells matched ({golden.max()} vs {unet.max()})"
    assert miou >= 0.85, f"{name}: matched IoU {miou:.3f}"
