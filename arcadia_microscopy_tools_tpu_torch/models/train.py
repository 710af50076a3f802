"""Training loop for the segmentation U-Net on synthetic cells, in PyTorch.

Counterpart of `arcadia_microscopy_tools_tpu/models/train.py`: targets are
the diffusion flows of the ground-truth masks (`masks_to_flows`, whose
diffusion is the CUDA kernel of `flows_cuda.diffuse` on the card), the loss
is MSE on the flow field plus sigmoid-BCE on the cell probability, and the
optimiser is Adam with a cosine-decayed step size, as optax's
`adam(cosine_decay_schedule(lr, steps, alpha=0.05))` computes it. The
forward is `UNet.training_forward` (plain PyTorch under autograd; the JAX
training forward is XLA, with no Pallas kernel and so no backward kernel).

Two differences from the JAX trainer, by design: the initial weights come
from a seeded `torch.Generator`, not from `init_unet`'s JAX key, and `out`
is an `.npz` of the flattened JAX parameter tree (models/weights.py), not
an orbax checkpoint.

Usage:
    python -m arcadia_microscopy_tools_tpu_torch.models.train --steps 600 \
        --out unet.npz [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils import resolve_device
from .flows import masks_to_flows
from .synthetic import synthesize_cells
from .unet import UNet, UNetConfig
from .weights import save_weights

__all__ = [
    "MAX_CELLS_TRAIN",
    "TrainResult",
    "cosine_decay_schedule",
    "loss_fn",
    "make_batch",
    "make_optimizer",
    "train",
    "train_step",
]

MAX_CELLS_TRAIN = 64


def make_batch(rng: np.random.Generator, batch: int, size: int):
    """Host-side synthetic batch: images (B,H,W,3) float32 and labels
    (B,H,W) int32, drawn from `rng` exactly as the JAX package's
    `make_batch` draws them (the same numbers for the same generator state).

    Difficulty is sampled per image: separation down to 0.55 radius-sums
    (heavily touching clusters - the case flow segmentation exists for),
    illumination gradients up to 0.25, a range of noise levels, plus the
    domain axes real microscopy spans and pure geometry does not: small and
    faint cells (low SNR fluorescence), inverted polarity (brightfield /
    phase), PSF blur, camera shot noise, and nonzero background offsets.
    The inputs are per-image 1-99 percentile normalized, matching exactly
    what the segmentation wrapper feeds the net at inference time
    (models/segmentation.py), so training sees the deployment distribution.
    """
    images = np.zeros((batch, size, size, 3), np.float32)
    labels = np.zeros((batch, size, size), np.int32)
    for i in range(batch):
        r_lo = float(rng.uniform(3.0, 9.0))
        r_hi = r_lo * float(rng.uniform(1.3, 2.6))
        membrane = rng.random() < 0.2
        img, lbl = synthesize_cells(
            rng,
            (size, size),
            n_cells=int(rng.integers(8, 28)),
            radius_range=(r_lo, r_hi),
            # membrane-stained tissue is confluent: cells share walls, so
            # sample tighter packing for that modality
            separation=float(
                rng.uniform(0.45, 0.8) if membrane else rng.uniform(0.55, 1.0)
            ),
            gradient=float(rng.uniform(0.0, 0.25)),
            noise=float(rng.uniform(0.01, 0.09)),
            cell_contrast=float(rng.uniform(0.12, 1.0)),
            background_level=float(rng.uniform(0.0, 0.25)),
            invert=bool(rng.random() < 0.25),
            blur_sigma=float(rng.uniform(0.0, 1.6)),
            shot_noise=float(rng.uniform(0.0, 0.06)),
            # membrane-stain modality (confluent epithelium labeled at the
            # boundary, e.g. the example-zstack golden fixture): interiors
            # at background, only the rim bright
            membrane_only=float(rng.uniform(0.7, 1.0)) if membrane else 0.0,
            # half of all fields clip cells at the border, as real FOVs do
            edge_cells=bool(rng.random() < 0.5),
        )
        # the inference-time normalization (percentile 1-99 contrast stretch)
        p1, p99 = np.percentile(img, [1.0, 99.0])
        img = np.clip((img - p1) / max(p99 - p1, 1e-6), 0.0, 1.0).astype(np.float32)
        images[i] = img[..., None].repeat(3, axis=-1)
        labels[i] = lbl
    return images, labels


def _flow_targets(labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Flow targets (B,H,W,2) float32 and foreground (B,H,W) bool of a
    label batch on its device."""
    return masks_to_flows(labels, MAX_CELLS_TRAIN)


def loss_fn(net: UNet, images: torch.Tensor, flow_t: torch.Tensor, fg_t: torch.Tensor):
    """(total, (flow MSE, BCE)): MSE of the predicted flows against 5 x the
    unit target flows, plus 2 x the numerically stable sigmoid-BCE of the
    cell-probability logits against the foreground."""
    out = net.training_forward(images)
    pred_flows = out[..., :2]
    pred_prob = out[..., 2]
    flow_mse = ((pred_flows - 5.0 * flow_t) ** 2).sum(-1).mean()
    # torch.maximum splits the gradient of ties as jnp.maximum does
    bce = (
        torch.maximum(pred_prob, torch.zeros_like(pred_prob))
        - pred_prob * fg_t
        + torch.log1p(torch.exp(-pred_prob.abs()))
    ).mean()
    return flow_mse + 2.0 * bce, (flow_mse, bce)


def cosine_decay_schedule(
    init_value: float, decay_steps: int, alpha: float = 0.0
) -> Callable[[int], float]:
    """optax's `cosine_decay_schedule`: the step size at step `count`,
    init_value x ((1 - alpha) x (1 + cos(pi t / T)) / 2 + alpha) with t =
    min(count, T)."""
    if not decay_steps > 0:
        raise ValueError(
            f"The cosine_decay_schedule requires positive decay_steps, got {decay_steps=}."
        )

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay_steps)) + alpha)

    return schedule


def make_optimizer(net: UNet) -> torch.optim.Adam:
    """Adam with optax's defaults (betas 0.9 and 0.999, eps 1e-8 outside
    the square root); `train_step` sets the step size of each update."""
    return torch.optim.Adam(net.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8)


def train_step(
    net: UNet,
    optimizer: torch.optim.Optimizer,
    lr: float,
    images: torch.Tensor,
    flow_t: torch.Tensor,
    fg_t: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One update at step size `lr`: forward, backward, Adam. Returns the
    loss and its two parts (detached, on the net's device)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
    loss, (flow_mse, bce) = loss_fn(net, images, flow_t, fg_t)
    loss.backward()
    optimizer.step()
    return loss.detach(), flow_mse.detach(), bce.detach()


class TrainResult(NamedTuple):
    """The trained network and one record per step: the loss and its two
    parts (`loss`, `flow_mse`, `bce`)."""

    network: UNet
    history: list[dict[str, float]]


def train(
    steps: int = 600,
    batch: int = 8,
    size: int = 128,
    lr: float = 3e-4,
    seed: int = 0,
    out: str | Path | None = None,
    log_every: int = 25,
    device: str | torch.device | None = None,
) -> TrainResult:
    """Train the default `UNetConfig()` network for `steps` steps of `batch`
    synthetic `size`^2 images on `device` (None: the CUDA card, raising
    without one; "cpu" runs the plain versions of the kernels), and write
    its weights to `out` (an `.npz` that `load_weights` reads) if given."""
    dev = resolve_device(device)
    net = UNet(UNetConfig(), generator=torch.Generator().manual_seed(seed)).to(dev)
    schedule = cosine_decay_schedule(lr, steps, alpha=0.05)
    optimizer = make_optimizer(net)

    rng = np.random.default_rng(seed)
    parts: list[torch.Tensor] = []  # read back at log_every and at the end only
    t0 = time.time()
    for step in range(steps):
        images, labels = make_batch(rng, batch, size)
        flow_t, fg_t = _flow_targets(torch.from_numpy(labels).to(dev))
        parts.append(torch.stack(train_step(
            net, optimizer, schedule(step), torch.from_numpy(images).to(dev), flow_t,
            fg_t.float(),
        )))
        if step % log_every == 0 or step == steps - 1:
            loss, flow_mse, bce = parts[-1].tolist()
            print(
                f"step {step:5d} loss {loss:.4f} flow {flow_mse:.4f} bce {bce:.4f} "
                f"({time.time() - t0:.0f}s)",
                flush=True,
            )
    history = [
        dict(zip(("loss", "flow_mse", "bce"), row)) for row in torch.stack(parts).tolist()
    ]

    if out is not None:
        save_weights(out, net.state_dict())
        print(f"saved weights to {out}")
    return TrainResult(net, history)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Train the segmentation U-Net on synthetic cells.")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None, help="the .npz to write the weights to")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    train(args.steps, args.batch, args.size, args.lr, args.seed, args.out, device=args.device)


if __name__ == "__main__":
    main()
