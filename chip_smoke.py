"""On-card smoke run of the PyTorch port: the classical and U-Net plate
paths (staged, and from ND2 and Leica LIF files), the deep segmentation
path, the preprocessing `Pipeline` (also on a LIF timelapse), the per-cell
analysis and overlays of a well, the U-Net trainer, the plate on a mesh
of two ranks, and the space-to-depth (S2D) U-Net route beside the planar
one.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its lines:

1. device - the card's name and `nvidia-smi` name / power limit;
2. build - the nine CUDA kernels of `csrc/` (eight libraries), compiled with
   nvcc for sm_90a, one nvcc per source, all started together, with their
   ptxas reports; beside them the host library of `native/amt_host.cpp`
   (g++; the ND2 planarize);
3. kernels against plain - each kernel against its plain PyTorch version on
   the card: both CC kernels bit-exact on 8 x 2048^2 masks, a serpentine
   that hits the sweep cap, a ragged 1000 x 1500 mask, all-background /
   all-foreground masks and tiles without foreground beside tiles with it;
   the fused 3x3 conv on each of the 16 (C, Co, level, prologue, ReLU,
   accum, moments) combinations of a 8 x 2048^2 forward plus a ragged
   1000 x 1504 and a 3-row image, within one bf16 step, and at the
   tiling's edges (W not a multiple of the 64-pixel tile, H = 1, B = 1 with
   C = Co = 256, 256 -> 128), each with and without prologue and accum; two
   launches on the same inputs give the same bits of y and the moments; the
   conv on row slabs: each of the 16 shapes split at half its rows as two
   calls with one halo row each, y and moment partials concatenated equal to
   the whole-image call bit for bit, and a halo slab against the plain
   version within one bf16 step; the forward's calls outside the kernels
   (the stem's F.conv2d, the 1x1 projections, the head) give a slab's rows
   the whole image's bits; the GroupNorm moments at 8 x 2048^2 x 32 and on
   ragged shapes, within 1e-5, and their slabs' partials bit for bit; the
   conv and the moments also on the S2D forward's shapes the planar one
   does not give them (128 and 256 channels at 1024^2 and 512^2, the two
   stems' outputs);
   the rank selection bit-exact (int32 views) on the 8 x 2048^2 timelapse
   stack at window 21, windows 11, 15 and 22 (two ranks in one launch), a
   window of 255 that reads its keys from device memory, a ragged batch of
   3, signed zeros, rank 0 and window^2 - 1, all five pad modes, all-equal
   windows, +-inf and both NaN signs, windows 1 and 3, and the windows on
   each side of every branch switch of the kernel (35/36, 74/75, 225/226);
4. plate path - 8 synthetic 2048^2 4-channel wells through
   `PlateRunner.run` with its kernel launch counts, and well 0 held against
   the plain path on the CPU;
5. segmentation path - 8 synthetic 2048^2 images through
   `SegmentationModel.batch_segment` with the trained weights and its
   launch counts of all six kernels; the chunk's input, stretched on the
   card, equal to `_prepare_image`'s stacked (np.array_equal) and the
   stretch kernel bit-exact against its plain version on it, on its uint16
   and float32 casts and on a ragged chunk (2 and 3 channels, NaN, +-inf,
   signed zeros, a constant plane, planes off a 16-byte boundary); the QC
   diffusion bit-exact against
   its plain version on that run's label images (128, 13 and 1 iterations),
   a ragged crop, and cases that drive its dense branch as well as its cell
   pass (a whole-image label, a label split between far corners, labels
   above the box table, 1-pixel labels, touching labels on the image edges,
   boxes on both sides of the cell pass's capacity), with both branches
   launched; one 512^2 image on the card against the CPU
   plain path;
6. preprocessing path - two `Pipeline(..., parallel=True)` configurations
   on 8 2048^2 uint16 frames from host memory: Gaussian -> 3x3 median ->
   rolling ball on noise tiles, and a 21x21 median local threshold ->
   binary opening -> label on a blob timelapse, which launches the rank
   kernel once per frame; launch counts; frame 0 of the first and a 640^2
   crop of frame 0 of the second held against the CPU path;
7. U-Net plate path - the same 8 wells through `PlateRunner.run` with
   method="unet" and the trained weights, with the launch counts of kernels
   4-6; well 0 stage by stage: the input stretch, then the card's network
   output through the compact mask tail on the card and on the CPU (labels,
   lab_c, idx, valid and ok bit for bit), then its table within the plate
   phase's tolerances; the compact tail against the dense `compute_masks`
   on the same outputs; one 512^2 float32 forward on the card against the
   CPU;
8. decode-inclusive - the 8 wells written as ND2 files
   (tests/nd2_builder.py), `PlateRunner.run` for both methods with an
   image source that calls the port's `load_nd2` (wells/s including
   decode, decode ms per well, the planarize that ran); the five real ND2
   fixtures decoded by the port's reader and segmented on the card against
   the pinned golden U-Net masks (matched >= 0.8, matched IoU >= 0.85);
9. per-cell analysis - well 0's channel 0 through the cell segmentation
   example's percentile rescale and Otsu threshold, then
   `SegmentationMask` with the four channels on the card: the default
   table, every supported column, the outlines and `filter`, with the CC
   kernels' launch counts, each held against the same calls on the CPU
   (label images bit for bit, integer and host columns equal, float
   columns within 1e-5); the fluorescence example's two overlays on the
   well against the CPU within 1e-6, and their out-of-range warnings on
   the card;
10. LIF plate - the 8 wells written as the 8 images of one LIF container
   (tests/lif_builder.py); `list_image_names` and well 0's pixels and
   inferred channels; `PlateRunner.run` for both methods with an image
   source that calls the port's `load_lif_image`, with their kernel launch
   counts, each table held against phases 4 and 7's from host arrays bit
   for bit (the measurement's sums are exact); decode-inclusive wells/s and
   decode ms per well beside phase 8's ND2 figures;
11. LIF timelapse - the timelapse stack as one (T, Y, X) LIF image through
   `MicroscopyImage.from_lif_path(...).device_intensities()` and phase 6's
   local-threshold `Pipeline`: sizes, inferred channel, 8 rank kernel
   launches, labels equal to phase 6's;
12. training - one `train_step` from the trained weights (`UNetConfig()`,
   bf16, batch 8 of 128^2) on the card and on the CPU: loss and its parts
   within 1e-2 relative, targets' fg equal and flows within 0.02, every
   gradient leaf at cosine similarity >= 0.99; then
   `train(steps=10, batch=8, size=128)` on the card: finite losses, one
   launch of kernel 6 per step and none of kernels 4-5, ms per step; then
   as many more steps timed with a synchronize after each phase, split
   into make_batch (host), targets and forward + backward + Adam; the
   written `.npz` reloads equal and `SegmentationModel` segments a 512^2
   image with it on the card;
13. timing - plate wells/s and per-stage ms; U-Net plate wells/s split into
   the stretch, the forward, the compact mask tail (of which the QC
   diffusion) and the measurement, beside the dense `compute_masks` on the
   same outputs; segmentation images/s split into host preparation,
   forward, mask reconstruction and, within it, the QC diffusion (with its
   foreground fraction and labels per branch); preprocessing images/s and
   ms per operation; each kernel's time beside its bound, its plain
   version's time and, for the conv, cuDNN's bf16 `F.conv2d` and, for the
   rank selection, `torch.kthvalue` over the unfolded windows, on the same
   shapes; the per-cell analysis of one well in ms per stage (label, device
   measurement, intensity stack, host columns, all columns, overlays); the
   LIF and training figures of phases 10-12 again;
14. mesh - `measure_compacted` (uint16 and float32 channels),
   `measure_labels` and `measure_intensity_stack` run twice on well 0 give
   the same bits; two spawned ranks sharing the card over gloo run the
   plate on a (wells=2) and a (space=2) mesh, the U-Net plate on (wells=2)
   and (space=2), and the staged classical plate (li threshold, opening 2)
   on (space=2), each as the sharded well program (packed columns and
   health equal to the single process's - phases 4 and 7, and the staged
   configuration's own run - bit for bit) and as `PlateRunner.run` (tables
   bit for bit), with each rank's launch counts (kernels 1-2 on both ranks
   under space=2, kernels 4-6 on both for the U-Net: 16 conv calls and one
   moments call per batch of slabs), then
   `run_plate_multiprocess` from phase 8's ND2 files (tables equal to phase
   8's); wells/s of the two-rank runs; a one-rank group with the default
   backend (NCCL for card tensors) runs `halo_exchange`,
   `sharded_histogram_uint16`, `sharded_otsu_threshold` and
   `make_sharded_otsu` against their single-device counterparts;
15. S2D U-Net (models/unet_s2d.py) - the 8 wells through the JAX plate's
   S2D composition: the stretch, `UNetS2D(s2d_params(tree,
   gray_input=True))(x[..., None], out_s2d=True)`, `flows.
   compute_masks_sparse_compact_s2d` and the measurement, with the trained
   weights: 13 conv, 2 moments and >= 1 diffusion launches; the planar
   head equal to the S2D head permuted and the S2D compact tail equal to
   the planar one on the permuted tensor, bit for bit; well 0's S2D
   forward against the CPU (the bf16 gate) and its labels against phase
   7's planar ones (>= 99% of pixels, cells +-1); ms per batch of the S2D
   and planar forwards, timed planar, S2D, S2D, planar, with each one's
   peak memory, and of the S2D route's compact tail, measurement and whole
   composition beside phase 13's planar parts; the 3-channel S2D forward
   beside the planar one on phase 5's batch; each of the 13 conv calls beside its bound and cuDNN's conv, and
   `lane_moments` at the two stem outputs;
16. Cellpose-SAM (models/vit_sam.py) - `batch_segment(network="cpsam")`
   on the 8 wells' first three channels with seeded weights, capturing the
   qkv of blocks 0, 11 and 23 of its first micro-batch and of block 23 of
   its last (32 tiles); kernel 8 (models/sam_attention.py,
   csrc/sam_attention.cu) against its plain version on those and on random
   q, k, v of 64 and 32 tiles at the published sizes (32 x 32 tokens, 16
   heads of 64), within SAM_ATTENTION_STEPS bfloat16 steps at the largest
   |o|; timed per micro-batch of 64 tiles beside its bound, the plain
   version and SDPA with a materialised bias (the library call, timed only
   here); then `batch_segment(network="cpsam", return_flows=True)` again:
   kernel 8's launches (24 per micro-batch), the call's time and its
   stages;
17. U-Net block tail (models/tail_cuda.py, csrc/unet_tail.cu) - kernel 9
   at each of the seven tails of one 8 x 2048^2 forward (the encoder's
   one residual, the decoder's split residual and style row) on random
   operands, bit for bit against its plain version, timed beside its bytes
   bound and the plain version, the PyTorch sequence the forward ran
   before it (the library yardstick); phases 5 and 7 check that the
   segmentation and U-Net plate paths launch it, phases 7 and 12 that the
   float32 forward and the trainer do not;
18. SAM's automatic mask generator, its attention and its mask head
   (models/sam_decoder.py, models/sam_amg.py, models/sam_attention.py,
   csrc/sam_attention.cu, models/sam_upscale_cuda.py, csrc/sam_upscale.cu)
   - `batch_segment(network="sam")` on the 8 wells' first three channels
   with seeded weights, once to build, then again with kernel 8's and
   kernel 10's launch counts zeroed just before it: per encoder
   micro-batch of images the global instance launches once per global
   block (4) and the window kernel once per windowed block (20), kernel 10
   once per prompt batch (16 an image, 128 for the 8 wells), and no
   image is lost; the call's time, stages and AMG counters; then kernel
   8's two forms that Segment Anything's encoder runs: the global instance over the 64 x 64
   grid (tables of 127 rows) on 1 and 2 images, and the window kernel on 1,
   7, 25 and 200 windows of 14 x 14 (196 tokens, the pad keys among them as
   any other), each at two spreads of q, k, v against its plain version
   within SAM_ATTENTION_STEPS bfloat16 steps, launches counted per form;
   each timed at one encoder micro-batch of 8 images (8 images of 4096
   tokens; 200 windows) beside its bound, the plain version and SDPA with a
   materialised bfloat16 bias; the grid-32 instance re-timed at 64 tiles;
   then kernel 10 against its plain version at 1, 7 and 64 prompts on
   grids 64 and 16 at two spreads (each mask within SAM_ATTENTION_STEPS
   bfloat16 steps of its largest |logit|; the share of bit-equal logits),
   timed at one prompt batch (64 prompts, grid 64) beside its bound and the
   plain version;
19. the `kernels` JSON line, then the card's name and power limit, then
   the final `{"ok": true, ...}` line.

Any failure exits non-zero before the final line. Without a CUDA device the
script exits non-zero at once. `--cpu-rehearsal` runs every phase at a
tiny size on the CPU with the plain versions (a check of the script's own
control flow); it prints no device result and exits non-zero.
`--compare-with FILE` reads the output of an earlier run (the parent
commit's `chip_smoke.py`, run in the same chip call) and prints each
kernel's earlier time beside this run's, and each conv call's (planar
and S2D).
`--profile DIR` adds a `torch.profiler` trace of one whole training step
and one update alone, one default per-cell table
of well 0, one forward and one mask reconstruction of the segmentation
batch, one batch of each preprocessing configuration, one U-Net plate
batch, its compact mask tail and the dense `compute_masks` on the same
outputs: device time by kernel and the card's idle share, printed and
written to DIR/profile_segment.txt.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
NON_TENSOR_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
BF16_TENSOR_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
CSRC = "arcadia_microscopy_tools_tpu_torch/csrc"
# the branches of csrc/rank_select.cu by the last window each serves; larger
# windows bisect on keys read from device memory
RANK_BRANCHES = ((35, "sliding, 4096-key sort"), (74, "sliding, 8192-key sort"),
                 (225, "bisection on staged keys"))
KERNEL_LIBRARIES = ["cc_local", "conv3x3_fused", "gn_moments", "diffuse", "rank_select",
                    "percentile_stretch", "sam_attention", "unet_tail", "sam_upscale"]
REPO = Path(__file__).resolve().parent
DATA = REPO / "tests" / "data"
ND2_CHANNELS = ["DAPI", "FITC", "TRITC", "CY5"]
# the pinned fixtures and their diameters (tools/pin_golden_masks.py:42)
GOLDEN_FIXTURES = ["example-multichannel", "example-timelapse", "example-zstack", "example-pbmc",
                   "example-cerevisiae"]
FIXTURE_DIAMETERS = {"example-zstack": 70.0}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_host(fn, reps: int, sync, warmup: int = 1) -> float:
    """Mean milliseconds per call by the host clock around a synchronize."""
    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / reps


def profile_windows(windows: dict, out_dir: str) -> None:
    """Trace each (name -> fn) window with torch.profiler; print device
    milliseconds by kernel, the window's wall time and the card's idle share
    (1 - summed kernel time / wall time; kernels of one stream do not
    overlap), and write the full tables to out_dir/profile_segment.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(e) -> float:
        return float(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0))

    lines = []
    for name, fn in windows.items():
        fn()  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side events only: operator rows repeat their kernels' time
        events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=device_us, reverse=True)
        busy_ms = sum(device_us(e) for e in events) / 1e3
        log(f"[profile] {name}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
            f"{1 - busy_ms / wall_ms:.3f}")
        for e in events[:12]:
            if device_us(e) > 0:
                log(f"[profile] {name}:   {device_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
        sort = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
                else "self_cuda_time_total")
        lines += [f"== {name}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms",
                  prof.key_averages().table(sort_by=sort, row_limit=60)]
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_segment.txt").write_text("\n".join(lines))


def port_modules() -> SimpleNamespace:
    """Every module of the port this script drives (imported here, so that a
    machine without a card fails at the device check before any of them)."""
    import arcadia_microscopy_tools_tpu_torch as pkg
    from arcadia_microscopy_tools_tpu_torch import _build, _native, masks, operations, testing
    from arcadia_microscopy_tools_tpu_torch.core import microplate, microscopy
    from arcadia_microscopy_tools_tpu_torch.io import leica, lif, nd2, nikon
    from arcadia_microscopy_tools_tpu_torch.models import (
        conv_cuda,
        flows,
        flows_cuda,
        gn_cuda,
        stretch_cuda,
        tail_cuda,
        train,
        unet,
        unet_s2d,
        weights,
    )
    from arcadia_microscopy_tools_tpu_torch.ops import cc_cuda, compaction, filters, fused
    from arcadia_microscopy_tools_tpu_torch.ops import labeling, morphology, rank_cuda
    from arcadia_microscopy_tools_tpu_torch.ops import regionprops, threshold
    from arcadia_microscopy_tools_tpu_torch.parallel import plate
    from arcadia_microscopy_tools_tpu_torch.utils import profiling
    from arcadia_microscopy_tools_tpu_torch.viz import blending

    return SimpleNamespace(**{m.__name__.rsplit(".", 1)[-1]: m for m in (
        _build, _native, masks, operations, testing, microplate, microscopy, leica, lif, nd2, nikon,
        conv_cuda, flows, flows_cuda, gn_cuda, stretch_cuda, tail_cuda, train, unet, unet_s2d,
        weights,
        cc_cuda, compaction, filters, fused, labeling, morphology, rank_cuda, regionprops,
        threshold, plate, profiling, blending,
    )}, pkg=pkg)


def reset_all_counts(m) -> None:
    for mod in (m.cc_cuda, m.conv_cuda, m.gn_cuda, m.flows_cuda, m.rank_cuda, m.stretch_cuda,
                m.tail_cuda):
        mod.reset_launch_counts()


def all_counts(m) -> dict[str, int]:
    out = {}
    for mod in (m.cc_cuda, m.conv_cuda, m.gn_cuda, m.flows_cuda, m.rank_cuda, m.stretch_cuda,
                m.tail_cuda):
        out.update(mod.launch_counts)
    return out


def median_local_mask(img: torch.Tensor) -> torch.Tensor:
    """The timelapse configuration's mask: pixels above their 21x21 median
    plus 150 (`threshold_local(method="median", offset=-150)`, the
    repository's timelapse benchmark recipe at the largest window the TPU
    kernel served)."""
    from arcadia_microscopy_tools_tpu_torch.ops.threshold import threshold_local

    return img.to(torch.float32) > threshold_local(img, 21, "median", -150.0)


def preprocessing_pipelines(m, dev) -> dict:
    """The two preprocessing configurations as `Pipeline`s on `dev`."""
    op, f = m.pkg.ImageOperation, m.filters
    return {
        "denoise": m.pkg.Pipeline([
            op(f.gaussian_filter, 2.0),
            op(f.median_filter, 3),
            op(f.subtract_background_rolling_ball, radius=25),
        ], parallel=True, device=dev),
        "local threshold": m.pkg.Pipeline([
            op(median_local_mask),
            op(m.morphology.binary_opening, m.morphology.disk(2)),
            op(m.labeling.label),
        ], parallel=True, device=dev),
    }


def rank_cases(m, stack: torch.Tensor, rehearsal: bool) -> list:
    """(name, images, window, ranks, mode, fn) cases of the rank kernel
    against its plain version: fn None calls `rank_select`, else a filter
    entry point on the card."""
    dev = stack.device
    g = torch.Generator(device=dev).manual_seed(300)
    small = (lambda *shape: shape) if not rehearsal else (lambda n, h, w: (n, h // 8, w // 8))
    noise = torch.randn(small(2, 512, 640), generator=g, device=dev) * 100
    zeros = torch.tensor([-0.0, 0.0, 1.0], device=dev)[
        torch.randint(0, 3, small(1, 96, 128), generator=g, device=dev)]
    ragged = torch.randn(small(3, 333, 517), generator=g, device=dev)
    wide = torch.randn(small(1, 300, 340), generator=g, device=dev)
    modes = stack[:1, :200, :260]
    f = m.filters
    cases = [
        ("timelapse stack", stack, 21, (220,), "reflect", None),
        ("window 11, negative values", noise, 11, (60,), "reflect", None),
        ("window 15, negative values", noise, 15, (112,), "reflect", None),
        ("window 22, two ranks", noise, 22, (241, 242), "reflect", None),
        ("window 255, keys from device memory", wide, 255, (32512,), "reflect", None),
        ("ragged batch of 3", ragged, 15, (112,), "reflect", None),
        ("signed zeros", zeros, 11, (60,), "reflect", None),
        ("signed zeros", zeros, 21, (220,), "reflect", None),
        ("rank_filter rank 0", noise[:1], 15, (0,), "reflect",
         lambda x: f.rank_filter(x, 0, 15)[None]),
        ("rank_filter rank 224", noise[:1], 15, (224,), "reflect",
         lambda x: f.rank_filter(x, 224, 15)[None]),
    ]
    cases += [(f"mode {mode}", modes, 21, (220,), mode, None) for mode in f.PAD_MODES]
    # the sliding branch's edges: ties, non-finite keys, the smallest windows,
    # and each window on both sides of a branch switch
    equal = torch.full(small(1, 120, 150), 3.5, device=dev)
    two = torch.randint(0, 2, small(2, 64, 80), generator=g, device=dev).float()
    special = torch.tensor([float("inf"), -float("inf"), 1.0, -1.0, 0.0], device=dev)
    special = torch.cat([special, torch.tensor([0x7FC00000, -0x400000], dtype=torch.int32,
                                                device=dev).view(torch.float32)])
    odd = special[torch.randint(0, len(special), small(1, 90, 110), generator=g, device=dev)]
    cases += [
        ("all-equal windows", equal, 21, (220,), "reflect", None),
        ("ties of two values", two, 22, (241, 242), "reflect", None),
        ("+-inf and both NaN signs", odd, 21, (0, 440), "reflect", None),
        ("+-inf and both NaN signs", odd, 11, (60,), "constant", None),
        ("window 1", noise, 1, (0,), "reflect", None),
        ("window 3", noise, 3, (4,), "reflect", None),
        ("window 3", noise[:1], 3, (4,), "nearest", None),
    ]
    for (last, _), shape in zip(RANK_BRANCHES, ((1, 70, 90), (1, 90, 100), (1, 40, 50))):
        for w in (last, last + 1):
            x = torch.randn(small(*shape), generator=g, device=dev)
            ks = (w * w // 2,) if w % 2 else (w * w // 2 - 1, w * w // 2)
            cases.append((f"branch edge, window {w}", x, w, ks, "reflect", None))
    return cases


def rank_branch(window: int) -> str:
    return next((name for last, name in RANK_BRANCHES if window <= last),
                "bisection on keys in device memory")


def forward_conv_shapes(b: int, size: int, nb=(32, 64, 128, 256)):
    """The 16 conv3x3_fused calls of one U-Net forward on (b, size, size):
    (name, C, Co, H, prologue+ReLU, accum, moments), in call order."""
    calls = []
    h = size
    for i, co in enumerate(nb):
        if i:  # down0.conv1 has a 3-channel input and is F.conv2d
            calls.append((f"down{i}.conv1", nb[i - 1], co, h, False, False, True))
        calls.append((f"down{i}.conv2", co, co, h, True, False, True))
        h //= 2
    for i, lv in enumerate(reversed(range(len(nb) - 1))):
        h = size >> lv
        c_up, co = nb[lv + 1], nb[lv]
        calls.append((f"up{i}.conv1_up", c_up, co, h, False, False, False))
        calls.append((f"up{i}.conv1_skip", co, co, h, False, True, True))
        calls.append((f"up{i}.conv2", co, co, h, True, False, True))
    return calls


def s2d_conv_shapes(b: int, size: int, nb=(32, 64, 128, 256)):
    """The 13 conv3x3_fused calls of one S2D forward (models/unet_s2d.py) on
    (b, size, size): (name, C, Co, H, prologue+ReLU, accum, moments), in
    call order. Levels 0-1 run at half their resolution with 4x the
    channels; the stems, up0's and up2's up parts are cuDNN convs."""
    h0, h1, h2 = size // 2, size // 4, size // 8
    c0, c1 = 4 * nb[0], 4 * nb[1]
    return [
        ("s2d.down0.conv2", c0, c0, h0, True, False, True),
        ("s2d.down1.conv2", c1, c1, h1, True, False, True),
        ("s2d.down2.conv1", nb[1], nb[2], h1, False, False, True),
        ("s2d.down2.conv2", nb[2], nb[2], h1, True, False, True),
        ("s2d.down3.conv1", nb[2], nb[3], h2, False, False, True),
        ("s2d.down3.conv2", nb[3], nb[3], h2, True, False, True),
        ("s2d.up0.conv1_skip", nb[2], nb[2], h1, False, True, True),
        ("s2d.up0.conv2", nb[2], nb[2], h1, True, False, True),
        ("s2d.up1.conv1_up", nb[2], c1, h1, False, False, False),
        ("s2d.up1.conv1_skip", c1, c1, h1, False, True, True),
        ("s2d.up1.conv2", c1, c1, h1, True, False, True),
        ("s2d.up2.conv1_skip", c0, c0, h0, False, True, True),
        ("s2d.up2.conv2", c0, c0, h0, True, False, True),
    ]


def time_conv_calls(m, calls, n: int, dev, timed, rehearsal: bool, say) -> tuple[dict, dict]:
    """Each conv3x3_fused call of `calls` ((name, C, Co, H, prologue+ReLU,
    accum, moments) on n images of H^2) timed at its shape, beside its
    bound (bytes: x, y and accum read or written once and the weights; or
    bf16 tensor-core operations), its plain version and cuDNN's bf16
    F.conv2d on the same shape, each printed; returns the totals and each
    call's ms by name."""
    tot = dict(ms=0.0, plain=0.0, lib=0.0, bytes=0.0, ops=0.0, bound=0.0)
    conv_ms = {}
    for k, (name, c, co, h, pro, acc, mom) in enumerate(calls):
        x, wt, kw = conv_operands(n, h, h, c, co, pro, acc, dev, seed=k)
        ms, plain_ms = timed(lambda: m.conv_cuda.conv3x3_fused(x, wt, emit_moments=mom, **kw),
                             lambda: m.conv_cuda.conv3x3_fused_plain(x, wt, emit_moments=mom, **kw),
                             kreps=10)
        if rehearsal:
            lib_ms = plain_ms
        else:
            xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor (channels_last)
            wc = wt.permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)
            lib_ms = time_cuda(lambda: torch.nn.functional.conv2d(xc, wc, padding=1), reps=10)
        px_l = n * h * h
        nbytes = 2 * px_l * (c + co + (co if acc else 0)) + 2 * 9 * c * co
        flop = 2 * 9 * c * co * px_l
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, flop / BF16_TENSOR_FLOP_PER_S * 1e3
        for key, v in (("ms", ms), ("plain", plain_ms), ("lib", lib_ms), ("bytes", b_ms),
                       ("ops", o_ms), ("bound", max(b_ms, o_ms))):
            tot[key] += v
        conv_ms[name] = ms
        say(f"[time] conv3x3_fused {name} {n}x{h}^2 {c}->{co}: {ms:.4f} ms "
            f"({flop / ms / 1e9:.1f} TFLOP/s); bound {max(b_ms, o_ms):.4f} ms, "
            f"{max(b_ms, o_ms) / ms:.1%} of it reached "
            f"({'bytes' if b_ms >= o_ms else 'operations'}); plain {plain_ms:.3f} ms; "
            f"F.conv2d bf16 conv only {lib_ms:.4f} ms")
        del x, wt, kw
    return tot, conv_ms


def conv_operands(b, h, w, c, co, pro, acc, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
    wt = (torch.randn((3, 3, co, c), generator=g, device=dev) * math.sqrt(2 / (9 * c))).to(
        torch.bfloat16
    )
    kw = {}
    if pro:
        kw["prologue"] = (
            torch.randn((b, c), generator=g, device=dev) * 0.5 + 1,
            torch.randn((b, c), generator=g, device=dev) * 0.1,
        )
        kw["relu"] = True
    if acc:
        kw["accum"] = torch.randn((b, h, w, co), generator=g, device=dev).to(torch.bfloat16)
    return x, wt, kw


def check_conv(m, x, wt, kw, moments: bool) -> float:
    """Kernel vs plain: outputs within one bf16 step (2^-7 of the value,
    plus 1e-4 of the largest magnitude for sums that cancel); moments within
    one bf16 step per value of the plain moments, and within 1e-5 of the
    plain float32 sums of the kernel's own output. Returns the max abs
    output error."""
    got = m.conv_cuda.conv3x3_fused(x, wt, emit_moments=moments, **kw)
    want = m.conv_cuda.conv3x3_fused_plain(x, wt, emit_moments=moments, **kw)
    (y, mo), (yw, mow) = (got, want) if moments else ((got, None), (want, None))
    yf, ywf = y.float(), yw.float()
    d = (yf - ywf).abs()
    if not bool((d <= ywf.abs() / 128 + 1e-4 * ywf.abs().max()).all()):
        raise RuntimeError(f"conv3x3_fused output beyond one bf16 step: max {float(d.max())}")
    if moments:
        a1, a2 = ywf.abs().sum((1, 2)), (ywf * ywf).sum((1, 2))
        if not bool(((mo[0] - mow[0]).abs() <= a1 / 128 + 1e-5 * a1).all()) or not bool(
            ((mo[1] - mow[1]).abs() <= a2 / 64 + 1e-5 * a2).all()
        ):
            raise RuntimeError("conv3x3_fused moments differ from the plain moments")
        own1, own2 = yf.sum((1, 2)), (yf * yf).sum((1, 2))
        s1, s2 = yf.abs().sum((1, 2)), own2
        if not bool(((mo[0] - own1).abs() <= 1e-5 * s1 + 1e-6).all()) or not bool(
            ((mo[1] - own2).abs() <= 1e-5 * s2 + 1e-6).all()
        ):
            raise RuntimeError("conv3x3_fused moments differ from the sums of its own output")
    return float(d.max()) if d.numel() else 0.0


def conv_slabs(m, x, wt, kw, moments: bool, split: int):
    """The conv of x's rows [0, split) and [split, H) as two row-slab calls,
    each with its one halo row of the other: (y, partials) concatenated
    along the rows and the tiles."""
    h = x.shape[1]
    ys, parts = [], []
    for lo, hi in ((0, split), (split, h)):
        top, bottom = int(lo > 0), int(hi < h)
        k = dict(kw)
        if "accum" in k:
            k["accum"] = k["accum"][:, lo:hi].contiguous()
        out = m.conv_cuda.conv3x3_fused(x[:, lo - top : hi + bottom].contiguous(), wt, top=top,
                                        bottom=bottom, emit_moments=moments, partials=moments, **k)
        ys.append(out[0] if moments else out)
        if moments:
            parts.append(out[1])
    return torch.cat(ys, 1), (torch.cat(parts, 1) if moments else None)


def slabs_equal_whole(m, x, wt, kw, moments: bool, split: int) -> bool:
    """Two slab calls, concatenated, against the whole-image call: y and the
    moment partials bit for bit."""
    whole = m.conv_cuda.conv3x3_fused(x, wt, emit_moments=moments, partials=moments, **kw)
    y, part = conv_slabs(m, x, wt, kw, moments, split)
    same = torch.equal((whole[0] if moments else whole).view(torch.int16), y.view(torch.int16))
    return same and (not moments or torch.equal(whole[1].view(torch.int32), part.view(torch.int32)))


def probe_library_slabs(m, n: int, size: int, dev) -> dict[str, bool]:
    """Whether the forward's calls outside the kernels give a row slab's
    rows the bits of the whole image's: the stem's float32 F.conv2d (with a
    halo row, cropped) and the 1x1 projections and the head as the forward
    runs them (`unet._project`: cuBLAS's bf16 @, or a float32 GEMM where K
    or N is 3), each split at half the rows of its level. Beside them, for
    the record, cuBLAS's bf16 @ at the two narrow shapes, which the forward
    does not run ("cuBLAS ..." entries)."""
    g = torch.Generator(device=dev).manual_seed(500)
    bf = torch.bfloat16
    out = {}
    x = torch.rand((n, size, size, 3), generator=g, device=dev).to(bf)
    w = (torch.randn((3, 3, 32, 3), generator=g, device=dev) * 0.3).to(bf)
    whole = m.conv_cuda.conv2d_f32(x, w)
    s = size // 2
    top_half = m.conv_cuda.conv2d_f32(x[:, : s + 1], w, 0, 1)
    bottom_half = m.conv_cuda.conv2d_f32(x[:, s - 1 :], w, 1, 0)
    out["stem F.conv2d float32"] = torch.equal(whole, torch.cat([top_half, bottom_half], 1))
    del x, whole, top_half, bottom_half
    for name, h, c, co in (("down0.proj", size, 3, 32), ("down1.proj", size // 2, 32, 64),
                           ("down2.proj", size // 4, 64, 128), ("down3.proj", size // 8, 128, 256),
                           ("up0.proj up", size // 8, 256, 128), ("up0.proj skip", size // 4, 128, 128),
                           ("up1.proj up", size // 4, 128, 64), ("up1.proj skip", size // 2, 64, 64),
                           ("up2.proj up", size // 2, 64, 32), ("up2.proj skip", size, 32, 32),
                           ("head", size, 32, 3)):
        a = torch.randn((n, h, h, c), generator=g, device=dev).to(bf)
        wt = (torch.randn((c, co), generator=g, device=dev) / math.sqrt(c)).to(bf)
        for label, fn in ((name, m.unet._project), (f"cuBLAS {name}", torch.matmul)):
            if label == name or min(c, co) < 32:
                out[label] = torch.equal(fn(a, wt), torch.cat([fn(a[:, : h // 2], wt),
                                                               fn(a[:, h // 2 :], wt)], 1))
        del a
    return out


def compare_with(path: str, kernels: list, conv_ms: dict, say) -> None:
    """Print each kernel's time in the earlier run's `kernels` line beside
    this run's, and each conv call's per-call time beside this run's."""
    lines = Path(path).read_text().splitlines()
    old = next((json.loads(x) for x in lines if x.startswith('{"kernels"')), None)
    if old is None:
        raise RuntimeError(f"no kernels line in {path}")
    old_ms = {k["name"]: k["ms"] for k in old["kernels"]}
    for k in kernels:
        if k["name"] in old_ms:
            say(f"[compare] {k['name']}: earlier run {old_ms[k['name']]:.4f} ms, this run "
                f"{k['ms']:.4f} ms ({old_ms[k['name']] / k['ms']:.2f}x)")
    pattern = re.compile(r"\[time\] conv3x3_fused (\S+) \S+ \S+: ([0-9.]+) ms")
    for x in lines:
        hit = pattern.match(x)
        if hit and hit.group(1) in conv_ms:
            ms = conv_ms[hit.group(1)]
            say(f"[compare] conv3x3_fused {hit.group(1)}: earlier run {float(hit.group(2)):.4f} "
                f"ms, this run {ms:.4f} ms")


def greedy_instance_iou(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """(mean matched IoU, matched fraction) of two label images under greedy
    best-IoU pairing (the golden gate of tests/test_golden_masks.py)."""
    ids_a = [i for i in np.unique(a) if i > 0]
    ids_b = [i for i in np.unique(b) if i > 0]
    if not ids_a or not ids_b:
        return (1.0, 1.0) if not ids_a and not ids_b else (0.0, 0.0)
    ious = np.zeros((len(ids_a), len(ids_b)))
    for i, ia in enumerate(ids_a):
        ma = a == ia
        for j, jb in enumerate(ids_b):
            mb = b == jb
            inter = np.logical_and(ma, mb).sum()
            if inter:
                ious[i, j] = inter / np.logical_or(ma, mb).sum()
    matched, used = [], set()
    for i in np.argsort(-ious.max(axis=1)):
        j = int(np.argmax(np.where([c not in used for c in range(len(ids_b))], ious[i], -1)))
        if ious[i, j] > 0.5 and j not in used:
            matched.append(ious[i, j])
            used.add(j)
    return (float(np.mean(matched)) if matched else 0.0, len(matched) / max(len(ids_a), len(ids_b)))


def orientation_differs(a: np.ndarray, b: np.ndarray, eccentricity: np.ndarray) -> bool:
    """Whether two orientation columns differ beyond 1e-4 as axis angles
    (+-pi/2 are one axis) on the cells where the angle is defined: near-round
    cells and exact moment ties (+-pi/4) depend on the last bit of the sums."""
    d = np.abs(a - b)
    d = np.minimum(d, np.pi - d)
    ties = (np.abs(np.abs(a) - np.pi / 4) < 1e-4) & (np.abs(np.abs(b) - np.pi / 4) < 1e-4)
    held = (eccentricity > 0.3) & ~ties
    return bool((d[held] > 1e-4).any())


def compare_measurements(props_d, int_d, props_c, int_c) -> float:
    """Per-cell columns measured on the card against the CPU's: integer
    columns equal, orientation modulo pi where the cell is elongated and
    its moments do not tie, intensity finiteness equal. Returns the worst
    relative difference of the float columns (1e-4 floor on the scale)."""
    worst = 0.0
    ecc = props_c["eccentricity"]
    for name, a in props_d.items():
        a, b = a.cpu(), props_c[name]
        if a.dtype in (torch.int32, torch.bool):
            if not torch.equal(a, b):
                raise RuntimeError(f"integer column {name} differs from the CPU")
        elif name == "orientation":
            if orientation_differs(a.numpy(), b.numpy(), ecc.numpy()):
                raise RuntimeError("orientation differs from the CPU")
        else:
            worst = max(worst, float(((a - b).abs() / (1e-4 + b.abs())).max()))
    for ci in int_d:
        for stat, a in int_d[ci].items():
            a, b = a.cpu(), int_c[ci][stat]
            fin = torch.isfinite(b)
            if not torch.equal(torch.isfinite(a), fin):
                raise RuntimeError(f"intensity {stat} finiteness differs from the CPU")
            rel = (a[fin] - b[fin]).abs() / (1e-4 + b[fin].abs())
            worst = max(worst, float(rel.max()))
    return worst


def compare_plate_tables(got, want, well_ids) -> tuple[bool, float, str]:
    """(bit for bit, worst float relative difference, its column) of two
    plate runs' tables, by `compare_measurements`' rules: raises unless every
    well has the same columns and cell count, equal integer columns and
    orientations that agree (`orientation_differs`); the other float
    columns' relative difference with a 1e-4 floor on the scale."""
    exact, worst, where = True, 0.0, ""
    for w in well_ids:
        a, b = got.tables[w], want.tables[w]
        if a is None or b is None or list(a.columns) != list(b.columns) or len(a) != len(b):
            raise RuntimeError(f"well {w}: tables of different shape or a failed well")
        for col in a.columns:
            x, y = a[col].to_numpy(), b[col].to_numpy()
            if not np.issubdtype(y.dtype, np.floating):
                if not np.array_equal(x, y):
                    raise RuntimeError(f"well {w}: integer column {col} differs")
                continue
            exact = exact and np.array_equal(x, y, equal_nan=True)
            if col == "orientation":
                if orientation_differs(x, y, b["eccentricity"].to_numpy()):
                    raise RuntimeError(f"well {w}: orientation differs")
                continue
            fin = np.isfinite(y)
            if not np.array_equal(np.isfinite(x), fin):
                raise RuntimeError(f"well {w}: finiteness of {col} differs")
            rel = np.abs(x[fin] - y[fin]) / (1e-4 + np.abs(y[fin]))
            if len(rel) and float(rel.max()) > worst:
                worst, where = float(rel.max()), f"{w} {col}"
    return exact, worst, where


# per-cell columns that the host computes from the label image (measure.py)
CELL_HOST_COLUMNS = ("area_convex", "solidity", "feret_diameter_max", "moments", "inertia_tensor")


def compare_cell_tables(card, cpu) -> float:
    """A `SegmentationMask` on the card against the same call on the CPU:
    label images equal bit for bit; integer columns, the host columns and
    intensity extrema equal; orientation modulo pi on elongated cells away
    from moment ties; other float columns rtol 1e-5 (morphology also atol
    1e-4). Returns the worst relative difference of the float columns
    (1e-4 floor on the scale)."""
    if not np.array_equal(card.label_image, cpu.label_image):
        raise RuntimeError("the card's label image differs from the CPU's")
    got, want = card.cell_properties, cpu.cell_properties
    if list(got) != list(want):
        raise RuntimeError("the card's table has other columns than the CPU's")
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        if w.dtype.kind in "iub":
            same = np.array_equal(g, w)
        elif name.startswith(CELL_HOST_COLUMNS + ("intensity_min", "intensity_max")):
            same = np.array_equal(g, w, equal_nan=True)
        elif name == "orientation":
            d = np.abs(g - w)
            d = np.minimum(d, np.pi - d)
            ties = (np.abs(np.abs(g) - np.pi / 4) < 1e-4) & (np.abs(np.abs(w) - np.pi / 4) < 1e-4)
            same = not (d[(want["eccentricity"] > 0.3) & ~ties] > 1e-4).any()
        else:
            atol = 0.0 if name.startswith("intensity_") else 1e-4
            same = np.allclose(g, w, rtol=1e-5, atol=atol)
            worst = max(worst, float((np.abs(g - w) / (1e-4 + np.abs(w))).max(initial=0.0)))
        if not same:
            raise RuntimeError(f"per-cell column {name} on the card differs from the CPU")
    return worst


def overlays(m, norm: list, channels: list, device) -> tuple:
    """The fluorescence example's two overlays of a well: channels 1-3
    added onto channel 0, and three layers of mixed opacity, anchor and
    blend mode."""
    blend = m.blending
    added = blend.overlay_channels(norm[0], dict(zip(channels[1:], norm[1:])),
                                   blend_mode=blend.BlendMode.ADDITIVE, device=device)
    layers = [
        blend.Layer(channels[1], norm[1], opacity=0.9),
        blend.Layer(channels[2], norm[2], opacity=0.7, blend_mode=blend.BlendMode.ADDITIVE),
        blend.Layer(channels[3], norm[3], opacity=0.5, zero_transparent=False),
    ]
    return added, blend.create_overlay(norm[0], layers, device=device)


def mesh_rank(rank: int, world: int, store: str, data: str, rehearsal: bool) -> None:
    """One rank of phase 14's two-rank runs, a spawned process; both ranks
    share the one card. Runs the plate on a (wells=2) and a (space=2) mesh,
    the U-Net plate on (wells=2) and (space=2), and the staged classical
    plate (li threshold, opening) on (space=2), each as the sharded well
    program on the staged batch and as `PlateRunner.run` from host arrays, then
    `run_plate_multiprocess` on phase 8's ND2 files, and writes what it saw
    to DATA/rank<rank>.pkl. Any failure exits non-zero."""
    import pickle

    import torch.distributed as dist

    torch.set_num_threads(2)
    m = port_modules()
    from arcadia_microscopy_tools_tpu_torch.parallel import mesh as pmesh
    from arcadia_microscopy_tools_tpu_torch.parallel import multiprocess

    dev = torch.device("cpu" if rehearsal else "cuda")
    sync = torch.cuda.synchronize if not rehearsal else (lambda: None)
    if not rehearsal:
        m._build.load_kernel_libraries(KERNEL_LIBRARIES)  # the parent's builds, reused
    # two ranks on one card: NCCL refuses that; gloo runs on card tensors too
    multiprocess.initialize_distributed(f"file://{store}", world, rank, backend="gloo")
    d = Path(data)
    spec = json.loads((d / "spec.json").read_text())
    wells = np.load(d / "wells.npy")
    staged = torch.from_numpy(wells).to(dev)
    n_ch, size = wells.shape[1], wells.shape[-1]
    layout = m.pkg.MicroplateLayout([m.microplate.Well(id=w) for w in spec["well_ids"]])
    source = {w: wells[k] for k, w in enumerate(spec["well_ids"])}
    configs = {k: m.plate.PlateRunConfig(**spec[k]) for k in ("classical", "unet", "staged")}
    weights = m.weights.load_weights()
    out = {}
    space2 = pmesh.MeshConfig(space_parallelism=2)
    for name, method, mesh_config in (("wells=2", "classical", pmesh.MeshConfig()),
                                      ("space=2", "classical", space2),
                                      ("unet wells=2", "unet", pmesh.MeshConfig()),
                                      ("unet space=2", "unet", space2),
                                      ("staged space=2", "staged", space2)):
        runner = m.plate.PlateRunner(configs[method], mesh_config, device=dev,
                                     unet_params=weights if method == "unet" else None)
        reset_all_counts(m)
        packed, health = runner._get_compiled(n_ch, (size, size))(staged)
        sync()
        program_launches = all_counts(m)
        runner.run(layout, source)  # warm
        dist.barrier()
        reset_all_counts(m)
        t0 = time.perf_counter()
        res = runner.run(layout, source)
        sync()
        out[name] = {"packed": packed.cpu().numpy(), "health": health.cpu().numpy(),
                     "program_launches": program_launches, "run_launches": all_counts(m),
                     "wall": time.perf_counter() - t0, "tables": res.tables,
                     "mesh": repr(runner.mesh)}
        if name == "unet space=2":
            out[name]["exchange_ms"] = unet_exchange_ms(m, runner, staged, sync)
        del runner, packed, health
    paths = spec["nd2"]
    multiprocess.run_plate_multiprocess(layout, lambda w: m.nikon.load_nd2(paths[w])[0],
                                        configs["classical"], device=dev)  # warm
    dist.barrier()
    reset_all_counts(m)
    t0 = time.perf_counter()
    res = multiprocess.run_plate_multiprocess(layout, lambda w: m.nikon.load_nd2(paths[w])[0],
                                              configs["classical"], device=dev)
    sync()
    out["run_plate_multiprocess"] = {"run_launches": all_counts(m), "tables": res.tables,
                                     "wall": time.perf_counter() - t0,
                                     "decode_wells": res.timings["decode_wells"]}
    dist.barrier()
    dist.destroy_process_group()
    with open(d / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def unet_exchange_ms(m, runner, staged: torch.Tensor, sync) -> dict[str, float]:
    """What the U-Net's row slabs trade on a (space=2) mesh, each timed alone
    (milliseconds per call, host clock around a synchronize, 5 calls): the
    well program on its slabs of the batch, one halo-row exchange and one
    moment-partials gather at full resolution (32 channels; a forward makes
    17 and 14 such exchanges, at every level), the gather of the style
    vector's block sums, and, for the record, an all-gather of the deepest
    features themselves (the other way to the style vector, not taken)."""
    from arcadia_microscopy_tools_tpu_torch.parallel import collectives
    from arcadia_microscopy_tools_tpu_torch.parallel.mesh import SPACE_AXIS

    b, n_ch, size = staged.shape[0], staged.shape[1], staged.shape[-1]
    group = runner.mesh.group(SPACE_AXIS)
    half = size // 2
    program = runner._get_compiled(n_ch, (size, size))
    act = torch.zeros((b, half, size, 32), dtype=torch.bfloat16, device=staged.device)
    tiles = m.conv_cuda.moment_tiles(half, size, 32)
    part = torch.zeros((b, tiles, 2, 32), device=staged.device)
    deep = torch.zeros((b, half // 8, size // 8, 256), dtype=torch.bfloat16, device=staged.device)
    blocks = half // 16
    style = torch.zeros((b, blocks, 256), device=staged.device)
    calls = {
        "program": lambda: program(staged),
        "halo rows (level 0, 32 channels)": lambda: collectives.halo_rows_nhwc(act, group),
        "moment partials (level 0)": lambda: collectives.all_gather_rows(part, [tiles] * 2, group),
        "style block sums": lambda: collectives.all_gather_rows(style, [blocks] * 2, group),
        "deepest features, not taken": lambda: collectives.all_gather_rows(
            deep, [half // 8] * 2, group),
    }
    return {k: time_host(fn, 5, sync) for k, fn in calls.items()}


def spawn_ranks(world: int, data: Path, rehearsal: bool, timeout: float) -> list[dict]:
    """Run `mesh_rank` on `world` spawned processes and return what each
    wrote; raises if any exits non-zero or outlives `timeout` seconds (every
    process is stopped before this returns)."""
    import pickle

    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=mesh_rank, args=(r, world, str(data / "store"), str(data), rehearsal))
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    try:
        while any(proc.is_alive() for proc in procs):
            if time.monotonic() > deadline:
                raise RuntimeError(f"the {world} ranks did not finish within {timeout:.0f} s")
            if any(proc.exitcode not in (None, 0) for proc in procs):
                break
            time.sleep(0.2)
        codes = [proc.exitcode for proc in procs]
        if any(code != 0 for code in codes if code is not None) or None in codes:
            raise RuntimeError(f"a rank failed: exit codes {codes}")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join(10)
    out = []
    for r in range(world):
        with open(data / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def tree_equal(a, b) -> bool:
    """Bit-for-bit equality of nested dicts / tuples of tensors."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(tree_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def bf16_steps(err: float, ref: torch.Tensor) -> float:
    """`err` in bfloat16 steps (the spacing of bfloat16 values) at the
    largest |ref|."""
    return err / 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)


# kernel 8 against its plain version: at most this many bfloat16 steps at the
# largest |o| (the output's own rounding is half a step; P enters P V in
# bfloat16, ~2^-9 of each weight)
SAM_ATTENTION_STEPS = 2.0


def unet_tail_shapes(b: int, size: int, nb=(32, 64, 128, 256)) -> list[tuple]:
    """The seven block tails of one forward of b images of size^2: (name,
    (B, H, W, C), split) with `split` for the decoder's split residual and
    style row."""
    enc = [(f"down{i}", (b, size >> i, size >> i, c), False) for i, c in enumerate(nb)]
    dec = [(f"up{i}", (b, size >> lv, size >> lv, nb[lv]), True)
           for i, lv in enumerate(reversed(range(len(nb) - 1)))]
    return enc + dec


def unet_tail_phase(m, dev, b: int, size: int, launches: int, timed, say, smi: str) -> dict:
    """Phase 17: kernel 9 at each of the seven tails of one forward of b
    images of size^2, on random operands: bit for bit against its plain
    version (int16 views), then timed by CUDA events into a separate output
    beside its bytes bound (each operand read once, the output written
    once) and the plain version, which is the PyTorch sequence the forward
    ran before the kernel (so it is the library yardstick too). Returns
    kernel 9's entry of the `kernels` line."""
    tc = m.tail_cuda
    tot = {"ms": 0.0, "plain": 0.0, "bound": 0.0}
    g = torch.Generator(device=dev).manual_seed(17)
    for name, (n, h, w, c), split in unet_tail_shapes(b, size):
        bf = torch.bfloat16
        y = torch.randn((n, h, w, c), generator=g, device=dev).mul_(3).to(bf)
        skip = torch.randn((n, h, w, c), generator=g, device=dev).to(bf)
        scale = torch.randn((n, c), generator=g, device=dev).add_(1)
        bias = torch.randn((n, c), generator=g, device=dev).mul_(0.5)
        up = style = None
        if split:
            up = torch.randn((n, h // 2, w // 2, c), generator=g, device=dev).to(bf)
            style = torch.randn((n, c), generator=g, device=dev).mul_(0.3).to(bf)
        want = tc.unet_tail_plain(y, scale, bias, skip, up=up, style=style)
        got = tc.unet_tail(y, scale, bias, skip, up=up, style=style)
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            bad = int((got.view(torch.int16) != want.view(torch.int16)).sum())
            raise RuntimeError(f"unet_tail {name}: {bad} values differ from the plain version")
        del want
        ms, plain_ms = timed(
            lambda: tc.unet_tail(y, scale, bias, skip, up=up, style=style, out=got),
            lambda: tc.unet_tail_plain(y, scale, bias, skip, up=up, style=style))
        nbytes = sum(t.numel() * t.element_size() for t in (y, skip, got, scale, bias, up, style)
                     if t is not None)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        tot["ms"] += ms
        tot["plain"] += plain_ms
        tot["bound"] += b_ms
        say(f"[time] unet_tail {name} {(n, h, w, c)} {'split skip and style' if split else 'skip'}: "
            f"{ms:.4f} ms; bound {b_ms:.4f} ms (bytes: {nbytes / 1e9:.3f} GB), {b_ms / ms:.1%} of "
            f"it reached; plain (the PyTorch sequence it replaced) {plain_ms:.4f} ms; bit for bit")
        del y, skip, scale, bias, up, style, got
    say(f"[time] unet_tail (kernel 9), all 7 tails of one forward: {tot['ms']:.4f} ms "
        f"({tot['bound'] / tot['ms']:.1%} of its {tot['bound']:.4f} ms bound, bytes); plain "
        f"(the PyTorch sequence it replaced) {tot['plain']:.3f} ms; launches on the segmentation "
        f"path {launches}; card: {smi}")
    return {
        "name": "unet_tail", "route": "cuda",
        "source": f"{CSRC}/unet_tail.cu", "replaces": None, "launches": launches,
        "max_abs_err": 0.0, "ms": tot["ms"], "plain_ms": tot["plain"], "bound_ms": tot["bound"],
        "bound_by": "bytes", "library_ms": tot["plain"],
    }


def sam_amg_route(m, dev, rehearsal: bool, wells: np.ndarray, say) -> dict[str, int]:
    """Phase 18's route: `batch_segment(network="sam")` on the wells' first
    three channels with seeded weights, once to build, then with kernel
    8's and kernel 10's launch counts zeroed just before the call. Returns
    the call's launches of each of kernel 8's forms, which must be one per
    block of that form and encoder micro-batch, and of kernel 10, which must
    be one per prompt batch (`decode` call) of every image."""
    from arcadia_microscopy_tools_tpu_torch.models import sam_amg, sam_attention as sa
    from arcadia_microscopy_tools_tpu_torch.models import sam_upscale_cuda as su
    from arcadia_microscopy_tools_tpu_torch.models import sam_decoder, vit_sam
    from arcadia_microscopy_tools_tpu_torch.models import segmentation as seg_mod

    model = m.pkg.SegmentationModel(device=dev, network="sam")
    if rehearsal:
        model._sam_model_config = sam_decoder.SamModelConfig(
            vit_sam.SamConfig(width=64, depth=4, heads=4, mlp=256, patch=16, tile=128, neck=32,
                              global_blocks=(2,), sam_grid=8, sam_window=3, window=3),
            sam_decoder.DecoderConfig(width=32, depth=2, heads=2, mlp=64, iou_hidden=32))
        model._amg = sam_amg.AmgSettings(points_per_side=4, points_per_batch=8)
        imgs = [np.asarray(w[:3], dtype=np.float64) for w in m.testing.synthetic_wells(
            8, 4, 256, 256, 20, seed=18)]
    else:
        imgs = [np.asarray(w[:3], dtype=np.float64) for w in wells]
    model.batch_segment(imgs, show_progress=False)  # builds the kernels and the weights
    enc = model.network.config.image
    n_global = sum(1 for i in range(enc.depth) if i in enc.global_blocks)
    sa.reset_launch_counts()
    su.reset_launch_counts()
    model.stages = m.profiling.StageTimer()
    t0 = time.perf_counter()
    labels = model.batch_segment(imgs, show_progress=False)
    call_s = time.perf_counter() - t0
    launches = {k: sa.launch_counts[k] for k in ("sam_attention", "sam_window_attention")}
    launches["sam_upscale"] = su.launch_counts["sam_upscale"]
    micro = -(-len(imgs) // seg_mod.SAM_AMG_MICRO_BATCH)
    amg = model._amg or sam_amg.AmgSettings()  # None is the published defaults
    batches = -(-amg.points_per_side ** 2 // amg.points_per_batch)
    want = {"sam_attention": n_global * micro,
            "sam_window_attention": (enc.depth - n_global) * micro,
            "sam_upscale": batches * len(imgs)}
    st = model.stages
    counters = {k: v for k, v in st.counts.items() if k.startswith("segment.amg.")
                or k == "segment.encoder.images"}
    say(f"[sam] batch_segment(network='sam') on {len(imgs)} images of {imgs[0].shape}: "
        f"{call_s:.3f} s ({len(imgs) / call_s:.2f} images/s); kernel 8 and 10 launches "
        f"{launches} ({micro} encoder micro-batch(es), {batches} prompt batches an image: "
        f"{want} due); stages "
        f"{json.dumps({k: round(v, 4) for k, v in st.totals.items()})}; counters "
        f"{json.dumps(counters)}; cells per image {[int(x.max()) for x in labels]}")
    if any(x is None for x in labels):
        raise RuntimeError("the sam route lost an image")
    if not rehearsal and launches != want:
        raise RuntimeError(f"the sam route launched kernels 8 and 10 {launches}, not {want}")
    return launches


def sam_attention_forms_phase(m, dev, rehearsal: bool, wells: np.ndarray, timed, say,
                              smi: str) -> tuple[list[dict], dict[str, int]]:
    """Phase 18: the AMG route's launches of kernels 8 and 10 (`sam_amg_route`);
    kernel 8's global instance at SAM's 64 x 64 grid and its window kernel
    on 14 x 14 windows, each against its plain version and timed at one
    encoder micro-batch of 8 images beside its bound (the benchmark's: the
    4096 real tokens of each image, in windows also the pad keys' k and v,
    which are the qkv bias); the grid-32 instance re-timed. The `kernels`
    line gives each form's launches in the route's call; the route's counts
    are returned beside its rows."""
    from arcadia_microscopy_tools_tpu_torch.models import sam_attention as sa

    route = sam_amg_route(m, dev, rehearsal, wells, say)

    heads, hd = 16, 64
    gq = torch.Generator(device=dev).manual_seed(18)

    def case(tiles: int, grid: int, scale: float = 1.0):
        qkv = (scale * torch.randn(tiles, grid * grid, 3 * heads * hd, generator=gq, device=dev))
        rh, rw = ((0.05 * torch.randn(2 * grid - 1, hd, generator=gq, device=dev)).to(
            torch.bfloat16) for _ in range(2))
        return qkv.to(torch.bfloat16), rh, rw

    def bound_ms(images: int, grid: int, side: int) -> float:
        """`images` of grid^2 real tokens, each query against side^2 keys."""
        n = images * grid * grid
        flop = heads * n * (4.0 * side * side * hd + 4.0 * side * hd)
        pad = 2 * heads * hd if side < grid else 0
        byt = 2.0 * (4 * n * heads * hd + pad + 2 * (2 * side - 1) * hd)
        return max(flop / BF16_TENSOR_FLOP_PER_S, byt / HBM_BYTES_PER_S) * 1e3

    # per form: grid (or window side), the checked counts, the timed count,
    # and the images of 64 x 64 tokens that timed count holds
    forms = {"sam_attention": (64, [1, 2], 8, 8),
             "sam_window_attention": (14, [1, 7, 25, 200], 200, 8)}
    image_grid = 64
    if rehearsal:
        forms = {"sam_attention": (8, [1], 1, 1), "sam_window_attention": (3, [1, 2], 2, 1)}
        heads, image_grid = 1, 4
    rows = []
    for kernel, (grid, counts, timed_tiles, images) in forms.items():
        sa.reset_launch_counts()
        errs = {}
        for tiles in counts:
            for scale in (1.0, 3.0):
                q_, h_, w_ = case(tiles, grid, scale)
                want = sa.sam_attention_plain(q_, h_, w_, heads, grid).float()
                got = sa.sam_attention(q_, h_, w_, heads, grid).float()
                err = float((got - want).abs().max())
                errs[f"{tiles} x {grid}^2, spread {scale}"] = {
                    "max_abs_err": err, "bf16_steps": bf16_steps(err, want)}
                del want, got
        worst = max(e["bf16_steps"] for e in errs.values())
        launched = sa.launch_counts[kernel]
        say(f"[check] {kernel} (grid {grid}) against its plain version: {json.dumps(errs)}; "
            f"launches {sa.launch_counts}")
        if not rehearsal and (worst > SAM_ATTENTION_STEPS or launched != 2 * len(counts)):
            raise RuntimeError(f"{kernel}: {worst:.2f} bf16 steps (at most "
                               f"{SAM_ATTENTION_STEPS}), launches {sa.launch_counts}")
        qkv, rh, rw = case(timed_tiles, grid)
        sub = qkv[: max(1, timed_tiles // 8)]
        ms, plain_sub = timed(lambda: sa.sam_attention(qkv, rh, rw, heads, grid),
                              lambda: sa.sam_attention_plain(sub, rh, rw, heads, grid))
        plain = plain_sub * timed_tiles / sub.shape[0]

        def sdpa_with_bias():
            q8, k8, v8 = sa.split_qkv(qkv, heads)
            idx = torch.arange(grid, device=dev)
            tab_h = rh.float()[idx[:, None] - idx[None, :] + grid - 1]
            tab_w = rw.float()[idx[:, None] - idx[None, :] + grid - 1]
            r_q = q8.float().view(-1, grid, grid, hd)
            bias = (torch.einsum("nhwc,hkc->nhwk", r_q, tab_h)[..., :, None]
                    + torch.einsum("nhwc,wkc->nhwk", r_q, tab_w)[..., None, :])
            bias = bias.reshape(-1, grid * grid, grid * grid).to(torch.bfloat16)
            return torch.nn.functional.scaled_dot_product_attention(q8, k8, v8, attn_mask=bias)

        library = time_cuda(sdpa_with_bias, reps=3, warmup=1) if not rehearsal else None
        bound = bound_ms(images, image_grid, grid)
        say(f"[time] {kernel} (kernel 8, grid {grid}): {ms:.4f} ms per micro-batch of "
            f"{images} images ({timed_tiles} {'windows' if grid < image_grid else 'images'}; "
            f"{bound / ms:.1%} of its {bound:.4f} ms bound); plain {plain:.3f} ms (from "
            f"{sub.shape[0]}); SDPA with a materialised bf16 bias {library} ms; worst "
            f"{worst:.2f} bf16 steps; launched {route[kernel]} times in the route's call; "
            f"card: {smi}")
        rows.append({"name": f"{kernel} (grid {grid})", "route": "cuda",
                     "source": "arcadia_microscopy_tools_tpu_torch/csrc/sam_attention.cu",
                     "replaces": None, "launches": route[kernel], "ms": ms, "plain_ms": plain,
                     "bound_ms": bound, "library_ms": library, "bf16_steps": worst})
        del qkv
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if not rehearsal:
        qkv, rh, rw = case(64, 32)
        ms32 = [time_cuda(lambda: sa.sam_attention(qkv, rh, rw, heads, 32), reps=20)
                for _ in range(2)]
        say(f"[time] sam_attention grid 32 (Cellpose-SAM's) re-timed at 64 tiles: "
            f"{ms32[0]:.4f}, {ms32[1]:.4f} ms; card: {smi}")
        del qkv
    return rows, route


def sam_upscale_operands(prompts: int, grid: int, dev, seed: int, spread: float = 1.0):
    """Random operands of kernel 10 at SAM's widths in `decode`'s layout:
    keys, the ConvTs (weights N(0, 1 / fan_in), the LayerNorm's weight 1 +
    N(0, 0.1^2), biases N(0, 0.02^2)) and three hypernetwork rows."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(dev, torch.bfloat16)

    return (r(prompts, grid * grid, 256, scale=spread), r(256, 256, scale=256**-0.5),
            r(64, scale=0.02), (1 + 0.1 * torch.randn(64, generator=g)).to(dev, torch.bfloat16),
            r(64, scale=0.02), r(128, 64, scale=64**-0.5), r(32, scale=0.02),
            r(prompts, 3, 32, scale=spread), grid)


def mask_steps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst mask's largest |got - want| in bfloat16 steps at that
    mask's largest |logit|."""
    g, w = got.float().flatten(2), want.float().flatten(2)
    step = torch.exp2(torch.floor(torch.log2(w.abs().amax(-1).clamp_min(1e-30))) - 7)
    return float(((g - w).abs().amax(-1) / step).max())


def sam_upscale_phase(m, dev, rehearsal: bool, launches: int, timed, say, smi: str) -> dict:
    """Phase 18's kernel 10 (models/sam_upscale_cuda.py, csrc/sam_upscale.cu):
    against its plain version at P = 1, 7 and 64 prompts on grids 64 and 16
    and two spreads, each mask within SAM_ATTENTION_STEPS bfloat16 steps of
    its largest |logit|, with the share of bit-equal logits; then timed at
    one prompt batch (P = 64, grid 64) beside its bound (the three products'
    operations, or keys, weights and logits once, whichever is larger) and
    the plain version, the PyTorch sequence `decode` ran before it (so the
    library yardstick too). `launches` is the AMG route's count."""
    from arcadia_microscopy_tools_tpu_torch.models import sam_upscale_cuda as su

    cases = [(1, 8), (2, 8)] if rehearsal else [(1, 64), (7, 64), (64, 64), (1, 16), (7, 16),
                                                  (64, 16)]
    su.reset_launch_counts()
    checks = {}
    for prompts, grid in cases:
        for spread in (1.0, 4.0):
            args = sam_upscale_operands(prompts, grid, dev, prompts * 100 + grid, spread)
            got, want = su.sam_upscale(*args), su.sam_upscale_plain(*args)
            equal = float((got.view(torch.int16) == want.view(torch.int16)).float().mean())
            checks[f"P {prompts}, grid {grid}, spread {spread}"] = {
                "bf16_steps": mask_steps(got, want), "bit_equal": equal}
    worst = max(c["bf16_steps"] for c in checks.values())
    say(f"[check] sam_upscale (kernel 10) against its plain version, worst mask in bf16 steps "
        f"and the share of bit-equal logits: {json.dumps(checks)}; launches {su.launch_counts}")
    if not rehearsal and (worst > SAM_ATTENTION_STEPS
                          or su.launch_counts["sam_upscale"] != 2 * len(cases)):
        raise RuntimeError(f"sam_upscale: {worst:.2f} bf16 steps (at most {SAM_ATTENTION_STEPS}), "
                           f"launches {su.launch_counts}")
    prompts, grid = (2, 8) if rehearsal else (64, 64)
    args = sam_upscale_operands(prompts, grid, dev, 18)
    ms, plain_ms = timed(lambda: su.sam_upscale(*args), lambda: su.sam_upscale_plain(*args))
    pixels = prompts * grid * grid
    flop = 2.0 * pixels * (256 * 256 + 4 * 64 * 128 + 16 * 32 * 3)
    nbytes = 2.0 * (pixels * 256 + prompts * 3 * 16 * grid * grid + 256 * 256 + 128 * 64
                    + prompts * 3 * 32)
    ops_ms, bytes_ms = flop / BF16_TENSOR_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(ops_ms, bytes_ms)
    say(f"[time] sam_upscale (kernel 10) at one prompt batch ({prompts} prompts, grid {grid}): "
        f"{ms:.4f} ms, {bound / ms:.1%} of its {bound:.4f} ms bound (operations {ops_ms:.4f}: "
        f"{flop / 1e9:.1f} GFLOP; bytes {bytes_ms:.4f}: {nbytes / 1e6:.0f} MB); plain (the PyTorch "
        f"sequence decode ran before it) {plain_ms:.3f} ms; worst {worst:.2f} bf16 steps; "
        f"launched {launches} times in the route's call; card: {smi}")
    return {"name": "sam_upscale", "route": "cuda", "source": f"{CSRC}/sam_upscale.cu",
            "replaces": None, "launches": launches, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": plain_ms, "bf16_steps": worst}


def cellpose_sam_phase(m, dev, rehearsal: bool, wells: np.ndarray, timed, say, smi: str) -> dict:
    """Phase 16: `batch_segment(network="cpsam")` on the wells' first three
    channels with seeded weights, once to build and to capture the qkv of
    blocks 0, 11 and 23 of the first micro-batch and of block 23 of the last
    (the call's tail of 32 tiles); kernel 8 against its plain version on
    those and on random q, k, v of a micro-batch and of a tail, timed per
    micro-batch beside its bound and SDPA with a materialised bias; then the
    call again, counted and timed. Returns kernel 8's entry of the `kernels`
    line."""
    from arcadia_microscopy_tools_tpu_torch.models import sam_attention as sa
    from arcadia_microscopy_tools_tpu_torch.models import segmentation as seg_mod
    from arcadia_microscopy_tools_tpu_torch.models import vit_sam

    # the route: batch_segment(network="cpsam") on 8 3-channel images, seeded weights
    sam_model = m.pkg.SegmentationModel(device=dev, network="cpsam")
    if rehearsal:
        sam_model._sam_config = vit_sam.SamConfig(width=128, depth=2, heads=2, mlp=256, neck=16,
                                                  global_blocks=(1,))
        sam_imgs = [np.asarray(w[:3], dtype=np.float64) for w in m.testing.synthetic_wells(
            8, 4, 256, 256, 20, seed=16)]
    else:
        sam_imgs = [np.asarray(w[:3], dtype=np.float64) for w in wells]
    sam_cfg = sam_model._sam_config
    depth = sam_cfg.depth
    _ = sam_model.network
    captured, calls = {}, [0]
    real_attention = vit_sam.sam_attention

    def record(qkv, rh, rw, heads, grid):
        micro, block = divmod(calls[0], depth)
        calls[0] += 1
        if (micro == 0 and block in (0, depth // 2 - 1, depth - 1)) or block == depth - 1:
            captured[(micro, block)] = (qkv.clone(), rh, rw)
        return real_attention(qkv, rh, rw, heads, grid)

    vit_sam.sam_attention = record
    try:
        sam_model.batch_segment(sam_imgs, show_progress=False)  # builds the kernel
    finally:
        vit_sam.sam_attention = real_attention
    last = max(k[0] for k in captured)
    cases = {f"block {b}, micro-batch 0": captured[(0, b)]
             for b in sorted({0, depth // 2 - 1, depth - 1})}
    cases[f"block {depth - 1}, micro-batch {last} (the tail)"] = captured[(last, depth - 1)]
    del captured
    grid, heads, hd = sam_cfg.grid, sam_cfg.heads, sam_cfg.head_dim
    sam_tiles_n = seg_mod.SAM_MICRO_BATCH if not rehearsal else 4
    gq = torch.Generator(device=dev).manual_seed(16)
    qkv = torch.randn(sam_tiles_n, grid * grid, 3 * heads * hd, generator=gq, device=dev)
    qkv = qkv.to(torch.bfloat16)
    rh, rw = ((0.05 * torch.randn(2 * grid - 1, hd, generator=gq, device=dev)).to(torch.bfloat16)
              for _ in range(2))
    cases[f"random, {sam_tiles_n} tiles"] = (qkv, rh, rw)
    cases[f"random, {sam_tiles_n // 2} tiles"] = (qkv[: sam_tiles_n // 2], rh, rw)
    sa.reset_launch_counts()
    errs = {}
    for name, (q_, h_, w_) in cases.items():
        want = sa.sam_attention_plain(q_, h_, w_, heads, grid).float()
        got = sa.sam_attention(q_, h_, w_, heads, grid).float()
        err = float((got - want).abs().max())
        errs[name] = {"tiles": q_.shape[0], "max_abs_err": err,
                      "max_abs_o": float(want.abs().max()),
                      "mean_abs_err": float((got - want).abs().mean()),
                      "bf16_steps": bf16_steps(err, want)}
        del want, got
    say(f"[check] sam_attention against its plain version: {json.dumps(errs)}")
    launched = sa.launch_counts["sam_attention"]
    worst = max(e["bf16_steps"] for e in errs.values())
    if not rehearsal and (worst > SAM_ATTENTION_STEPS or launched != len(cases)):
        raise RuntimeError(f"sam_attention against its plain version: {worst:.2f} bf16 steps "
                           f"(at most {SAM_ATTENTION_STEPS}), launches {sa.launch_counts}")
    err8 = max(e["max_abs_err"] for e in errs.values())
    del cases
    per_tile_block_s = (heads * (4.0 * (grid * grid) ** 2 * hd + 4.0 * grid**3 * hd)
                        / BF16_TENSOR_FLOP_PER_S)
    bound8 = sam_tiles_n * per_tile_block_s * 1e3
    ms8, plain8 = timed(lambda: sa.sam_attention(qkv, rh, rw, heads, grid),
                        lambda: sa.sam_attention_plain(qkv, rh, rw, heads, grid))

    def sdpa_with_bias():
        q8, k8, v8 = sa.split_qkv(qkv, heads)
        idx = torch.arange(grid, device=dev)
        tab_h = rh.float()[idx[:, None] - idx[None, :] + grid - 1]
        tab_w = rw.float()[idx[:, None] - idx[None, :] + grid - 1]
        r_q = q8.float().view(-1, grid, grid, hd)
        bias = (torch.einsum("nhwc,hkc->nhwk", r_q, tab_h)[..., :, None]
                + torch.einsum("nhwc,wkc->nhwk", r_q, tab_w)[..., None, :])
        bias = bias.reshape(-1, grid * grid, grid * grid).to(torch.bfloat16)
        return torch.nn.functional.scaled_dot_product_attention(q8, k8, v8, attn_mask=bias)

    lib8 = time_cuda(sdpa_with_bias, reps=3, warmup=1) if not rehearsal else None
    del qkv
    sa.reset_launch_counts()
    sam_model.stages = m.profiling.StageTimer()
    t_sam = time.perf_counter()
    sam_masks, sam_flows = sam_model.batch_segment(sam_imgs, show_progress=False,
                                                   return_flows=True)
    sam_call_s = time.perf_counter() - t_sam
    launches8 = sa.launch_counts["sam_attention"]
    sam_tiles_call = sam_model.stages.counts["segment.encoder.tiles"]
    micro_batches = -(-sam_tiles_call // seg_mod.SAM_MICRO_BATCH)
    if not rehearsal and launches8 != depth * micro_batches:
        raise RuntimeError(f"kernel 8 launched {launches8} times for {sam_tiles_call} tiles")
    if any(m_ is None for m_ in sam_masks) or any(not np.isfinite(f).all() for f in sam_flows):
        raise RuntimeError("the cpsam route lost an image or returned non-finite maps")
    call8 = ms8 * sam_tiles_call / sam_tiles_n * depth
    say(f"[time] sam_attention (kernel 8): {ms8:.4f} ms per "
        f"micro-batch of {sam_tiles_n} tiles ({bound8 / ms8:.1%} of its {bound8:.4f} ms bound, "
        f"operations); ~{call8:.1f} ms per call of {len(sam_imgs)} images ({sam_tiles_call} "
        f"tiles, {launches8} launches; bound "
        f"{sam_tiles_call * depth * per_tile_block_s * 1e3:.2f} ms); "
        f"plain {plain8:.3f} ms; SDPA with a materialised bf16 bias (library call, bias "
        f"included) {lib8} ms; max |err| {err8:.3g} ({worst:.2f} bf16 steps); card: {smi}")
    st8 = sam_model.stages
    say(f"[sam] batch_segment(network='cpsam') on {len(sam_imgs)} images of "
        f"{sam_imgs[0].shape}: {sam_call_s:.3f} s ({len(sam_imgs) / sam_call_s:.2f} images/s); "
        f"stages {json.dumps({k: round(v, 4) for k, v in st8.totals.items()})}; "
        f"cells per image {[int(x.max()) for x in sam_masks]}")
    return {
        "name": "sam_attention", "route": "cuda",
        "source": "arcadia_microscopy_tools_tpu_torch/csrc/sam_attention.cu",
        "replaces": None, "launches": launches8, "max_abs_err": err8, "ms": ms8,
        "plain_ms": plain8, "bound_ms": bound8, "bound_by": "operations", "library_ms": lib8,
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--cpu-rehearsal",
        action="store_true",
        help="tiny sizes on the CPU with the plain versions; prints no device result",
    )
    parser.add_argument("--compare-with", metavar="FILE",
                        help="output of an earlier run in the same chip call: print its kernel "
                             "times beside this run's")
    parser.add_argument("--profile", metavar="DIR",
                        help="also trace the segmentation, preprocessing and U-Net plate "
                             "batches")
    args = parser.parse_args(argv)
    with contextlib.ExitStack() as cleanup:
        return _smoke(args, cleanup)


def _smoke(args, cleanup: contextlib.ExitStack) -> int:
    """The phases of the module docstring; temporary directories are
    removed when `cleanup` closes."""
    rehearsal = args.cpu_rehearsal

    def say(msg: str) -> None:
        log(("[cpu rehearsal: no device numbers] " if rehearsal else "") + msg)

    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1

    m = port_modules()
    cc_cuda, conv_cuda, gn_cuda, flows_cuda, flows = (
        m.cc_cuda, m.conv_cuda, m.gn_cuda, m.flows_cuda, m.flows
    )
    n_wells, n_ch = 8, 4
    size, blobs, ragged = (2048, 300, (1000, 1500)) if not rehearsal else (256, 10, (200, 300))
    seg_size, seg_blobs, check_size = (2048, 300, 512) if not rehearsal else (128, 6, 64)
    pre_size, pre_crop, pre_blobs = (2048, 640, 120) if not rehearsal else (96, 64, 4)
    dev = torch.device("cpu" if rehearsal else "cuda")
    sync = torch.cuda.synchronize if not rehearsal else (lambda: None)
    t_start = time.perf_counter()

    # -- 1. device ----------------------------------------------------------------
    if rehearsal:
        kind, smi = "cpu (rehearsal)", "cpu rehearsal: nvidia-smi not queried"
    else:
        kind, smi = torch.cuda.get_device_name(0), nvidia_smi_line()
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {kind}")
    say(f"[device] nvidia-smi: {smi}")

    # -- 2. build -----------------------------------------------------------------
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:  # g++ of the host library beside the nvcc builds
        host_build = pool.submit(m._native.build)
        if not rehearsal:
            t0 = time.perf_counter()
            built = m._build.load_kernel_libraries(KERNEL_LIBRARIES)
            say(f"[build] {len(built)} libraries in {time.perf_counter() - t0:.1f} s "
                f"(one nvcc per source, in parallel)")
        say(f"[build] host library (g++ of native/amt_host.cpp): "
            f"{'built' if host_build.result() else 'not built, the pure-Python fallbacks run'}")
    if not rehearsal:
        for name, lib in built.items():
            # template instantiations report alike: each distinct line once
            reports = [line.split(":", 1)[-1].strip() for line in lib.ptxas_log.splitlines()
                       if "registers" in line or "spill" in line]
            for report in dict.fromkeys(reports):
                say(f"[build] {name} ptxas: {report}")
        smem = 2 * cc_cuda.CC_BLOCK**2 * 4 + cc_cuda.CC_BLOCK**2
        say(f"[build] cc_local: local_cc keeps its labels in registers; local_resweep's "
            f"dynamic shared memory per CTA: {smem} B")

    # -- data ---------------------------------------------------------------------
    t0 = time.perf_counter()
    wells = m.testing.synthetic_wells(n_wells, n_ch, size, size, blobs, seed=0)
    say(f"[data] {n_wells} wells of {n_ch}x{size}x{size} uint16, {blobs} blobs each, "
        f"made in {time.perf_counter() - t0:.1f} s")
    staged = torch.from_numpy(wells).to(dev)
    masks = m.fused.fused_classical_mask(staged[:, 0])
    say(f"[data] foreground fraction {float(masks.float().mean()):.4f}")

    # -- 3. kernels against their plain versions ------------------------------------
    masks_np = masks.cpu().numpy()
    cases = {
        f"main {n_wells}x{size}^2": masks,
        "serpentine": torch.from_numpy(m.testing.serpentine(masks_np[0, :512, :512])[None]).to(dev),
        f"ragged {ragged[0]}x{ragged[1]}": masks[:1, : ragged[0], : ragged[1]].contiguous(),
        "empty": torch.zeros((1, 256, 384), dtype=torch.bool, device=dev),
        "full": torch.ones((1, 256, 384), dtype=torch.bool, device=dev),
        # tiles without foreground store their sentinels at once; beside them,
        # tiles that sweep
        "empty tiles beside foreground": torch.cat(
            [masks[:1, :256, :256], torch.zeros((1, 256, 128), dtype=torch.bool, device=dev),
             masks[:1, :256, 256:512]], 2).contiguous(),
    }
    max_err = {"local_cc": 0.0, "local_resweep": 0.0, "conv3x3_fused": 0.0,
               "lane_moments": 0.0, "diffuse": 0.0, "percentile_stretch": 0.0}
    for conn in (1, 2):
        for name, fg in cases.items():
            got = cc_cuda.local_cc(fg, conn)
            want = cc_cuda.local_cc_plain(fg, conn)
            err = float((got.long() - want.long()).abs().max()) if got.numel() else 0.0
            max_err["local_cc"] = max(max_err["local_cc"], err)
            seeds = m.labeling.resweep_seeds(fg, conn)
            got = cc_cuda.local_resweep(fg, seeds, conn)
            want = cc_cuda.local_resweep_plain(fg, seeds, conn)
            err2 = float((got.long() - want.long()).abs().max()) if got.numel() else 0.0
            max_err["local_resweep"] = max(max_err["local_resweep"], err2)
            say(f"[kernels] connectivity {conn} {name}: local_cc err {err:g}, "
                f"local_resweep err {err2:g}")
            if err or err2:
                raise RuntimeError(f"kernel disagrees with its plain version on {name}")
    caps = cc_cuda.tile_sweep_counts(cases["serpentine"], 2)
    if int(caps.max()) != 256:
        raise RuntimeError("the serpentine did not reach the 256-sweep cap")
    sync()
    say("[kernels] both CC kernels equal their plain versions bit for bit")

    conv_calls = forward_conv_shapes(n_wells, seg_size)
    extra_conv = [("ragged 1000x1504", 1, 1000, 1504, 64, 32, True, True),
                  ("3-row", 2, 3, 200, 32, 64, True, True)] if not rehearsal else [
                  ("ragged 40x56", 1, 40, 56, 64, 32, True, True)]
    for k, (name, c, co, h, pro, acc, mom) in enumerate(conv_calls):
        x, wt, kw = conv_operands(n_wells, h, h, c, co, pro, acc, dev, seed=k)
        err = check_conv(m, x, wt, kw, mom)
        max_err["conv3x3_fused"] = max(max_err["conv3x3_fused"], err)
        say(f"[kernels] conv3x3_fused {name} ({n_wells}x{h}^2, {c}->{co}, prologue+relu {pro}, "
            f"accum {acc}, moments {mom}): max abs err {err:g}, within one bf16 step")
        del x, wt, kw
    # the S2D forward's shapes that the planar forward does not give the kernel:
    # 128 and 256 channels at 4x the planar 128/256 levels' pixels
    planar_keys = {call[1:] for call in conv_calls}
    s2d_new = [call for call in s2d_conv_shapes(n_wells, seg_size) if call[1:] not in planar_keys]
    for k, (name, c, co, h, pro, acc, mom) in enumerate(s2d_new):
        x, wt, kw = conv_operands(n_wells, h, h, c, co, pro, acc, dev, seed=600 + k)
        err = check_conv(m, x, wt, kw, mom)
        max_err["conv3x3_fused"] = max(max_err["conv3x3_fused"], err)
        say(f"[kernels] conv3x3_fused {name} ({n_wells}x{h}^2, {c}->{co}, prologue+relu {pro}, "
            f"accum {acc}, moments {mom}): max abs err {err:g}, within one bf16 step")
        del x, wt, kw
    for k, (name, b, h, w, c, co, pro, mom) in enumerate(extra_conv):
        x, wt, kw = conv_operands(b, h, w, c, co, pro, True, dev, seed=100 + k)
        err = check_conv(m, x, wt, kw, mom)
        max_err["conv3x3_fused"] = max(max_err["conv3x3_fused"], err)
        say(f"[kernels] conv3x3_fused {name} ({b}x{h}x{w}, {c}->{co}, prologue, relu, accum, "
            f"moments): max abs err {err:g}, within one bf16 step")
    edge_conv = [("W 100, not a multiple of the 64-pixel tile", 2, 37, 100, 32, 32),
                 ("H 1", 1, 1, 130, 64, 64), ("B 1, C = Co = 256", 1, 20, 70, 256, 256),
                 ("256 -> 128", 1, 9, 130, 256, 128)]
    for k, (name, b, h, w, c, co) in enumerate(edge_conv):
        for pro, acc in ((False, False), (True, False), (False, True), (True, True)):
            x, wt, kw = conv_operands(b, h, w, c, co, pro, acc, dev, seed=300 + k)
            err = check_conv(m, x, wt, kw, True)
            max_err["conv3x3_fused"] = max(max_err["conv3x3_fused"], err)
            say(f"[kernels] conv3x3_fused {name} ({b}x{h}x{w}, {c}->{co}, prologue+relu {pro}, "
                f"accum {acc}, moments): max abs err {err:g}, within one bf16 step")
    # two launches on the same inputs: the same bits (fixed-order moments, no atomics)
    name, c, co, h, pro, acc, _ = conv_calls[0]
    for label, (b, hh, w, c, co, pro, acc) in (
            (f"{name} at {n_wells}x{h}^2", (n_wells, h, h, c, co, pro, acc)),
            ("B 1, C = Co = 256, prologue, accum", (1, 20, 70, 256, 256, True, True))):
        x, wt, kw = conv_operands(b, hh, w, c, co, pro, acc, dev, seed=400)
        (y1, (p1, q1)), (y2, (p2, q2)) = (conv_cuda.conv3x3_fused(x, wt, emit_moments=True, **kw)
                                          for _ in range(2))
        same = (torch.equal(y1.view(torch.int16), y2.view(torch.int16))
                and all(torch.equal(u.view(torch.int32), v.view(torch.int32))
                        for u, v in ((p1, p2), (q1, q2))))
        say(f"[kernels] conv3x3_fused {label}: two launches give the same bits of y and the "
            f"moments: {same}")
        if not same:
            raise RuntimeError(f"conv3x3_fused is not deterministic on {label}")
        del x, wt, kw, y1, y2
    # the conv on row slabs (a spatially sharded U-Net): halo rows against the
    # plain version, and each forward shape split at half its rows (1024
    # full-resolution rows at every level, a multiple of every tile height)
    # as two slab calls, concatenated, against the whole-image call
    for k, (name, c, co, h, pro, acc, mom) in enumerate(conv_calls):
        x, wt, kw = conv_operands(n_wells, h, h, c, co, pro, acc, dev, seed=k)
        split = h // 2
        same = slabs_equal_whole(m, x, wt, kw, mom, split)
        top, bottom = ((0, 1), (1, 0), (1, 1))[k % 3]
        halo_kw = dict(kw, top=top, bottom=bottom)
        if acc:
            halo_kw["accum"] = kw["accum"][:, :split].contiguous()
        err = check_conv(m, x[:, : split + top + bottom].contiguous(), wt, halo_kw, mom)
        max_err["conv3x3_fused"] = max(max_err["conv3x3_fused"], err)
        say(f"[kernels] conv3x3_fused {name} on row slabs: rows [0, {split}) and [{split}, {h}) "
            f"with one halo row each, concatenated, equal the whole-image call bit for bit (y "
            f"{'and moment partials' if mom else 'only'}): {same}; a slab of {split} rows with "
            f"top {top} / bottom {bottom} halo rows against its plain version: max abs err {err:g}, "
            f"within one bf16 step")
        if not same:
            raise RuntimeError(f"conv3x3_fused on row slabs differs from the whole image on {name}")
        del x, wt, kw, halo_kw
    probe = probe_library_slabs(m, n_wells, seg_size, dev)
    say(f"[kernels] the forward's calls outside the kernels on row slabs (halves of each level's "
        f"rows) give the whole image's bits: {json.dumps(probe)}")
    if not all(v for k, v in probe.items() if not k.startswith("cuBLAS")):
        raise RuntimeError("a call of the forward gives a row slab other bits than the whole image")
    gn_cases = [(n_wells, seg_size, seg_size, 32), (1, 1000, 1504, 32), (2, 37, 45, 64),
                (1, 64, 64, 256)] if not rehearsal else [(2, 64, 64, 32), (1, 37, 45, 64)]
    # the S2D stems' outputs
    gn_cases += [(n_wells, seg_size // 2, seg_size // 2, 128), (n_wells, seg_size // 4, seg_size // 4, 256)]
    for k, shape in enumerate(gn_cases):
        g = torch.Generator(device=dev).manual_seed(200 + k)
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)
        got, want = gn_cuda.lane_moments(x), gn_cuda.lane_moments_plain(x)
        scale = (x.float().abs().sum((1, 2)), (x.float() ** 2).sum((1, 2)))
        rel = max(float(((a - b).abs() / s).max()) for a, b, s in zip(got, want, scale))
        max_err["lane_moments"] = max(
            max_err["lane_moments"], max(float((a - b).abs().max()) for a, b in zip(got, want))
        )
        run = gn_cuda.lane_rows(shape[2])
        split = shape[1] // 2 // run * run  # a row slab starts on a multiple of the run
        slabs = torch.cat([gn_cuda.lane_moments(x[:, :split].contiguous(), partials=True),
                           gn_cuda.lane_moments(x[:, split:].contiguous(), partials=True)], 1)
        same = torch.equal(slabs.view(torch.int32),
                           gn_cuda.lane_moments(x, partials=True).view(torch.int32))
        say(f"[kernels] lane_moments {tuple(shape)}: max relative err {rel:.2e} (limit 1e-5); "
            f"runs of {run} rows, slabs split at row {split} give the whole image's partials bit "
            f"for bit: {same}")
        if rel > 1e-5:
            raise RuntimeError("lane_moments differs from its plain version beyond 1e-5")
        if not same:
            raise RuntimeError("lane_moments on row slabs differs from the whole image")
    sync()

    # kernel 3 on the timelapse configuration's stack and on edge cases
    lapse = m.testing.synthetic_timelapse(n_wells, pre_size, pre_blobs, seed=0)
    lapse_f = torch.from_numpy(lapse).to(dev).to(torch.float32)
    rank_cases_run = rank_cases(m, lapse_f, rehearsal)
    max_err["rank_select"] = 0.0
    for name, x, window, ranks, mode, fn in rank_cases_run:
        got = m.rank_cuda.rank_select(x, window, ranks, mode) if fn is None else fn(x)
        want = m.rank_cuda.rank_select_plain(x, window, ranks, mode)
        differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        err = float((got - want).abs().nan_to_num(0.0).max())
        max_err["rank_select"] = max(max_err["rank_select"], err)
        say(f"[kernels] rank_select {name} {tuple(x.shape)} window {window} ({rank_branch(window)}) ranks "
            f"{tuple(ranks)} mode {mode}: {differ} values differ in any bit")
        if differ:
            raise RuntimeError(f"rank_select differs from its plain version on {name}")
    sync()
    say("[kernels] rank_select equals its plain version bit for bit (int32 views)")
    del rank_cases_run

    # -- 4. plate path --------------------------------------------------------------
    config = m.plate.PlateRunConfig(max_cells=1024, min_size=20)
    layout = m.pkg.MicroplateLayout([m.microplate.Well(id=f"A{k + 1:02d}") for k in range(n_wells)])
    source = {w.id: wells[k] for k, w in enumerate(layout)}
    runner = m.plate.PlateRunner(config, device=dev)
    reset_all_counts(m)
    t0 = time.perf_counter()
    results = runner.run(layout, source)
    sync()
    run_s = time.perf_counter() - t0
    plate_launches = all_counts(m)
    say(f"[plate] PlateRunner.run: {n_wells} wells in {run_s:.3f} s (first run, "
        f"includes staging and host tables); launches {plate_launches}")
    if results.failed_wells:
        raise RuntimeError(f"failed wells: {results.failed_wells}")
    if results.timings["capacity_retries"]:
        raise RuntimeError("a well needed a capacity retry")
    counts = [len(results.tables[w]) for w in layout.well_ids]
    say(f"[plate] cells per well: {counts}")
    lo, hi = (0.5 * blobs, 1.2 * blobs) if not rehearsal else (1, 2 * blobs)
    if not all(lo <= c <= hi for c in counts):
        raise RuntimeError(f"implausible cell counts {counts} for {blobs} blobs per well")
    frame = results.to_dataframe()
    numeric = frame.drop(columns=["well_id"]).to_numpy(float)
    if not np.isfinite(numeric).all():
        raise RuntimeError("non-finite values in the plate tables")
    if not rehearsal and not (plate_launches["local_cc"] > 0 and plate_launches["local_resweep"] > 0):
        raise RuntimeError(f"the plate path did not launch both CC kernels: {plate_launches}")

    program = m.plate._build_well_program(config, n_ch)
    packed, health = program(staged)
    packed, health = packed.cpu().numpy(), health.cpu().numpy()
    say(f"[plate] health (components, overflow, converged) per well: {health.tolist()}")
    if not ((health[:, 2] == 1).all() and (health[:, 1] == 0).all()
            and (health[:, 0] <= config.max_cells).all()):
        raise RuntimeError("a well is unconverged or over capacity")

    # well 0 on the card against the plain path on the CPU, stage by stage
    cpu_mask = m.fused.fused_classical_mask(torch.from_numpy(wells[:1, 0]))
    mask_disagree = float((cpu_mask != masks[:1].cpu()).float().mean())
    say(f"[check] well 0 mask: card vs CPU disagree on {mask_disagree:.2e} of pixels")
    if mask_disagree > 1e-4:
        raise RuntimeError("card and CPU masks disagree on more than 1e-4 of pixels")
    fg0 = masks[:1]
    roots_d, conv_d = m.labeling.component_roots(fg0, pair_cap=config.pair_cap)
    roots_c, conv_c = m.labeling.component_roots(fg0.cpu(), pair_cap=config.pair_cap)
    if not (torch.equal(roots_d.cpu(), roots_c) and torch.equal(conv_d.cpu(), conv_c)):
        raise RuntimeError("component roots on the card differ from the CPU")
    cap = m.plate.foreground_capacity(config, size, size)
    comp_d, comp_c = m.compaction.compact_by_root(roots_d, cap), m.compaction.compact_by_root(roots_c, cap)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(comp_d, comp_c)):
        raise RuntimeError("compaction on the card differs from the CPU")
    props_d, int_d = m.regionprops.measure_compacted(
        comp_d.seg, comp_d.idx, roots_d, staged[:1], config.max_cells, size
    )
    props_c, int_c = m.regionprops.measure_compacted(
        comp_c.seg, comp_c.idx, roots_c, torch.from_numpy(wells[:1]), config.max_cells, size
    )
    worst = compare_measurements(props_d, int_d, props_c, int_c)
    say(f"[check] well 0 roots/compaction/integer columns equal the CPU; worst float "
        f"relative difference {worst:.2e}")
    if worst > 1e-5:
        raise RuntimeError("float columns differ from the CPU beyond 1e-5 relative")
    del comp_d, comp_c, props_d, props_c, int_d, int_c, roots_d, roots_c

    # -- 5. segmentation path --------------------------------------------------------
    images = list(m.testing.synthetic_wells(n_wells, 1, seg_size, seg_size, seg_blobs, seed=1)[:, 0]
                  .astype(np.float64))
    model = m.pkg.SegmentationModel(checkpoint_path=m.weights.DEFAULT_WEIGHTS, device=dev)
    _ = model.network  # weights loaded before the counted run
    reset_all_counts(m)
    t0 = time.perf_counter()
    seg = model.batch_segment(images, show_progress=False)
    sync()
    seg_first_s = time.perf_counter() - t0
    seg_launches = all_counts(m)
    say(f"[segment] batch_segment: {n_wells} images of {seg_size}^2 in {seg_first_s:.3f} s "
        f"(first run); launches {seg_launches}")
    if any(s is None for s in seg):
        raise RuntimeError("batch_segment returned None for an image")
    cells = [int(s.max()) for s in seg]
    say(f"[segment] cells per image: {cells} ({seg_blobs} blobs per image)")
    if min(cells) <= 0:
        raise RuntimeError("an image has no cells")
    seg_kernels = ("local_cc", "local_resweep", "conv3x3_fused", "lane_moments", "diffuse",
                   "percentile_stretch", "unet_tail")
    if not rehearsal and min(seg_launches[k] for k in seg_kernels) <= 0:
        raise RuntimeError(f"the segmentation path did not launch every kernel: {seg_launches}")
    if model.stages.counts.get("segment.prepare.host"):
        raise RuntimeError("a scale-1 image took the host route")

    # the chunk's input as the call made it, against the numpy route; the
    # stretch kernel against its plain version bit for bit (NaN against NaN)
    seg_chunk = [model._staged(i, img, 1.0) for i, img in enumerate(images)]
    x_seg = model._prepared(seg_chunk, 1.0)
    prep = [model._prepare_image(img)[0] for img in images]
    same = np.array_equal(x_seg.cpu().numpy(), np.stack(prep))
    say(f"[check] the chunk's input stretched on the card equals _prepare_image's stacked: {same}")
    if not same:
        raise RuntimeError("the device route's input differs from _prepare_image's")
    rng_s = np.random.default_rng(19)
    ragged = [rng_s.normal(100, 10, size=(61, 49)),
              rng_s.integers(0, 4000, size=(2, 63, 63)).astype(np.uint16),
              rng_s.normal(size=(3, 49, 63)).astype(np.float32),
              np.where(rng_s.random((2, 50, 60)) < 0.01, np.nan, rng_s.normal(size=(2, 50, 60))),
              np.where(rng_s.random((3, 64, 64)) < 0.02, np.inf, rng_s.normal(size=(3, 64, 64))),
              np.where(rng_s.random((64, 64)) < 0.5, -0.0, 0.0), np.full((64, 40), 7.0)]
    ragged[4][1, :3] = -np.inf
    stretch_cases = {
        "the call's float64 images": ([model._upload(x) for x in images], seg_size, seg_size),
        "as uint16": ([model._upload(x.astype(np.uint16)) for x in images], seg_size, seg_size),
        "as float32": ([model._upload(x.astype(np.float32)) for x in images], seg_size, seg_size),
        "a ragged chunk": ([model._upload(x) for x in ragged], 64, 64),
    }
    for name, (srcs, hp, wp) in stretch_cases.items():
        got = m.stretch_cuda.percentile_stretch(srcs, hp, wp).cpu()
        want = m.stretch_cuda.percentile_stretch_plain([t.cpu() for t in srcs], hp, wp)
        nan = torch.isnan(want)
        exact = torch.equal(torch.isnan(got), nan) and torch.equal(
            got.masked_fill(nan, 0).view(torch.int32), want.masked_fill(nan, 0).view(torch.int32))
        err = float((got - want).abs().nan_to_num(0).max())
        max_err["percentile_stretch"] = max(max_err["percentile_stretch"], 0.0 if exact else err)
        say(f"[check] percentile_stretch on {name} {tuple(got.shape)}: bit-exact against the "
            f"plain version {exact}")
        if not exact:
            raise RuntimeError(f"percentile_stretch differs from its plain version on {name}")
    del stretch_cases, got, want

    # the run's intermediates: network output, the QC's labels and sources
    params = model._resolve_and_validate_parameters(None, None, None, None, None)
    with torch.inference_mode():
        out = model.network(x_seg)
        fl = out[..., :2] * 0.2
        active = out[..., 2] > 0
        landing = flows.follow_flows_indices(fl, active, 200)
        qc_lbl = m.labeling.relabel_sequential_filtered(
            flows.masks_from_landing(landing, active, min_size=0), model.min_size
        ).contiguous()
        qc_src = flows._centre_sources(qc_lbl, model.max_cells).contiguous()
        if not bool(torch.isfinite(out).all()) or tuple(out.shape) != (n_wells, seg_size, seg_size, 3):
            raise RuntimeError(f"network output not finite or of shape {tuple(out.shape)}")

        # kernel 6 bit-exact on the run's label images (cells straddle the
        # 112-pixel window seams), a ragged crop, and cases that drive each
        # branch: the cell pass, and the dense branch for labels whose box is
        # too large for it (a whole-image cell, a label split between far
        # corners) or that lie above its box table, which holds labels
        # 1..4096 of each image, or whose box padded by one pixel exceeds the
        # cell pass's 64 x 64 pixels
        g = torch.Generator(device=dev).manual_seed(500)
        full = (1, seg_size, seg_size)
        one = torch.ones(full, dtype=torch.int32, device=dev)
        one_src = torch.zeros(full, device=dev)
        one_src[0, seg_size // 3, seg_size // 2] = 1.0
        split = torch.zeros(full, dtype=torch.int32, device=dev)
        split[0, :40, :30] = 3
        split[0, -30:, -45:] = 3
        split[0, 500:530, 700:725] = 1
        above = qc_lbl[:1].clone()
        above[above > 0] += 4046  # labels 4047 and up: most above the table
        px1 = 96 if not rehearsal else 40
        singles = torch.arange(1, px1 * px1 + 1, dtype=torch.int32, device=dev).reshape(1, px1, px1)
        # 7 x 9 blocks that touch, on every image edge: one of 40 labels drawn
        # per block, so each label repeats across the image and its box takes
        # the dense branch; and one label per block, so every box fits a cell
        blocks = torch.randint(1, 41, (2, 37, 45), generator=g, device=dev, dtype=torch.int32)
        touch = blocks.repeat_interleave(7, 1).repeat_interleave(9, 2).contiguous()
        order = torch.randperm(37 * 45, generator=g, device=dev).to(torch.int32) + 1
        touch_tight = order.reshape(1, 37, 45).repeat_interleave(7, 1).repeat_interleave(9, 2)
        touch_tight = touch_tight.contiguous()
        edge = torch.zeros(full, dtype=torch.int32, device=dev)
        edge[0, 300:362, 400:462] = 1  # padded to 64 x 64 pixels, the capacity
        edge[0, 362:425, 462:524] = 2  # a row taller, touching label 1 at a corner

        def sparse_src(lb, p=0.02):
            return ((lb > 0) & (torch.rand(lb.shape, generator=g, device=dev) < p)).float()

        diff_cases = [
            ("main labels, 128 iterations", qc_lbl, qc_src, 128),
            ("main labels, 13 iterations (remainder pass of 5)", qc_lbl[:2], qc_src[:2], 13),
            ("ragged 1000x1504 crop", qc_lbl[:1, :1000, :1504].contiguous(),
             qc_src[:1, :1000, :1504].contiguous(), 128),
            ("main labels, 1 iteration", qc_lbl[:2], qc_src[:2], 1),
            (f"one label covering the whole {seg_size}^2 image", one, one_src, 128),
            ("a label split between two far corners", split, sparse_src(split, 0.05), 128),
            ("labels above the box table", above.contiguous(), qc_src[:1], 13),
            (f"{px1}^2 1-pixel labels", singles, sparse_src(singles, 0.5), 13),
            ("touching labels on the image edges", touch, sparse_src(touch), 128),
            ("touching labels, one per block", touch_tight, sparse_src(touch_tight), 13),
            ("boxes at the cell pass's capacity and a row above it", edge, sparse_src(edge, 0.05),
             128),
        ]
        launched = dict.fromkeys(flows_cuda.launch_counts, 0)
        for name, lb, sr, it in diff_cases:
            flows_cuda.reset_launch_counts()
            got = flows_cuda.diffuse(lb, sr, it)
            for k, v in flows_cuda.launch_counts.items():
                launched[k] += v
            found = dict(flows_cuda.branch_counts)
            want = flows_cuda.diffuse_plain(lb, sr, it)
            err = float((got - want).abs().max())
            max_err["diffuse"] = max(max_err["diffuse"], err)
            say(f"[kernels] diffuse {name} {tuple(lb.shape)}, {it} iterations: max abs err "
                f"{err:g}; launches {dict(flows_cuda.launch_counts)}; the box pass found {found}")
            if not torch.equal(got, want):
                raise RuntimeError(f"diffuse differs from its plain version on {name}")
            if lb is edge and not rehearsal and (found["cell_labels"], found["dense_labels"]) != (1, 1):
                raise RuntimeError(f"the capacity case took the wrong branches: {found}")
        say(f"[kernels] diffuse launches over these cases: {launched}")
        if not rehearsal and min(launched.values()) <= 0:
            raise RuntimeError("the diffusion cases did not launch both branches")
        say("[kernels] diffuse equals its plain version bit for bit")

        # one image on the card against the CPU plain path
        img = m.testing.synthetic_wells(1, 1, check_size, check_size, 20, seed=2)[0, 0].astype(np.float64)
        cpu_model = m.pkg.SegmentationModel(checkpoint_path=m.weights.DEFAULT_WEIGHTS, device="cpu")
        xi = torch.from_numpy(model._prepare_image(img)[0][None])
        out_card = model.network(xi.to(dev)).cpu()
        out_cpu = cpu_model.network(xi)
        scale = float(out_cpu.abs().max())
        d = (out_card - out_cpu).abs()
        say(f"[check] {check_size}^2 network output card vs CPU: mean abs {float(d.mean()):.4g}, "
            f"max abs {float(d.max()):.4g}, output scale {scale:.4g} (limits 0.006 and 0.05 of scale)")
        if float(d.mean()) > 0.006 * scale or float(d.max()) > 0.05 * scale:
            raise RuntimeError("network output on the card differs from the CPU beyond tolerance")
    lab_card, lab_cpu = model.segment(img), cpu_model.segment(img)
    agree = float((lab_card == lab_cpu).mean())
    say(f"[check] {check_size}^2 labels card vs CPU: {agree:.5f} of pixels agree; cells "
        f"{int(lab_card.max())} vs {int(lab_cpu.max())} (limits 0.99 and +-1)")
    if agree < 0.99 or abs(int(lab_card.max()) - int(lab_cpu.max())) > 1 or lab_cpu.max() <= 0:
        raise RuntimeError("labels on the card differ from the CPU beyond tolerance")

    # -- 6. preprocessing path -------------------------------------------------------
    tiles = m.testing.noise_tiles(n_wells, pre_size, seed=0)
    pipes = preprocessing_pipelines(m, dev)
    inputs = {"denoise": tiles, "local threshold": lapse}
    pre_out, pre_launches = {}, {}
    for name, pipe in pipes.items():
        reset_all_counts(m)
        t0 = time.perf_counter()
        pre_out[name] = pipe(inputs[name])
        sync()
        first_s = time.perf_counter() - t0
        pre_launches[name] = all_counts(m)
        res = pre_out[name]
        ops = ", ".join(op.func.__name__ for op in pipe.operations)
        say(f"[preprocess] {name}: Pipeline([{ops}], parallel=True) on {n_wells} frames of "
            f"{pre_size}^2 uint16 in {first_s:.3f} s (first run, from host memory); output "
            f"{res.dtype} {tuple(res.shape)}; launches {pre_launches[name]}")
        if res.shape != inputs[name].shape:
            raise RuntimeError(f"{name}: output shape {res.shape}")
    den = pre_out["denoise"]
    if den.dtype != np.float64 or not np.isfinite(den).all() or den.min() < 0:
        raise RuntimeError("denoise output is not finite, non-negative float64")
    lab = pre_out["local threshold"]
    cells = [int(f.max()) for f in lab]
    say(f"[preprocess] local threshold: labels per frame {cells} ({pre_blobs} blobs per "
        f"frame, some overlapping)")
    if lab.dtype != np.int32 or not all(pre_blobs // 3 <= c <= pre_blobs for c in cells):
        raise RuntimeError(f"implausible timelapse labels {lab.dtype} {cells}")
    if not rehearsal and pre_launches["local threshold"]["rank_select"] != n_wells:
        raise RuntimeError(f"the 21x21 median did not launch the rank kernel once per frame: "
                           f"{pre_launches['local threshold']}")

    # frame 0 against the CPU path: the denoise chain is float (the Gaussian
    # convolutions sum in another order on the card); a median and a grey
    # opening are 1-Lipschitz in the max norm, so the output may differ by
    # at most twice the Gaussian stage's difference plus a few float32 ulps
    # at the data's magnitude (< 4096: ulp 4.9e-4)
    cpu_pipes = preprocessing_pipelines(m, "cpu")
    den_cpu = cpu_pipes["denoise"](tiles[:1])
    g_card = m.filters.gaussian_filter(torch.from_numpy(tiles[:1]).to(dev), 2.0).cpu()
    g_cpu = m.filters.gaussian_filter(torch.from_numpy(tiles[:1]), 2.0)
    g_err = float((g_card - g_cpu).abs().max())
    d_err = float(np.abs(den[:1] - den_cpu).max())
    limit = 2 * g_err + 4 * 4.9e-4
    say(f"[check] denoise frame 0 card vs CPU: max abs {d_err:.4g} (limit {limit:.4g} = twice "
        f"the Gaussian stage's {g_err:.4g} + 4 ulps at 4096)")
    if d_err > limit:
        raise RuntimeError("denoise on the card differs from the CPU beyond tolerance")
    # the timelapse chain is exact after the float32 cast (a median of
    # integers plus 150), so labels must be equal; on a crop, because the
    # plain 21x21 selection takes ~30 s per 2048^2 frame on the host
    crop = lapse[:1, :pre_crop, :pre_crop]
    lab_card = pipes["local threshold"](crop)
    lab_cpu = cpu_pipes["local threshold"](crop)
    say(f"[check] local threshold {pre_crop}^2 crop of frame 0 card vs CPU: "
        f"{int((lab_card != lab_cpu).sum())} labels differ; {int(lab_cpu.max())} cells")
    if not np.array_equal(lab_card, lab_cpu) or lab_cpu.max() <= 0:
        raise RuntimeError("timelapse labels on the card differ from the CPU")

    # -- 7. U-Net plate path ----------------------------------------------------------
    unet_config = m.plate.PlateRunConfig(method="unet", max_cells=1024)
    unet_runner = m.plate.PlateRunner(unet_config, device=dev, unet_params=m.weights.load_weights())
    reset_all_counts(m)
    t0 = time.perf_counter()
    unet_results = unet_runner.run(layout, source)
    sync()
    unet_run_s = time.perf_counter() - t0
    unet_launches = all_counts(m)
    say(f"[unet plate] PlateRunner.run(method='unet'): {n_wells} wells in {unet_run_s:.3f} s "
        f"(first run, includes staging and host tables); launches {unet_launches}")
    if unet_results.failed_wells or unet_results.timings["capacity_retries"]:
        raise RuntimeError(f"U-Net plate: failed wells {unet_results.failed_wells}, capacity "
                           f"retries {unet_results.timings['capacity_retries']}")
    unet_counts = [len(unet_results.tables[w]) for w in layout.well_ids]
    say(f"[unet plate] cells per well: {unet_counts} ({blobs} blobs per well)")
    if not all(lo <= c <= hi for c in unet_counts):
        raise RuntimeError(f"implausible U-Net cell counts {unet_counts} for {blobs} blobs per well")
    if not np.isfinite(unet_results.to_dataframe().drop(columns=["well_id"]).to_numpy(float)).all():
        raise RuntimeError("non-finite values in the U-Net plate tables")
    unet_kernels = ("conv3x3_fused", "lane_moments", "diffuse", "unet_tail")
    if not rehearsal and min(unet_launches[k] for k in unet_kernels) <= 0:
        raise RuntimeError(f"the U-Net plate path did not launch kernels 4-6 and 9: {unet_launches}")

    # well 0 stage by stage: the stretch, then the card's network output through
    # the compact tail on the card and on the CPU, then the measurement
    net_u = unet_runner.network
    cap_u = m.plate.foreground_capacity(unet_config, size, size)
    tail_kw = dict(cellprob_threshold=unet_config.cellprob_threshold,
                   flow_threshold=unet_config.flow_threshold, niter=unet_config.niter,
                   max_cells=unet_config.max_cells, min_size=unet_config.min_size,
                   clear_border_labels=unet_config.remove_edge_cells)
    stack_u = staged.to(torch.float32)
    seg_u = stack_u[:, unet_config.seg_channel_index].contiguous()
    with torch.inference_mode():
        xn_u = m.plate._normalised(seg_u)
        if not torch.equal(xn_u[:1].cpu(), m.plate._normalised(seg_u[:1].cpu())):
            raise RuntimeError("the U-Net input stretch on the card differs from the CPU")
        out_u = net_u(xn_u[..., None].expand(-1, -1, -1, 3))
        if not bool(torch.isfinite(out_u).all()):
            raise RuntimeError("non-finite U-Net plate network output")
        cm_u = flows.compute_masks_sparse_compact(out_u, cap_u, **tail_kw)
        cm_cpu = flows.compute_masks_sparse_compact(out_u[:1].cpu(), cap_u, **tail_kw)
        for name, a, b in zip(cm_u._fields, cm_u, cm_cpu):
            if not torch.equal(a[:1].cpu(), b):
                raise RuntimeError(f"compact tail {name} of well 0 differs between the card and the CPU")
        props_d, int_d = m.plate.measure_unet_masks(cm_u.labels[:1], cm_u.lab_c[:1], cm_u.idx[:1],
                                                    cm_u.valid[:1], stack_u[:1], unet_config.max_cells)
        props_c, int_c = m.plate.measure_unet_masks(*cm_cpu[:4], stack_u[:1].cpu(),
                                                    unet_config.max_cells)
        worst = compare_measurements(props_d, int_d, props_c, int_c)
        say(f"[check] U-Net well 0: stretch equal, compact tail (labels, lab_c, idx, valid, ok) "
            f"equal bit for bit between the card and the CPU ({int(cm_cpu.labels.max())} cells, ok "
            f"{bool(cm_cpu.ok[0])}); table integer columns equal, worst float relative difference "
            f"{worst:.2e}")
        if worst > 1e-5:
            raise RuntimeError("U-Net well 0 float columns differ from the CPU beyond 1e-5 relative")
        del props_d, props_c, int_d, int_c, cm_cpu

        # the compact tail against the dense route on the same network output
        dense_u = flows.compute_masks(out_u, flow_threshold=unet_config.flow_threshold,
                                      niter=unet_config.niter, max_cells=unet_config.max_cells,
                                      min_size=unet_config.min_size)
        oks = cm_u.ok.tolist()
        same = [bool(torch.equal(a, b)) for a, b, ok in zip(cm_u.labels, dense_u, oks) if ok]
        say(f"[check] U-Net plate compact tail vs dense compute_masks on the same outputs: "
            f"{sum(same)} of {sum(oks)} wells with ok equal bit for bit ({len(oks) - sum(oks)} "
            f"over capacity)")
        if not all(same) or not any(oks):
            raise RuntimeError("the compact tail and the dense compute_masks disagree")
        del dense_u

        # the float32 forward on the card (the kernels' plain versions) against the CPU
        f32_nets = []
        for d in (dev, "cpu"):
            net32 = m.unet.UNet(m.unet.UNetConfig(compute_dtype=torch.float32),
                                generator=torch.Generator())
            net32.load_state_dict(m.weights.load_weights())
            f32_nets.append(net32.to(d).eval())
        reset_all_counts(m)
        out32_card = f32_nets[0](xi.to(dev)).cpu()
        f32_launches = all_counts(m)
        out32_cpu = f32_nets[1](xi)
        scale = float(out32_cpu.abs().max())
        d32 = float((out32_card - out32_cpu).abs().max())
        say(f"[check] {check_size}^2 float32 forward card vs CPU: max abs {d32:.3g}, output scale "
            f"{scale:.4g} (limit 1e-3 of scale); kernel launches {f32_launches}")
        if d32 > 1e-3 * scale or any(f32_launches[k] for k in ("conv3x3_fused", "lane_moments",
                                                                "unet_tail")):
            raise RuntimeError("the float32 forward on the card differs from the CPU or launched "
                               "a bfloat16 kernel")
        del f32_nets, out32_card, out32_cpu

    # -- 8. decode-inclusive plate and the real ND2 fixtures ------------------------------
    sys.path.insert(0, str(REPO / "tests"))
    from nd2_builder import write_nd2

    nd2_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_nd2_"))
    cleanup.callback(shutil.rmtree, nd2_dir, ignore_errors=True)
    decode_rows, nd2_results = {}, {}
    t0 = time.perf_counter()
    nd2_paths = {w: write_nd2(nd2_dir / f"{w}.nd2", wells[k], channel_names=ND2_CHANNELS)
                 for k, w in enumerate(layout.well_ids)}
    mb = sum(p.stat().st_size for p in nd2_paths.values()) / 2**20
    say(f"[decode] wrote {n_wells} ND2 files of {n_ch}x{size}x{size} uint16 ({mb:.1f} MiB) in "
        f"{time.perf_counter() - t0:.1f} s; native planarize library "
        f"{'built' if m._native.available() else 'missing: the numpy transpose runs'}")
    if not np.array_equal(m.nikon.load_nd2(nd2_paths["A01"])[0], wells[0]):
        raise RuntimeError("an ND2 file does not decode to the pixels written")

    def from_nd2(well_id):
        return m.nikon.load_nd2(nd2_paths[well_id])[0]

    for name, runner_x, want in (("classical", runner, counts), ("unet", unet_runner, unet_counts)):
        runner_x.run(layout, from_nd2)  # warm
        t0 = time.perf_counter()
        runner_x.run(layout, source)  # the same wells from host arrays, for the difference
        sync()
        host_wall = time.perf_counter() - t0
        before = dict(m.nd2.planarize_counts)
        t0 = time.perf_counter()
        res = runner_x.run(layout, from_nd2)
        sync()
        wall = time.perf_counter() - t0
        got = [len(res.tables[w]) for w in layout.well_ids]
        route = {k: m.nd2.planarize_counts[k] - before[k] for k in before}
        decode_ms = res.timings["decode_s"] / res.timings["decode_wells"] * 1e3
        decode_cpu_ms = res.timings["decode_cpu_s"] / res.timings["decode_wells"] * 1e3
        decode_rows[name] = (n_wells / wall, decode_ms, decode_cpu_ms, n_wells / host_wall)
        nd2_results[name] = res
        say(f"[decode] {name}: PlateRunner.run from ND2 files, {n_wells} wells in {wall:.3f} s, "
            f"{n_wells / wall:.3f} wells/s including decode (second run; one batch of "
            f"{n_wells}, decoded by one prefetch worker); decode {decode_ms:.2f} ms per well "
            f"wall, {decode_cpu_ms:.2f} ms thread CPU; the runner's main thread "
            + ", ".join(f"{k} {res.timings[k] * 1e3:.1f} ms" for k in m.plate._RUN_SPANS.values())
            + "; from host arrays "
            f"{host_wall:.3f} s, {n_wells / host_wall:.3f} wells/s; planarize per frame "
            f"{route}; cells per well {got}")
        if res.failed_wells or got != want:
            raise RuntimeError(f"{name} from ND2 files: failed {res.failed_wells}, cells {got} "
                               f"against {want} from the staged arrays")

    # the five real fixtures through the port's reader, segmented on the card
    # against the pinned golden U-Net masks, with the JAX package's gate
    for name in GOLDEN_FIXTURES:
        image = m.microscopy.MicroscopyImage.from_nd2_path(DATA / f"{name}.nd2")
        frame = np.asarray(image.get_channel_intensities(image.channels[0]))
        while frame.ndim > 2:
            frame = frame[frame.shape[0] // 2]  # middle frame / plane
        got = model.segment(frame.astype(np.float64), cell_diameter_px=FIXTURE_DIAMETERS.get(name))
        golden = np.load(DATA / "golden_masks" / f"{name}.npz")["unet"]
        miou, frac = greedy_instance_iou(golden, got)
        say(f"[golden] {name} {frame.shape}: {int(got.max())} cells against {int(golden.max())} "
            f"pinned; matched {frac:.3f} (gate 0.8), matched IoU {miou:.3f} (gate 0.85)")
        if frac < 0.8 or miou < 0.85:
            raise RuntimeError(f"the U-Net golden gate fails on {name}")

    # -- 9. per-cell analysis and overlays of one well ------------------------------------
    # the cell segmentation example's classical path on well 0: percentile
    # rescale and Otsu on channel 0, then SegmentationMask with the four
    # channels; the fluorescence example's overlays on the same well
    from arcadia_microscopy_tools_tpu_torch.core.channels import CY5, DAPI, FITC, TRITC

    cell_channels = [DAPI, FITC, TRITC, CY5]
    well0 = wells[0]
    norm0 = m.operations.rescale_by_percentile(well0[0], (1, 99), device=dev)
    cell_mask = m.operations.apply_threshold((norm0 * 65535).astype(np.uint16), "otsu", device=dev)
    cell_planes = dict(zip(cell_channels, well0))
    all_names = list(m.masks.SUPPORTED_PROPERTY_NAMES)

    def cell_tables(device) -> tuple:
        default = m.masks.SegmentationMask(cell_mask, cell_planes, device=device)
        every = m.masks.SegmentationMask(cell_mask, cell_planes, property_names=all_names,
                                         device=device)
        _ = default.cell_properties, every.cell_properties, every.cell_outlines
        return default, every, every.filter("area", min_value=60)

    reset_all_counts(m)
    t0 = time.perf_counter()
    card_cells = cell_tables(dev)
    sync()
    cell_s = time.perf_counter() - t0
    cell_launches = all_counts(m)
    n_cells = card_cells[0].num_cells
    say(f"[cells] SegmentationMask of well 0 ({size}^2, 4 channels, mask foreground "
        f"{float(cell_mask.mean()):.4f}): {n_cells} cells, {card_cells[2].num_cells} with area "
        f">= 60; default table, all {len(all_names)} columns, outlines and filter in "
        f"{cell_s:.3f} s (first call); launches {cell_launches}")
    if not rehearsal and not (cell_launches["local_cc"] >= 1 and cell_launches["local_resweep"] >= 1):
        raise RuntimeError(f"SegmentationMask did not launch both CC kernels: {cell_launches}")
    if not lo <= n_cells <= hi:
        raise RuntimeError(f"implausible cell count {n_cells} for {blobs} blobs")
    default_table = card_cells[0].cell_properties
    if not all(len(v) == n_cells and np.isfinite(v).all() for v in default_table.values()):
        raise RuntimeError("the default per-cell table has a column of another length or "
                           "non-finite values")
    cpu_cells = cell_tables("cpu")
    worst = max(compare_cell_tables(a, b) for a, b in zip(card_cells, cpu_cells))
    outlines_d, outlines_c = card_cells[1].cell_outlines, cpu_cells[1].cell_outlines
    if len(outlines_d) != len(outlines_c) or not all(
        np.array_equal(a, b) for a, b in zip(outlines_d, outlines_c)
    ):
        raise RuntimeError("cell outlines on the card differ from the CPU")
    say(f"[check] per-cell tables of well 0 (default, all columns, filtered) on the card "
        f"against the CPU: label images, integer and host columns and outlines equal; worst "
        f"float relative difference {worst:.2e}")

    norm = [m.operations.rescale_by_percentile(p, (1, 99.5), device=dev) for p in well0]
    ov_d, ov_c = overlays(m, norm, cell_channels, dev), overlays(m, norm, cell_channels, "cpu")
    ov_err = max(float(np.abs(a - b).max()) for a, b in zip(ov_d, ov_c))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        bright = m.blending.Layer(FITC, torch.from_numpy(norm[1]).to(dev) * 2.0)
        on_dev = m.blending.create_overlay(torch.from_numpy(norm[0]).to(dev) * 1.5 - 0.1, [bright])
    warned = [str(w.message).split(" (min")[0] for w in caught]
    say(f"[check] overlays of well 0 (overlay_channels additive, 3 channels; create_overlay, 3 "
        f"layers of mixed modes) on the card against the CPU: max abs difference {ov_err:.2e} "
        f"(limit 1e-6); out-of-range inputs on the card warned {warned}")
    if ov_err > 1e-6:
        raise RuntimeError("overlays on the card differ from the CPU beyond 1e-6")
    if sorted(warned) != ["Background has values outside [0, 1]",
                          "Layer 'FITC' has intensity values outside [0, 1]"]:
        raise RuntimeError(f"the overlay's out-of-range warnings did not fire: {warned}")
    if on_dev.device.type != dev.type or not bool(((on_dev >= 0) & (on_dev <= 1)).all()):
        raise RuntimeError("a tensor background's overlay left its device or [0, 1]")
    del cpu_cells, ov_d, ov_c, on_dev

    # -- 10. LIF plate ---------------------------------------------------------------------
    # the 8 wells as the 8 images of one Leica LIF container (tests/lif_builder.py), read
    # through the port's load_lif_image by both plate methods
    from lif_builder import LifBuilder

    lif_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_lif_"))
    lif_time = {}
    try:
        lif_plate = lif_dir / "plate.lif"
        t0 = time.perf_counter()
        builder = LifBuilder()
        pitch = [(1, size, size * 0.325e-6, "m"), (2, size, size * 0.325e-6, "m")]
        detectors = [{"DetectorName": f"HyD S {k % 2 + 1}", "BeamRoute": "10;0"} for k in range(n_ch)]
        for k, w in enumerate(layout.well_ids):
            builder.add_image(w, wells[k], dims=pitch, channel_properties=detectors)
        builder.write(lif_plate)
        del builder
        say(f"[lif] wrote {n_wells} wells of {n_ch}x{size}x{size} uint16 as the images of one LIF "
            f"container ({lif_plate.stat().st_size / 2**20:.1f} MiB) in {time.perf_counter() - t0:.1f} s")
        m.lif.clear_container_cache()
        t0 = time.perf_counter()
        names = m.leica.list_image_names(lif_plate)
        open_ms = (time.perf_counter() - t0) * 1e3
        pixels0, meta0 = m.leica.load_lif_image(lif_plate, layout.well_ids[0])
        inferred = [(c.channel.name, c.channel.excitation_nm) for c in meta0.channel_metadata_list]
        say(f"[lif] list_image_names {names} ({open_ms:.1f} ms: the container's first read and "
            f"parse, cached after); well 0 sizes {meta0.sizes}, channels inferred {inferred}")
        if names != list(layout.well_ids) or not np.array_equal(pixels0, wells[0]):
            raise RuntimeError("the LIF container does not list the wells or decode to the pixels written")
        if meta0.sizes != {"C": n_ch, "Y": size, "X": size} or inferred != [("WLL", 488.0)] * n_ch:
            raise RuntimeError(f"LIF well 0: sizes {meta0.sizes}, channels {inferred}")
        del pixels0

        def from_lif(well_id):
            return m.leica.load_lif_image(lif_plate, well_id)[0]

        lif_kernels = {"classical": ("local_cc", "local_resweep"),
                       "unet": ("conv3x3_fused", "lane_moments", "diffuse")}
        for name, runner_x, want in (("classical", runner, results), ("unet", unet_runner, unet_results)):
            runner_x.run(layout, from_lif)  # warm
            reset_all_counts(m)
            t0 = time.perf_counter()
            res = runner_x.run(layout, from_lif)
            sync()
            wall = time.perf_counter() - t0
            lif_launches = all_counts(m)
            decode_ms = res.timings["decode_s"] / res.timings["decode_wells"] * 1e3
            decode_cpu_ms = res.timings["decode_cpu_s"] / res.timings["decode_wells"] * 1e3
            exact, worst, where = compare_plate_tables(res, want, layout.well_ids)
            lif_time[name] = [round(n_wells / wall, 3), round(decode_ms, 3), round(decode_cpu_ms, 3)]
            nd2_row = [round(v, 3) for v in decode_rows[name][:3]]
            say(f"[lif] {name}: PlateRunner.run from the LIF container, {n_wells} wells in {wall:.3f} "
                f"s, {n_wells / wall:.3f} wells/s including decode (second run, one prefetch worker); "
                f"decode {decode_ms:.2f} ms per well wall, {decode_cpu_ms:.2f} ms thread CPU (ND2, "
                f"phase 8: wells/s, decode ms wall, thread CPU {nd2_row}); launches {lif_launches}; "
                f"tables against phase {4 if name == 'classical' else 7}'s from host arrays: bit for "
                f"bit {exact} (required: the measurement's sums are exact), worst float relative "
                f"difference {worst:.2e} ({where or 'none'})")
            if worst > 1e-5 or not exact:
                raise RuntimeError(f"{name} tables from the LIF container differ from the runs from "
                                   f"host arrays (bit for bit {exact}, worst {worst:.2e})")
            if not rehearsal and min(lif_launches[k] for k in lif_kernels[name]) <= 0:
                raise RuntimeError(f"the LIF {name} plate did not launch its kernels: {lif_launches}")

        # -- 11. LIF timelapse ----------------------------------------------------------------
        # the local-threshold cell's 8 frames as one (T, Y, X) image, through
        # MicroscopyImage.from_lif_path, device_intensities() and phase 6's pipeline
        lapse_lif = lif_dir / "timelapse.lif"
        builder = LifBuilder()
        builder.add_image("timelapse", lapse[None], dims=[
            (1, pre_size, pre_size * 0.325e-6, "m"), (2, pre_size, pre_size * 0.325e-6, "m"),
            (4, n_wells, n_wells * 0.5, "s")],
            channel_properties=[{"DetectorName": "HyD S 1", "BeamRoute": "10;0"}])
        builder.write(lapse_lif)
        del builder
        t0 = time.perf_counter()
        stack_image = m.microscopy.MicroscopyImage.from_lif_path(lapse_lif, "timelapse")
        open_ms = (time.perf_counter() - t0) * 1e3
        ch0 = stack_image.channels[0]
        reset_all_counts(m)
        t0 = time.perf_counter()
        on_card = stack_image.device_intensities("cpu" if rehearsal else None)
        sync()
        upload_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        lab_lif = pipes["local threshold"](on_card)
        sync()
        pipe_ms = (time.perf_counter() - t0) * 1e3
        lapse_launches = all_counts(m)
        lab_lif = lab_lif.cpu().numpy()
        lif_time["timelapse ms: from_lif_path, upload, pipeline"] = [
            round(open_ms, 3), round(upload_ms, 3), round(pipe_ms, 3)]
        say(f"[lif] timelapse: from_lif_path {open_ms:.2f} ms (container read, parse and decode of "
            f"{n_wells}x{pre_size}^2 uint16), sizes {stack_image.sizes}, channel {ch0.name} "
            f"excitation {ch0.excitation_nm} nm, T step "
            f"{stack_image.metadata.instrument.channel_metadata_list[0].resolution.t_step_ms} ms; "
            f"device_intensities() {upload_ms:.2f} ms on {on_card.device}; the local-threshold "
            f"Pipeline on it {pipe_ms:.2f} ms (first call on this tensor); launches {lapse_launches}; "
            f"labels equal to phase 6's from host memory: {np.array_equal(lab_lif, lab)}")
        if stack_image.sizes != {"T": n_wells, "Y": pre_size, "X": pre_size} or (
                ch0.name, ch0.excitation_nm) != ("WLL", 488.0):
            raise RuntimeError(f"LIF timelapse: sizes {stack_image.sizes}, channel {ch0}")
        if not np.array_equal(stack_image.intensities, lapse) or not np.array_equal(lab_lif, lab):
            raise RuntimeError("the LIF timelapse's pixels or labels differ from the host stack's")
        if not rehearsal and (lapse_launches["rank_select"] != n_wells or min(
                lapse_launches["local_cc"], lapse_launches["local_resweep"]) <= 0):
            raise RuntimeError(f"the LIF timelapse did not launch the rank kernel once per frame "
                               f"and the CC kernels: {lapse_launches}")
        del stack_image, on_card

        # -- 12. training ---------------------------------------------------------------------
        # one step from the trained weights on the card and on the CPU; then
        # train() at the JAX defaults (UNetConfig(), bf16, batch 8, 128^2) on the card
        t_batch, t_size, t_steps = (8, 128, 10) if not rehearsal else (2, 64, 2)
        images_t, labels_t = m.train.make_batch(np.random.default_rng(7), t_batch, t_size)
        stepped = []
        for d in (dev, torch.device("cpu")):
            net_t = m.unet.UNet(m.unet.UNetConfig(), generator=torch.Generator())
            net_t.load_state_dict(m.weights.load_weights())
            net_t = net_t.to(d)
            flow_t, fg_t = m.train._flow_targets(torch.from_numpy(labels_t).to(d))
            got = m.train.train_step(net_t, m.train.make_optimizer(net_t), 3e-4,
                                     torch.from_numpy(images_t).to(d), flow_t, fg_t.float())
            stepped.append(([float(v) for v in got], flow_t.cpu(), fg_t.cpu(),
                            {k: p.grad.float().cpu() for k, p in net_t.named_parameters()}))
            del net_t
        (l_d, fl_d, fg_d, g_d), (l_c, fl_c, fg_c, g_c) = stepped
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_d, l_c))
        flow_err = float((fl_d - fl_c).abs().max())
        min_cos = min(float(torch.nn.functional.cosine_similarity(g_d[k].flatten(), g_c[k].flatten(),
                                                                  dim=0)) for k in g_c)
        say(f"[train] one step from the trained weights, batch {t_batch} of {t_size}^2: loss, flow "
            f"MSE, BCE on {dev} {[round(v, 6) for v in l_d]}, on the CPU "
            f"{[round(v, 6) for v in l_c]}: worst relative difference {loss_rel:.2e} (limit 1e-2); "
            f"targets fg equal {torch.equal(fg_d, fg_c)}, flows max abs {flow_err:.2e} (limit 0.02); "
            f"least gradient cosine similarity over the leaves {min_cos:.5f} (limit 0.99)")
        if loss_rel > 1e-2 or not torch.equal(fg_d, fg_c) or flow_err > 0.02 or min_cos < 0.99:
            raise RuntimeError("the training step on the card differs from the CPU beyond tolerance")
        del stepped, g_d, g_c

        train_npz = lif_dir / "trained.npz"
        reset_all_counts(m)
        t0 = time.perf_counter()
        trained = m.train.train(steps=t_steps, batch=t_batch, size=t_size, seed=0, out=train_npz,
                                device=dev)
        sync()
        train_s = time.perf_counter() - t0
        train_launches = all_counts(m)
        losses = [r["loss"] for r in trained.history]
        if not all(math.isfinite(v) for r in trained.history for v in r.values()):
            raise RuntimeError(f"a training loss is not finite: {trained.history}")
        say(f"[train] train(steps={t_steps}, batch={t_batch}, size={t_size}) on {dev}: {train_s:.2f} "
            f"s, {train_s * 1e3 / t_steps:.3f} ms per step; losses {[round(v, 4) for v in losses]}; "
            f"launches {train_launches}")
        if not rehearsal and (train_launches["diffuse"] != t_steps or train_launches["conv3x3_fused"]
                              or train_launches["lane_moments"] or train_launches["unet_tail"]):
            raise RuntimeError(f"the trainer's kernel launches are not one diffusion per step and no "
                               f"bf16 forward kernel: {train_launches}")
        reloaded = m.weights.load_weights(train_npz)
        state = trained.network.state_dict()
        if reloaded.keys() != state.keys() or not all(
                torch.equal(reloaded[k], state[k].cpu()) for k in state):
            raise RuntimeError("the trained weights do not reload equal")
        img_t = m.testing.synthetic_wells(1, 1, check_size, check_size, 20, seed=3)[0, 0].astype(np.float64)
        seg_t = m.pkg.SegmentationModel(checkpoint_path=train_npz, device=dev)
        lab_t = seg_t.segment(img_t)
        say(f"[train] the written .npz reloads equal ({len(state)} leaves); SegmentationModel "
            f"segments a {check_size}^2 image with it on {seg_t.device}: {int(lab_t.max())} cells")
        if lab_t.shape != img_t.shape:
            raise RuntimeError(f"segmentation with the trained weights returned {lab_t.shape}")
        # the step's split, timed here with a synchronize after each phase
        # (train() itself runs asynchronously): t_steps more steps of the
        # trained network after its weights were checked, mean of steps 1 on
        split_opt, split_rng = m.train.make_optimizer(trained.network), np.random.default_rng(1)
        split = {"make_batch (host)": [], "targets": [], "forward + backward + Adam": []}
        for _ in range(t_steps):
            ta = time.perf_counter()
            im, lb = m.train.make_batch(split_rng, t_batch, t_size)
            tb = time.perf_counter()
            ft, fg = m.train._flow_targets(torch.from_numpy(lb).to(dev))
            sync()
            tc = time.perf_counter()
            m.train.train_step(trained.network, split_opt, 3e-4, torch.from_numpy(im).to(dev), ft,
                               fg.float())
            sync()
            td = time.perf_counter()
            for k, t in zip(split, (tb - ta, tc - tb, td - tc)):
                split[k].append(t * 1e3)
        train_time = {"train() step": round(train_s * 1e3 / t_steps, 3)}
        train_time.update({k: round(sum(v[1:] or v) / len(v[1:] or v), 3) for k, v in split.items()})
        say(f"[train] split of {t_steps} more steps, ms per step (mean of steps 1-{t_steps - 1}, "
            f"synchronized after each phase): {json.dumps(train_time)}")
        del trained, seg_t
    finally:
        shutil.rmtree(lif_dir, ignore_errors=True)
        m.lif.clear_container_cache()

    # -- 13. timing ------------------------------------------------------------------
    reps = 5 if not rehearsal else 1
    program_ms = time_host(lambda: program(staged), reps, sync)
    say(f"[time] plate device program: {program_ms:.2f} ms per batch of {n_wells} wells, "
        f"{n_wells * 1e3 / program_ms:.2f} wells/s (pre-staged, host clock + synchronize)")
    roots_b, _ = m.labeling.component_roots(masks, pair_cap=config.pair_cap)
    comp_b = m.compaction.compact_by_root(roots_b, cap)
    stages = {
        "mask": lambda: m.fused.fused_classical_mask(staged[:, 0]),
        "cc": lambda: m.labeling.component_roots(masks, pair_cap=config.pair_cap),
        "compaction": lambda: m.compaction.compact_by_root(roots_b, cap),
        "measure": lambda: m.regionprops.measure_compacted(
            comp_b.seg, comp_b.idx, roots_b, staged, config.max_cells, size
        ),
    }
    stage_ms = {k: round(time_host(fn, reps, sync), 3) for k, fn in stages.items()}
    say(f"[time] plate per-stage ms per batch of {n_wells}: {json.dumps(stage_ms)}")
    del comp_b

    seg_reps = 3 if not rehearsal else 1
    seg_ms = time_host(lambda: model.batch_segment(images, show_progress=False), seg_reps, sync)
    with torch.inference_mode():
        parts = {
            "prep (copies and stretch)": time_host(lambda: model._prepared(seg_chunk, 1.0),
                                                   seg_reps, sync),
            "numpy prep (_prepare_image, the zoom route)": time_host(
                lambda: [model._prepare_image(i) for i in images], seg_reps, sync),
            "forward": time_host(lambda: model.network(x_seg), seg_reps, sync),
            "compute_masks": time_host(lambda: flows.compute_masks(
                out, flow_threshold=float(params["flow_threshold"]), niter=200,
                max_cells=model.max_cells, min_size=model.min_size), seg_reps, sync),
            "qc diffusion": time_host(lambda: flows_cuda.diffuse(qc_lbl, qc_src, 128), seg_reps, sync),
        }
    say(f"[time] batch_segment: {seg_ms:.2f} ms per batch of {n_wells} {seg_size}^2 images, "
        f"{n_wells * 1e3 / seg_ms:.3f} images/s (host clock + synchronize, images from host memory)")
    say(f"[time] batch_segment parts, ms per batch: "
        f"{json.dumps({k: round(v, 3) for k, v in parts.items()})} (qc diffusion is inside "
        f"compute_masks)")

    # U-Net plate: the staged well program and its parts, beside the dense
    # route on the same network outputs
    program_u = m.plate._build_well_program(unet_config, n_ch, net_u)
    unet_ms = time_host(lambda: program_u(staged), seg_reps, sync)
    dense_kw = {k: v for k, v in tail_kw.items() if k != "clear_border_labels"}
    with torch.inference_mode():
        fl_u = out_u[..., :2] * 0.2
        core_u = flows._follow_sparse_core(fl_u, out_u[..., 2] > unet_config.cellprob_threshold,
                                           unet_config.niter, cap_u)
        qc_lbl_u = flows._finish_masks_compact(*core_u[:3], fl_u, size, size, 0.0,
                                               unet_config.max_cells, unet_config.min_size)[0]
        qc_lbl_u = qc_lbl_u.contiguous()
        qc_src_u = flows._centre_sources(qc_lbl_u, unet_config.max_cells).contiguous()
        uparts = {
            "stretch": time_host(lambda: m.plate._normalised(seg_u), seg_reps, sync),
            "forward": time_host(lambda: net_u(xn_u[..., None].expand(-1, -1, -1, 3)), seg_reps,
                                 sync),
            "compact tail": time_host(
                lambda: flows.compute_masks_sparse_compact(out_u, cap_u, **tail_kw), seg_reps, sync),
            "qc diffusion": time_host(lambda: flows_cuda.diffuse(qc_lbl_u, qc_src_u, 128), seg_reps,
                                      sync),
            "measure": time_host(lambda: m.plate.measure_unet_masks(
                cm_u.labels, cm_u.lab_c, cm_u.idx, cm_u.valid, stack_u, unet_config.max_cells),
                seg_reps, sync),
            "dense compute_masks": time_host(lambda: flows.compute_masks(out_u, **dense_kw),
                                             seg_reps, sync),
        }
    say(f"[time] U-Net plate device program: {unet_ms:.2f} ms per batch of {n_wells} {size}^2 "
        f"wells, {n_wells * 1e3 / unet_ms:.3f} wells/s (pre-staged, host clock + synchronize); "
        f"parts, ms per batch: {json.dumps({k: round(v, 3) for k, v in uparts.items()})} (the qc "
        f"diffusion is inside the compact tail; the dense compute_masks on the same outputs is "
        f"the route the compact tail replaces; QC foreground fraction "
        f"{float((qc_lbl_u > 0).float().mean()):.4f})")
    if decode_rows:
        say(f"[time] decode-inclusive wells/s, decode ms per well (wall, thread CPU), wells/s from "
            f"host arrays: {json.dumps({k: [round(v, 3) for v in r] for k, r in decode_rows.items()})}")
    say(f"[time] LIF: {json.dumps(lif_time)}; training ms per step: {json.dumps(train_time)}")

    # preprocessing: each configuration from host memory (NumPy in, NumPy
    # out, as users call it) and on the staged stack; ms per operation
    staged_pre = {name: torch.from_numpy(inputs[name]).to(dev) for name in pipes}
    for name, pipe in pipes.items():
        host_ms = time_host(lambda: pipe(inputs[name]), seg_reps, sync)
        dev_ms = time_host(lambda: pipe(staged_pre[name]), seg_reps, sync)
        frames = list(staged_pre[name])
        op_ms = {}
        for op in pipe.operations:
            ins = frames
            op_ms[op.func.__name__] = round(time_host(lambda: [op(x) for x in ins], seg_reps, sync), 3)
            frames = [op(x) for x in frames]
        say(f"[time] preprocess {name}: {host_ms:.2f} ms per batch of {n_wells} {pre_size}^2 "
            f"frames from host memory ({n_wells * 1e3 / host_ms:.3f} images/s); {dev_ms:.2f} ms "
            f"on the staged stack ({n_wells * 1e3 / dev_ms:.3f} images/s); ms per operation "
            f"over the batch: {json.dumps(op_ms)} (host clock + synchronize)")
        del frames

    # per-cell analysis: warm calls (phase 9 was the first), each stage ended
    # by a synchronize of the card; the default table's stages in order
    timer = m.profiling.StageTimer()
    fence = torch.empty(0, device=dev)  # `block=fence` synchronises the card
    cell_reps = 3 if not rehearsal else 1
    for _ in range(cell_reps):
        sm = m.masks.SegmentationMask(cell_mask, cell_planes, device=dev)
        with timer.stage("label", block=fence):
            sm._processed
        with timer.stage("device measurement", block=fence):
            sm._device_measurements
        with timer.stage("intensity stack", block=fence):
            sm._intensity_measurements
        with timer.stage("host columns", block=fence):
            sm.cell_properties
        with timer.stage("all columns", block=fence):
            m.masks.SegmentationMask(cell_mask, cell_planes, property_names=all_names,
                                     device=dev).cell_properties
        with timer.stage("overlays", block=fence):
            overlays(m, norm, cell_channels, dev)
    cell_ms = {k: round(v * 1e3 / cell_reps, 3) for k, v in timer.totals.items()}
    cell_ms["default table"] = round(sum(cell_ms[k] for k in (
        "label", "device measurement", "intensity stack", "host columns")), 3)
    say(f"[time] per-cell analysis of one {size}^2 4-channel well, {n_cells} cells: ms per "
        f"well {json.dumps(cell_ms)} (mean of {cell_reps} warm calls, host clock + synchronize; "
        f"'default table' is SegmentationMask + the default cell_properties, the sum of label, "
        f"device measurement, intensity stack and host columns; 'overlays' is overlay_channels "
        f"and create_overlay from host arrays); card: {smi}")

    if args.profile and not rehearsal:
        # one whole training step (host batch, targets, update) and one update
        # alone on a fixed batch, at phase 12's size, from the trained weights
        net_p = m.unet.UNet(m.unet.UNetConfig(), generator=torch.Generator())
        net_p.load_state_dict(m.weights.load_weights())
        net_p, rng_p = net_p.to(dev), np.random.default_rng(11)
        opt_p = m.train.make_optimizer(net_p)
        imgs_p, lbls_p = m.train.make_batch(rng_p, t_batch, t_size)
        flows_p, fg_p = m.train._flow_targets(torch.from_numpy(lbls_p).to(dev))
        imgs_p, fg_p = torch.from_numpy(imgs_p).to(dev), fg_p.float()

        def train_step_whole():
            with torch.inference_mode(False):
                im, lb = m.train.make_batch(rng_p, t_batch, t_size)
                ft, fg = m.train._flow_targets(torch.from_numpy(lb).to(dev))
                m.train.train_step(net_p, opt_p, 3e-4, torch.from_numpy(im).to(dev), ft, fg.float())

        def train_update():
            with torch.inference_mode(False):
                m.train.train_step(net_p, opt_p, 3e-4, imgs_p, flows_p, fg_p)

        with torch.inference_mode():
            profile_windows({
                "train step": train_step_whole,
                "train update": train_update,
                "per-cell cell_properties": lambda: m.masks.SegmentationMask(
                    cell_mask, cell_planes, device=dev).cell_properties,
                "forward": lambda: model.network(x_seg),
                "compute_masks": lambda: flows.compute_masks(
                    out, flow_threshold=float(params["flow_threshold"]), niter=200,
                    max_cells=model.max_cells, min_size=model.min_size),
                "preprocess denoise": lambda: pipes["denoise"](staged_pre["denoise"]),
                "preprocess local threshold": lambda: pipes["local threshold"](
                    staged_pre["local threshold"]),
                "unet plate program": lambda: program_u(staged),
                "unet compact tail": lambda: flows.compute_masks_sparse_compact(
                    out_u, cap_u, **tail_kw),
                "unet dense compute_masks": lambda: flows.compute_masks(out_u, **dense_kw),
            }, args.profile)

    kernels = []

    def entry(name, line_ref, launches, ms, plain_ms, bytes_ms, ops_ms, library_ms, source,
              bound_ms=None):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"{CSRC}/{source}",
            "replaces": f"arcadia_microscopy_tools_tpu/{line_ref}",
            "launches": launches,
            "max_abs_err": max_err[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms) if bound_ms is None else bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
        })

    def timed(kernel, plain, kreps=20):
        if rehearsal:
            t = time_host(plain, 1, sync)
            return t, t
        return time_cuda(kernel, reps=kreps), time_cuda(plain, reps=2, warmup=1)

    # CC kernels at the plate path's masks
    mask_b = masks
    seeds_b = m.labeling.resweep_seeds(mask_b, 2, config.pair_cap)
    px = mask_b.numel()
    ops_per_px_sweep = 9  # 8 neighbour minimums + 1 background select
    for name, line, kernel, plain, extra_in, init in (
        ("local_cc", 32, lambda: cc_cuda.local_cc(mask_b),
         lambda: cc_cuda.local_cc_plain(mask_b), 0, None),
        ("local_resweep", 69, lambda: cc_cuda.local_resweep(mask_b, seeds_b),
         lambda: cc_cuda.local_resweep_plain(mask_b, seeds_b), 4, seeds_b),
    ):
        sweeps = cc_cuda.tile_sweep_counts(mask_b, 2, init)
        ops = float(sweeps.sum()) * cc_cuda.CC_BLOCK**2 * ops_per_px_sweep
        bytes_ms = px * (1 + extra_in + 4) / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / NON_TENSOR_OPS_PER_S * 1e3
        ms, plain_ms = timed(kernel, plain)
        entry(name, f"ops/cc_pallas.py:{line}", seg_launches[name], ms, plain_ms, bytes_ms, ops_ms,
              None, "cc_local.cu")
        say(f"[time] {name}: {ms:.4f} ms at {tuple(mask_b.shape)}; plain {plain_ms:.4f} ms; "
            f"bound {max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, operations {ops_ms:.4f}: "
            f"{int(sweeps.sum())} tile sweeps, mean {float(sweeps.float().mean()):.1f}, max "
            f"{int(sweeps.max())}); launches: plate path {plate_launches[name]}, segmentation "
            f"path {seg_launches[name]}, per-cell path {cell_launches[name]}")

    # fused conv: the 16 calls of one forward, each timed at its shape
    tot, conv_ms = time_conv_calls(m, conv_calls, n_wells, dev, timed, rehearsal, say)
    say(f"[time] conv3x3_fused, all 16 calls of one forward: {tot['ms']:.3f} ms "
        f"({tot['bound'] / tot['ms']:.1%} of the bound); bound "
        f"{tot['bound']:.3f} ms (sum over calls of max(bytes {tot['bytes']:.3f}, operations "
        f"{tot['ops']:.3f})); plain {tot['plain']:.3f} ms; F.conv2d conv only {tot['lib']:.3f} ms")

    # GroupNorm moments at the forward's one call (the stem conv's output)
    xg = (torch.randn((n_wells, seg_size, seg_size, 32), device=dev)).to(torch.bfloat16)
    ms, plain_ms = timed(lambda: gn_cuda.lane_moments(xg), lambda: gn_cuda.lane_moments_plain(xg))
    b_ms = xg.numel() * 2 / HBM_BYTES_PER_S * 1e3
    o_ms = xg.numel() * 3 / NON_TENSOR_OPS_PER_S * 1e3
    say(f"[time] lane_moments {tuple(xg.shape)}: {ms:.4f} ms; bound {max(b_ms, o_ms):.4f} ms "
        f"(bytes); plain {plain_ms:.4f} ms")
    gn_row = ("lane_moments", "models/gn_pallas.py:66", seg_launches["lane_moments"], ms, plain_ms,
              b_ms, o_ms, None, "gn_moments.cu")
    del xg

    # percentile stretch at the segmentation call's chunk: 8 float64 images,
    # as batch_segment copies them. Bytes: each input byte read once and the
    # (N, Hp, Wp, 3) float32 batch written once; beside it the algorithm's
    # bytes, the input read four times (three histogram passes and the
    # stretch). Operations per value: three key and bin computations and the
    # stretch's subtract, divide and two compares, ~12
    srcs_t = [model._upload(x) for x in images]
    ms, plain_ms = timed(
        lambda: m.stretch_cuda.percentile_stretch(srcs_t, seg_size, seg_size),
        lambda: m.stretch_cuda.percentile_stretch_plain(srcs_t, seg_size, seg_size))
    in_bytes = sum(t.numel() * t.element_size() for t in srcs_t)
    out_bytes = n_wells * seg_size * seg_size * 3 * 4
    b_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    alg_ms = (4 * in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    o_ms = sum(t.numel() for t in srcs_t) * 12 / NON_TENSOR_OPS_PER_S * 1e3
    say(f"[time] percentile_stretch {n_wells} x {seg_size}^2 float64: {ms:.4f} ms; bound "
        f"{max(b_ms, o_ms):.4f} ms (bytes: input read once, output written once), "
        f"{max(b_ms, o_ms) / ms:.2%} of it reached; the algorithm's bytes {alg_ms:.4f} ms; "
        f"plain {plain_ms:.4f} ms; launches on the segmentation path "
        f"{seg_launches['percentile_stretch']}")
    stretch_row = ("percentile_stretch", "models/segmentation.py:278",
                   seg_launches["percentile_stretch"], ms, plain_ms, b_ms, o_ms, None,
                   "percentile_stretch.cu")
    del srcs_t

    # QC diffusion at the run's labels, 128 iterations. The work depends on
    # the data: 6 operations per foreground pixel and iteration (4 neighbour
    # adds, the scaling and the source add); bytes: every label read and every
    # T written once, and the source of foreground pixels only (background T
    # is 0 whatever its source). Beside it, as algorithm figures: 12 bytes
    # per pixel (every source read too) and the dense count, 6 operations per
    # pixel of the whole batch and iteration
    ms, plain_ms = timed(lambda: flows_cuda.diffuse(qc_lbl, qc_src, 128),
                         lambda: flows_cuda.diffuse_plain(qc_lbl, qc_src, 128), kreps=5)
    qc_fg = int((qc_lbl > 0).sum())
    b_ms = (qc_lbl.numel() * 8 + qc_fg * 4) / HBM_BYTES_PER_S * 1e3
    o_ms = qc_fg * 128 * 6 / NON_TENSOR_OPS_PER_S * 1e3
    all_src_ms = qc_lbl.numel() * 12 / HBM_BYTES_PER_S * 1e3
    dense_ms = qc_lbl.numel() * 128 * 6 / NON_TENSOR_OPS_PER_S * 1e3
    flows_cuda.reset_launch_counts()
    flows_cuda.diffuse(qc_lbl, qc_src, 128)
    found = dict(flows_cuda.branch_counts)
    say(f"[time] diffuse {tuple(qc_lbl.shape)} x 128 iterations: {ms:.4f} ms; bound "
        f"{max(b_ms, o_ms):.4f} ms ({'bytes' if b_ms >= o_ms else 'operations'}; bytes {b_ms:.4f}: "
        f"8 per pixel and 4 per foreground pixel; operations {o_ms:.4f}: 6 per foreground pixel "
        f"and iteration; foreground fraction {qc_fg / qc_lbl.numel():.4f}), "
        f"{max(b_ms, o_ms) / ms:.2%} of it reached; algorithm figures: every source read, 12 "
        f"bytes per pixel, {all_src_ms:.4f} ms; 6 operations per pixel of the whole batch "
        f"{dense_ms:.4f} ms; the box pass found {found}; plain {plain_ms:.3f} ms; launches on "
        f"the segmentation path: cell pass {seg_launches['diffuse']}, dense branch "
        f"{seg_launches['diffuse_dense']} ({flows_cuda.DIFFUSE_HALO} iterations each)")
    diffuse_row = ("diffuse", "models/flows_pallas.py:78", seg_launches["diffuse"], ms, plain_ms,
                   b_ms, o_ms, None, "diffuse.cu")

    # rank selection at the timelapse configuration's calls: 8 launches of
    # one 2048^2 frame, window 21, rank 220. The bound's operations are the
    # least work of a sliding selection: per pixel and rank, 2 x window
    # histogram updates (the row that leaves, the row that enters) and one
    # read of the selected key; per pixel, its share of ranking its tile's
    # keys once, E log2 E compares for the E keys staged for a tile of 32
    # columns and TH rows (the kernel's tile at this window: TH = 4 x
    # `slide_rows` of csrc/rank_select.cu). Its bytes: the padded input read
    # once, the output written once. An 8-bit radix select's count, 4 x
    # (window^2 + 256) per pixel and rank, is printed beside it
    win, rk = 21, (220,)
    frames_f = list(lapse_f[:, None])
    ms, plain_ms = timed(lambda: [m.rank_cuda.rank_select(x, win, rk) for x in frames_f],
                         lambda: [m.rank_cuda.rank_select_plain(x, win, rk) for x in frames_f],
                         kreps=3)
    batched_ms = ms if rehearsal else time_cuda(lambda: m.rank_cuda.rank_select(lapse_f, win, rk),
                                                reps=3)
    px_r = lapse_f.numel()
    b_ms = (n_wells * (pre_size + 2 * (win // 2)) ** 2 + px_r) * 4 / HBM_BYTES_PER_S * 1e3
    span_x = 32 + win - 1
    tile_h = 4 * ((4096 // span_x - (win - 1)) // 4)
    tile_keys = span_x * (tile_h + win - 1)
    sort_ops = tile_keys * math.log2(tile_keys) / (32 * tile_h)
    o_ms = ((2 * win + 1) * len(rk) + sort_ops) * px_r / NON_TENSOR_OPS_PER_S * 1e3
    radix_ms = 4 * (win * win + 256) * px_r * len(rk) / NON_TENSOR_OPS_PER_S * 1e3

    def kth_all():
        for x in frames_f:
            pad = m.filters._pad_last2(x[0], win // 2, win // 2, "reflect")
            views = pad.unfold(0, win, 1).unfold(1, win, 1).reshape(pre_size, pre_size, -1)
            torch.kthvalue(views, rk[0] + 1, dim=-1)

    lib_ms = plain_ms if rehearsal else time_cuda(kth_all, reps=1, warmup=1)
    rank_launches = pre_launches["local threshold"]["rank_select"]
    say(f"[time] rank_select {n_wells} x {pre_size}^2, window {win}, one launch per frame: "
        f"{ms:.4f} ms ({batched_ms:.4f} ms as one batched launch); bound {max(b_ms, o_ms):.4f} ms "
        f"(bytes {b_ms:.4f}; operations {o_ms:.4f}: {2 * win + 1} per pixel and rank and "
        f"{sort_ops:.1f} per pixel for ranking {tile_keys} keys of a 32 x {tile_h} tile), "
        f"{max(b_ms, o_ms) / ms:.2%} of it reached; an 8-bit radix select's count "
        f"{radix_ms:.4f} ms; kernel branch {rank_branch(win)}; plain {plain_ms:.3f} ms; "
        f"torch.kthvalue "
        f"over the unfolded windows, one call per frame, {lib_ms:.3f} ms; launches on the "
        f"timelapse path {rank_launches}")
    rank_row = ("rank_select", "ops/rank_pallas.py:67", rank_launches, ms, plain_ms, b_ms, o_ms,
                lib_ms, "rank_select.cu")
    del frames_f

    # the conv's bound is the sum over its calls of each call's max(bytes, operations)
    entry("conv3x3_fused", "models/conv_pallas.py:129", seg_launches["conv3x3_fused"], tot["ms"],
          tot["plain"], tot["bytes"], tot["ops"], tot["lib"], "conv3x3_fused.cu", tot["bound"])
    entry(*gn_row)
    entry(*diffuse_row)
    entry(*stretch_row)
    entry(*rank_row)

    # -- 14. mesh: exact sums, two ranks on one card, a one-rank NCCL group -----------------
    # the measurement twice on one well: the same bits (exact int64 sums; float
    # channels in a fixed order)
    roots_1, _ = m.labeling.component_roots(masks[:1], pair_cap=config.pair_cap)
    comp_1 = m.compaction.compact_by_root(roots_1, cap)
    lbl_1 = m.labeling.label(masks[0])
    cells_1 = int(lbl_1.max())
    runs = {
        "measure_compacted (uint16 channels)": lambda: m.regionprops.measure_compacted(
            comp_1.seg, comp_1.idx, roots_1, staged[:1], config.max_cells, size),
        "measure_compacted (float32 channels)": lambda: m.regionprops.measure_compacted(
            comp_1.seg, comp_1.idx, roots_1, staged[:1].float(), config.max_cells, size),
        "measure_labels": lambda: m.regionprops.measure_labels(lbl_1, cells_1),
        "measure_intensity_stack (uint16)": lambda: m.regionprops.measure_intensity_stack(
            lbl_1, staged[0], cells_1),
    }
    for name, fn in runs.items():
        same = tree_equal(fn(), fn())
        say(f"[mesh] {name} on well 0 ({cells_1} labels, {n_ch} channels) run twice: the same "
            f"bits {same}")
        if not same:
            raise RuntimeError(f"{name} gives other bits on a second run")
    del roots_1, comp_1, lbl_1

    # two ranks sharing the card, spawned, over gloo (NCCL refuses two ranks on
    # one device): the plate as phase 4 on (wells=2) and (space=2) meshes, the
    # U-Net plate as phase 7 on (wells=2), run_plate_multiprocess from phase 8's
    # ND2 files; each against the single-process results bit for bit
    unet_packed, unet_health = (t.cpu().numpy() for t in m.plate._build_well_program(
        unet_config, n_ch, unet_runner.network)(staged))
    # the classical configuration outside the fused histogram frontend: li
    # threshold and an opening, the staged mask, on one process
    staged_config = m.plate.PlateRunConfig(max_cells=1024, min_size=20, threshold_method="li",
                                           opening_radius=2)
    staged_packed, staged_health = (t.cpu().numpy() for t in m.plate._build_well_program(
        staged_config, n_ch)(staged))
    staged_results = m.plate.PlateRunner(staged_config, device=dev).run(layout, source)
    say(f"[mesh] staged classical (li, opening 2) on one process: cells per well "
        f"{[len(staged_results.tables[w]) for w in layout.well_ids]}")
    mesh_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    cleanup.callback(shutil.rmtree, mesh_dir, ignore_errors=True)
    np.save(mesh_dir / "wells.npy", wells)
    (mesh_dir / "spec.json").write_text(json.dumps({
        "well_ids": list(layout.well_ids),
        "classical": dataclasses.asdict(config),
        "unet": dataclasses.asdict(unet_config),
        "staged": dataclasses.asdict(staged_config),
        "nd2": {w: str(p) for w, p in nd2_paths.items()},
    }))
    t0 = time.perf_counter()
    ranks = spawn_ranks(2, mesh_dir, rehearsal, timeout=420)
    say(f"[mesh] two spawned ranks on the one card finished in {time.perf_counter() - t0:.1f} s "
        f"(start-up, kernel libraries reused, every run below)")
    # launches each rank's program must make: a count, or None for at least one
    cc = {"local_cc": None, "local_resweep": None}
    unet_kernels = {"conv3x3_fused": None, "lane_moments": None, "diffuse": None}
    wants = {"wells=2": (packed, health, results, cc),
             "space=2": (packed, health, results, cc),
             "unet wells=2": (unet_packed, unet_health, unet_results, unet_kernels),
             # one batch of 8 slabs: 16 conv calls, the stem's moments, and the QC
             # repeated on each rank of the space group
             "unet space=2": (unet_packed, unet_health, unet_results,
                              {"conv3x3_fused": 16, "lane_moments": 1, "diffuse": None}),
             "staged space=2": (staged_packed, staged_health, staged_results, cc)}
    mesh_rates = {}
    for name, (want_p, want_h, want_res, kernels_used) in wants.items():
        for r, got in enumerate(ranks):
            g = got[name]
            same_prog = np.array_equal(g["packed"], want_p) and np.array_equal(g["health"], want_h)
            exact, worst, _ = compare_plate_tables(SimpleNamespace(tables=g["tables"]), want_res,
                                                   layout.well_ids)
            say(f"[mesh] {name} rank {r} ({g['mesh']}): packed and health equal to the single "
                f"process's bit for bit {same_prog}; tables bit for bit {exact}; program launches "
                f"{g['program_launches']}; PlateRunner.run launches {g['run_launches']}; run "
                f"{g['wall']:.3f} s")
            if "exchange_ms" in g:
                say(f"[mesh] {name} rank {r}: ms per call {json.dumps(g['exchange_ms'])} on {smi}")
            if not (same_prog and exact):
                raise RuntimeError(f"{name} rank {r} differs from the single-process program")
            launched = all(
                g[run][k] >= 1 if want is None else g[run][k] == want
                for k, want in kernels_used.items()
                for run in (("program_launches", "run_launches") if want is not None
                            else ("run_launches",)))
            if not rehearsal and not launched:
                raise RuntimeError(f"{name} rank {r} did not launch {kernels_used}")
        mesh_rates[name] = round(n_wells / max(got[name]["wall"] for got in ranks), 3)
    for r, got in enumerate(ranks):
        g = got["run_plate_multiprocess"]
        exact, worst, _ = compare_plate_tables(SimpleNamespace(tables=g["tables"]),
                                               nd2_results["classical"], layout.well_ids)
        say(f"[mesh] run_plate_multiprocess from the ND2 files, rank {r}: decoded "
            f"{g['decode_wells']:.0f} wells, tables equal to phase 8's bit for bit {exact}, "
            f"launches {g['run_launches']}, {g['wall']:.3f} s")
        if not exact:
            raise RuntimeError(f"run_plate_multiprocess rank {r} differs from phase 8")
    mesh_rates["run_plate_multiprocess (ND2)"] = round(
        n_wells / max(got["run_plate_multiprocess"]["wall"] for got in ranks), 3)
    say(f"[mesh] wells/s of the two-rank runs, second run, slowest rank, decode included for ND2: "
        f"{json.dumps(mesh_rates)} on {smi}; both ranks share one card and talk over gloo "
        f"through host memory: a cost figure, not scaling")
    del ranks

    # a one-rank group with the default backend choice (NCCL for card tensors)
    import torch.distributed as dist

    from arcadia_microscopy_tools_tpu_torch.ops.stats import histogram_int
    from arcadia_microscopy_tools_tpu_torch.parallel import collectives, multiprocess

    multiprocess.initialize_distributed(f"file://{mesh_dir / 'one_rank'}", 1, 0)
    try:
        group = dist.group.WORLD
        frame = staged[0, 0]
        x = frame.to(torch.float32)
        rows = torch.arange(-64, size + 64, device=dev).clamp(0, size - 1)
        halo_ok = torch.equal(collectives.halo_exchange(x, 64, group), x[rows])
        hist_ok = torch.equal(collectives.sharded_histogram_uint16(frame, group),
                              histogram_int(frame, 65536)[0])
        otsu_ok = torch.equal(collectives.sharded_otsu_threshold(frame, group),
                              m.threshold.threshold_otsu(frame))
        from arcadia_microscopy_tools_tpu_torch.parallel import mesh as pmesh

        make_ok = torch.equal(collectives.make_sharded_otsu(pmesh.create_mesh())(frame),
                              m.threshold.threshold_otsu(frame))
        say(f"[mesh] one-rank group, backend {dist.get_backend()}, on {x.device} tensors: "
            f"halo_exchange (64 rows) equal to edge padding {halo_ok}, sharded_histogram_uint16 "
            f"equal to the histogram {hist_ok}, sharded_otsu_threshold equal to threshold_otsu "
            f"{otsu_ok}, make_sharded_otsu(create_mesh()) equal to threshold_otsu {make_ok}")
        if not (halo_ok and hist_ok and otsu_ok and make_ok):
            raise RuntimeError("a collective on the one-rank group differs from its single-device "
                               "counterpart")
    finally:
        dist.destroy_process_group()

    # -- 15. S2D U-Net ------------------------------------------------------------------
    # (a) the 8 wells through the JAX plate's U-Net branch as it composes the S2D
    # route: the stretch, UNetS2D(s2d_params(tree, gray_input=True))(x[..., None],
    # out_s2d=True), compute_masks_sparse_compact_s2d and the measurement
    s2d = m.unet_s2d
    tree_s = m.weights.tree_from_state_dict(m.weights.load_weights())
    net_s = s2d.UNetS2D(s2d.s2d_params(tree_s, gray_input=True)).to(dev).eval()
    seg_i = unet_config.seg_channel_index

    def s2d_route(stack_f):
        """The U-Net plate's stretch, S2D forward, S2D compact tail and
        measurement on a staged float32 batch: (stretched input, network
        output, compact masks, measurement)."""
        xn = m.plate._normalised(stack_f[:, seg_i].contiguous())
        out = net_s(xn[..., None], out_s2d=True)
        cm = flows.compute_masks_sparse_compact_s2d(out, cap_u, **tail_kw)
        meas = m.plate.measure_unet_masks(cm.labels, cm.lab_c, cm.idx, cm.valid, stack_f,
                                          unet_config.max_cells)
        return xn, out, cm, meas

    with torch.inference_mode():
        reset_all_counts(m)
        xn_s, out_s, cm_s, _ = s2d_route(stack_u)
        sync()
        s2d_launches = all_counts(m)
        s2d_cells = [int(c) for c in cm_s.lab_c.amax(1)]
        say(f"[s2d] the U-Net plate's S2D route on {n_wells} wells of {size}^2 (stretch, "
            f"UNetS2D gray input, out_s2d, compute_masks_sparse_compact_s2d, measure_unet_masks): "
            f"launches {s2d_launches}; cells per well {s2d_cells}; ok {cm_s.ok.tolist()}")
        if tuple(out_s.shape) != (n_wells, size // 2, size // 2, 12) or not bool(
                torch.isfinite(out_s).all()):
            raise RuntimeError(f"S2D head output not finite or of shape {tuple(out_s.shape)}")
        if not rehearsal and (s2d_launches["conv3x3_fused"] != 13 or s2d_launches["lane_moments"] != 2
                              or s2d_launches["diffuse"] < 1):
            raise RuntimeError(f"the S2D route did not launch 13 conv, 2 moments and >= 1 "
                               f"diffusion kernels: {s2d_launches}")
        if not bool(cm_s.ok.all()) or not all(lo <= c <= hi for c in s2d_cells):
            raise RuntimeError(f"S2D route: ok {cm_s.ok.tolist()}, implausible cell counts "
                               f"{s2d_cells} for {blobs} blobs per well")

        # (b) the planar head is the S2D head permuted, and the S2D compact tail
        # equals the planar compact tail on the permuted tensor, bit for bit
        planar_s = net_s(xn_s[..., None])
        same_head = torch.equal(s2d._d2s(out_s, 3), planar_s)
        cm_perm = flows.compute_masks_sparse_compact(planar_s, cap_u, **tail_kw)
        same_tail = {name: torch.equal(a, b) for name, a, b in zip(cm_s._fields, cm_s, cm_perm)}
        say(f"[s2d] _d2s(out_s2d) equals the planar-head output bit for bit: {same_head}; the S2D "
            f"compact tail equals the planar compact tail on the permuted tensor bit for bit: "
            f"{json.dumps(same_tail)}")
        if not same_head or not all(same_tail.values()):
            raise RuntimeError("the S2D head or compact tail differs from the planar route's")
        del planar_s, cm_perm

        # (c) well 0's S2D forward on the card against the CPU (bf16 gate), and
        # the S2D labels against the planar plate's of phase 7
        net_s_cpu = s2d.UNetS2D(s2d.s2d_params(tree_s, gray_input=True)).eval()
        out_s_cpu = net_s_cpu(xn_s[:1, ..., None].cpu(), out_s2d=True)
        scale = float(out_s_cpu.abs().max())
        d = (out_s[:1].cpu() - out_s_cpu).abs()
        say(f"[s2d] well 0 S2D network output card vs CPU: mean abs {float(d.mean()):.4g}, max abs "
            f"{float(d.max()):.4g}, output scale {scale:.4g} (limits 0.006 and 0.05 of scale)")
        if float(d.mean()) > 0.006 * scale or float(d.max()) > 0.05 * scale:
            raise RuntimeError("the S2D network output on the card differs from the CPU beyond "
                               "tolerance")
        del out_s_cpu, net_s_cpu, d
        agree = [float((a == b).float().mean()) for a, b in zip(cm_s.labels, cm_u.labels)]
        fg_agree = [float(((a > 0) == (b > 0)).float().mean()) for a, b in zip(cm_s.labels, cm_u.labels)]
        planar_cells = [int(c) for c in cm_u.lab_c.amax(1)]
        say(f"[s2d] S2D labels against the planar plate's (phase 7), per well: pixels agreeing "
            f"{[round(a, 5) for a in agree]}, foreground agreeing {[round(a, 5) for a in fg_agree]}, "
            f"cells S2D {s2d_cells} vs planar {planar_cells} (well 0's limits: 0.99 and +-1)")
        if agree[0] < 0.99 or abs(s2d_cells[0] - planar_cells[0]) > 1:
            raise RuntimeError("well 0's S2D labels differ from the planar plate's beyond tolerance")

        # (d) ms per batch of 8: the two forwards in the order planar, S2D, S2D,
        # planar, with each one's peak memory; the S2D route's other parts once,
        # beside phase 13's planar parts
        x_gray, x_rgb = xn_s[..., None], xn_s[..., None].expand(-1, -1, -1, 3)
        forwards = {"planar": lambda: net_u(x_rgb), "s2d": lambda: net_s(x_gray, out_s2d=True)}
        fwd_ms = {"planar": [], "s2d": []}
        peak_gib = {}
        for name in ("planar", "s2d", "s2d", "planar"):
            if not rehearsal:
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            fwd_ms[name].append(round(time_host(forwards[name], seg_reps, sync), 3))
            if not rehearsal:
                peak_gib[name] = round((torch.cuda.max_memory_allocated() - base) / 2**30, 3)
        s2d_parts = {
            "compact tail": time_host(
                lambda: flows.compute_masks_sparse_compact_s2d(out_s, cap_u, **tail_kw), seg_reps,
                sync),
            "measure": time_host(lambda: m.plate.measure_unet_masks(
                cm_s.labels, cm_s.lab_c, cm_s.idx, cm_s.valid, stack_u, unet_config.max_cells),
                seg_reps, sync),
            "program": time_host(lambda: s2d_route(stack_u), seg_reps, sync),
        }
        say(f"[time] U-Net plate forward, ms per batch of {n_wells} {size}^2 wells (order planar, "
            f"S2D, S2D, planar; host clock + synchronize): {json.dumps(fwd_ms)}; peak memory of "
            f"each forward above what was allocated, GiB: {json.dumps(peak_gib)}; the S2D route's "
            f"parts, ms per batch ('program' is stretch + forward + compact tail + measure): "
            f"{json.dumps({k: round(v, 3) for k, v in s2d_parts.items()})}, beside phase 13's "
            f"planar well program {unet_ms:.2f} ms and parts "
            f"{json.dumps({k: round(v, 3) for k, v in uparts.items()})}; card: {smi}")
        net_s3 = s2d.UNetS2D(s2d.s2d_params(tree_s)).to(dev).eval()
        seg_fwd = {"planar": [], "s2d": []}
        for name in ("planar", "s2d", "s2d", "planar"):
            fn = (lambda: model.network(x_seg)) if name == "planar" else (lambda: net_s3(x_seg))
            seg_fwd[name].append(round(time_host(fn, seg_reps, sync), 3))
        d3 = (net_s3(x_seg[:1]) - model.network(x_seg[:1])).abs()
        say(f"[time] batch_segment's forward on its 3-channel input {tuple(x_seg.shape)}, ms per "
            f"batch (order planar, S2D, S2D, planar): {json.dumps(seg_fwd)}; image 0 S2D vs planar "
            f"max abs {float(d3.max()):.4g}; card: {smi}")
        del net_s3, d3

    # (e) the S2D forward's 13 conv calls, each at its shape beside its bound and
    # cuDNN's conv, and lane_moments at the two stem outputs
    tot_s, conv_ms_s = time_conv_calls(m, s2d_conv_shapes(n_wells, size), n_wells, dev, timed,
                                       rehearsal, say)
    conv_ms.update(conv_ms_s)
    say(f"[time] conv3x3_fused, all 13 calls of one S2D forward: {tot_s['ms']:.3f} ms "
        f"({tot_s['bound'] / tot_s['ms']:.1%} of the bound); bound {tot_s['bound']:.3f} ms (sum "
        f"over calls of max(bytes {tot_s['bytes']:.3f}, operations {tot_s['ops']:.3f})); plain "
        f"{tot_s['plain']:.3f} ms; F.conv2d conv only {tot_s['lib']:.3f} ms; beside the planar "
        f"16 calls' {tot['ms']:.3f} ms (bound {tot['bound']:.3f}); card: {smi}")
    for shape in ((n_wells, size // 2, size // 2, 128), (n_wells, size // 4, size // 4, 256)):
        xg = torch.randn(shape, device=dev).to(torch.bfloat16)
        ms, plain_ms = timed(lambda: gn_cuda.lane_moments(xg), lambda: gn_cuda.lane_moments_plain(xg))
        b_ms = xg.numel() * 2 / HBM_BYTES_PER_S * 1e3
        say(f"[time] lane_moments {shape} (an S2D stem's output): {ms:.4f} ms; bound {b_ms:.4f} ms "
            f"(bytes), {b_ms / ms:.1%} of it reached; plain {plain_ms:.4f} ms")
        del xg

    # -- 16. Cellpose-SAM: kernel 8 and the cpsam route ------------------------------
    kernels.append(cellpose_sam_phase(m, dev, rehearsal, wells, timed, say, smi))

    # -- 17. the U-Net block tail (kernel 9) -------------------------------------------
    kernels.append(unet_tail_phase(m, dev, n_wells, seg_size, seg_launches["unet_tail"], timed,
                                   say, smi))

    # -- 18. SAM's AMG route, attention forms (kernel 8 at grid 64, in windows) and
    # mask head (kernel 10) --
    rows, route = sam_attention_forms_phase(m, dev, rehearsal, wells, timed, say, smi)
    kernels.extend(rows)
    kernels.append(sam_upscale_phase(m, dev, rehearsal, route["sam_upscale"], timed, say, smi))

    if args.compare_with:
        compare_with(args.compare_with, kernels, conv_ms, say)

    # -- 19. result -----------------------------------------------------------------
    say(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    say(json.dumps({"kernels": kernels}))
    print(smi)
    if rehearsal:
        print("chip_smoke: CPU rehearsal finished; no device result", file=sys.stderr)
        return 3
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
