"""PyTorch port: the CUDA kernels against their plain versions, on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch (see README, "PyTorch / CUDA port"). Every
test needs a CUDA device and skips without one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu_torch import SegmentationModel
from arcadia_microscopy_tools_tpu_torch.models import (
    conv_cuda,
    flows,
    flows_cuda,
    gn_cuda,
    stretch_cuda,
    tail_cuda,
)
from arcadia_microscopy_tools_tpu_torch.models.weights import DEFAULT_WEIGHTS
from arcadia_microscopy_tools_tpu_torch.ops import cc_cuda, filters, labeling, rank_cuda
from arcadia_microscopy_tools_tpu_torch.ops.fused import fused_classical_mask
from arcadia_microscopy_tools_tpu_torch.testing import serpentine, synthetic_wells
from test_torch_stretch import CASES, _case, _device_input


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cases(device) -> dict[str, torch.Tensor]:
    wells = torch.from_numpy(synthetic_wells(2, 1, 1000, 1500, 60, seed=1)[:, 0]).to(device)
    blobs = fused_classical_mask(wells)
    return {
        "ragged blobs": blobs,
        "serpentine": torch.from_numpy(serpentine(np.zeros((256, 384), bool)))[None].to(device),
        "empty": torch.zeros((1, 256, 256), dtype=torch.bool, device=device),
        "full": torch.ones((1, 256, 256), dtype=torch.bool, device=device),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("connectivity", [1, 2])
def test_kernels_match_plain_bit_for_bit(cuda_device, connectivity):
    rng = np.random.default_rng(0)
    for name, fg in _cases(cuda_device).items():
        out = cc_cuda.local_cc(fg, connectivity)
        torch.testing.assert_close(
            out, cc_cuda.local_cc_plain(fg, connectivity), rtol=0, atol=0, msg=name
        )
        init = torch.from_numpy(rng.integers(0, fg[0].numel(), tuple(fg.shape), dtype=np.int32))
        init = init.to(cuda_device)
        out = cc_cuda.local_resweep(fg, init, connectivity)
        torch.testing.assert_close(
            out, cc_cuda.local_resweep_plain(fg, init, connectivity), rtol=0, atol=0, msg=name
        )
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_wrappers_count_launches_and_reject_bad_input(cuda_device):
    cc_cuda.reset_launch_counts()
    fg = torch.ones((1, 64, 64), dtype=torch.bool, device=cuda_device)
    cc_cuda.local_cc(fg)
    cc_cuda.local_resweep(fg, torch.zeros((1, 64, 64), dtype=torch.int32, device=cuda_device))
    assert cc_cuda.launch_counts == {"local_cc": 1, "local_resweep": 1}
    with pytest.raises(ValueError):
        cc_cuda.local_cc(torch.ones((1, 64, 128), dtype=torch.bool, device=cuda_device)[:, :, ::2])


@pytest.mark.gpu
def test_component_roots_on_the_card_equal_the_cpu(cuda_device):
    fg = _cases(cuda_device)["ragged blobs"]
    roots, converged = labeling.component_roots(fg)
    ref_roots, ref_converged = labeling.component_roots(fg.cpu())
    assert torch.equal(roots.cpu(), ref_roots) and torch.equal(converged.cpu(), ref_converged)


def _bf16(g, *shape, scale=1.0, device):
    return (torch.randn(shape, generator=g, device=device) * scale).to(torch.bfloat16)


# the last four: W not a multiple of the kernel's 64-pixel tile, H = 1,
# C = Co = 256 with B = 1, and 256 -> 128 over several tiles
CONV_SHAPES = [(2, 64, 80, 32, 32), (1, 40, 48, 64, 128), (1, 24, 32, 256, 128), (1, 3, 50, 32, 64),
               (2, 37, 100, 32, 32), (1, 1, 130, 64, 64), (1, 20, 70, 256, 256), (1, 9, 130, 256, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,c,co", CONV_SHAPES)
def test_conv3x3_fused_matches_plain(cuda_device, b, h, w, c, co):
    """Within one bf16 step (the f32 sums run in another order); moments
    within 1e-5 of the plain sums of the kernel's own output."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = _bf16(g, b, h, w, c, device=cuda_device)
    wt = _bf16(g, 3, 3, co, c, scale=0.05, device=cuda_device)
    pro = (torch.randn((b, c), generator=g, device=cuda_device) + 1,
           torch.randn((b, c), generator=g, device=cuda_device) * 0.1)
    acc = _bf16(g, b, h, w, co, device=cuda_device)
    for kw in ({}, {"prologue": pro, "relu": True}, {"accum": acc}, {"prologue": pro, "accum": acc}):
        y, (s1, s2) = conv_cuda.conv3x3_fused(x, wt, emit_moments=True, **kw)
        yw = conv_cuda.conv3x3_fused_plain(x, wt, **kw).float()
        d = (y.float() - yw).abs()
        assert bool((d <= yw.abs() / 128 + 1e-4 * yw.abs().max()).all())
        yf = y.float()
        torch.testing.assert_close(s1, yf.sum((1, 2)), rtol=0, atol=1e-5 * float(yf.abs().sum()) + 1e-6)
        torch.testing.assert_close(s2, (yf * yf).sum((1, 2)), rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,c,co", [(2, 64, 80, 32, 32), (1, 20, 70, 256, 256)])
def test_conv3x3_fused_gives_the_same_bits_twice(cuda_device, b, h, w, c, co):
    """Fixed-order moment partials and no float atomics: two launches on the
    same inputs give identical y and moment bits."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = _bf16(g, b, h, w, c, device=cuda_device)
    wt = _bf16(g, 3, 3, co, c, scale=0.05, device=cuda_device)
    pro = (torch.randn((b, c), generator=g, device=cuda_device) + 1,
           torch.randn((b, c), generator=g, device=cuda_device) * 0.1)
    acc = _bf16(g, b, h, w, co, device=cuda_device)
    kw = {"prologue": pro, "relu": True, "accum": acc}
    (y1, (a1, b1)), (y2, (a2, b2)) = (conv_cuda.conv3x3_fused(x, wt, emit_moments=True, **kw)
                                      for _ in range(2))
    assert torch.equal(y1.view(torch.int16), y2.view(torch.int16))
    assert torch.equal(a1.view(torch.int32), a2.view(torch.int32))
    assert torch.equal(b1.view(torch.int32), b2.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,c,co", [(2, 64, 80, 32, 32), (1, 32, 70, 64, 128), (1, 16, 40, 256, 256)])
def test_conv3x3_fused_row_slabs(cuda_device, b, h, w, c, co):
    """Halo rows (top / bottom): within one bf16 step of the plain version;
    two slabs split at half the rows (a multiple of every tile height),
    concatenated, equal the whole-image call bit for bit, y and partials."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = _bf16(g, b, h, w, c, device=cuda_device)
    wt = _bf16(g, 3, 3, co, c, scale=0.05, device=cuda_device)
    pro = (torch.randn((b, c), generator=g, device=cuda_device) + 1,
           torch.randn((b, c), generator=g, device=cuda_device) * 0.1)
    acc = _bf16(g, b, h, w, co, device=cuda_device)
    s = h // 2
    for kw in ({}, {"prologue": pro, "relu": True}, {"accum": acc}):
        whole = conv_cuda.conv3x3_fused(x, wt, emit_moments=True, partials=True, **kw)
        halves = []
        for lo, hi in ((0, s), (s, h)):
            top, bottom = int(lo > 0), int(hi < h)
            k = dict(kw, accum=acc[:, lo:hi].contiguous()) if "accum" in kw else kw
            xs = x[:, lo - top : hi + bottom].contiguous()
            y, part = conv_cuda.conv3x3_fused(xs, wt, top=top, bottom=bottom, emit_moments=True,
                                              partials=True, **k)
            yw = conv_cuda.conv3x3_fused_plain(xs, wt, top=top, bottom=bottom, **k).float()
            assert bool(((y.float() - yw).abs() <= yw.abs() / 128 + 1e-4 * yw.abs().max()).all())
            halves.append((y, part))
        assert torch.equal(torch.cat([halves[0][0], halves[1][0]], 1).view(torch.int16),
                           whole[0].view(torch.int16))
        assert torch.equal(torch.cat([halves[0][1], halves[1][1]], 1).view(torch.int32),
                           whole[1].view(torch.int32))


@pytest.mark.gpu
def test_lane_moments_row_slabs(cuda_device):
    """Runs of whole rows: slabs split on a multiple of the run give the
    whole image's partials bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    for shape in [(2, 128, 2048, 32), (2, 120, 104, 64), (1, 40, 1504, 32)]:
        x = _bf16(g, *shape, device=cuda_device)
        run = gn_cuda.lane_rows(shape[2])
        s = shape[1] // 2 // run * run
        halves = [gn_cuda.lane_moments(x[:, :s].contiguous(), partials=True),
                  gn_cuda.lane_moments(x[:, s:].contiguous(), partials=True)]
        whole = gn_cuda.lane_moments(x, partials=True)
        assert torch.equal(torch.cat(halves, 1).view(torch.int32), whole.view(torch.int32))


@pytest.mark.gpu
def test_lane_moments_matches_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    for shape in [(2, 64, 64, 32), (1, 37, 45, 64), (1, 100, 100, 256)]:
        x = _bf16(g, *shape, device=cuda_device)
        for a, b in zip(gn_cuda.lane_moments(x), gn_cuda.lane_moments_plain(x)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("n_iter", [13, 128])
def test_diffuse_matches_plain_bit_for_bit(cuda_device, n_iter):
    wells = torch.from_numpy(synthetic_wells(2, 1, 600, 500, 40, seed=2)[:, 0]).to(cuda_device)
    lbl = labeling.label(fused_classical_mask(wells)).contiguous()
    src = flows._centre_sources(lbl, 1024).contiguous()
    got = flows_cuda.diffuse(lbl, src, n_iter)
    assert torch.equal(got, flows_cuda.diffuse_plain(lbl, src, n_iter))


@pytest.mark.gpu
def test_diffuse_dense_branch_matches_plain_bit_for_bit(cuda_device):
    """Labels the cell pass leaves: a whole-image label, a label split
    between far corners, labels above the box table; beside cells, and on
    both sides of the cell pass's capacity, a box padded to 64 x 64 pixels."""
    rng = np.random.default_rng(4)
    lbl = np.zeros((3, 300, 260), np.int32)
    lbl[0] = 1
    lbl[1, :20, :30] = 2
    lbl[1, -25:, -12:] = 2
    lbl[1, 100:140, 100:130] = 5
    lbl[1, 150:212, 10:72] = 6  # padded to 64 x 64 pixels, the capacity
    lbl[1, 200:263, 150:212] = 7  # a row taller
    # the box table holds labels 1..4096: 4094 over the whole image, the rest above it
    lbl[2] = rng.integers(0, 6, (300, 260)) * 4094
    src = ((lbl > 0) & (rng.random(lbl.shape) < 0.03)).astype(np.float32)
    lbl_t, src_t = torch.from_numpy(lbl).to(cuda_device), torch.from_numpy(src).to(cuda_device)
    flows_cuda.reset_launch_counts()
    got = flows_cuda.diffuse(lbl_t, src_t, 21)
    assert torch.equal(got, flows_cuda.diffuse_plain(lbl_t, src_t, 21))
    assert flows_cuda.launch_counts == {"diffuse": 1, "diffuse_dense": 3}
    assert flows_cuda.branch_counts == {
        "cell_labels": 2, "dense_labels": 4, "pixels_above_table": int((lbl > 4096).sum())
    }


@pytest.mark.gpu
def test_new_wrappers_count_launches(cuda_device):
    for mod in (conv_cuda, gn_cuda, flows_cuda):
        mod.reset_launch_counts()
    x = torch.zeros((1, 16, 16, 32), dtype=torch.bfloat16, device=cuda_device)
    conv_cuda.conv3x3_fused(x, torch.zeros((3, 3, 32, 32), dtype=torch.bfloat16, device=cuda_device))
    gn_cuda.lane_moments(x)
    lbl = torch.ones((1, 16, 16), dtype=torch.int32, device=cuda_device)
    flows_cuda.diffuse(lbl, torch.zeros((1, 16, 16), device=cuda_device), 20)
    assert conv_cuda.launch_counts == {"conv3x3_fused": 1}
    assert gn_cuda.launch_counts == {"lane_moments": 1}
    # a 16^2 cell fits the cell pass; an 80^2 one takes the dense branch,
    # ceil(20 / 8) launches
    assert flows_cuda.launch_counts == {"diffuse": 1, "diffuse_dense": 0}
    lbl = torch.ones((1, 80, 80), dtype=torch.int32, device=cuda_device)
    flows_cuda.diffuse(lbl, torch.zeros((1, 80, 80), device=cuda_device), 20)
    assert flows_cuda.launch_counts == {"diffuse": 2, "diffuse_dense": 3}
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_fused(x.float(), torch.zeros((3, 3, 32, 32), device=cuda_device))


@pytest.mark.gpu
def test_segmentation_on_the_card_matches_the_cpu(cuda_device):
    img = synthetic_wells(1, 1, 256, 256, 12, seed=3)[0, 0].astype(np.float64)
    card = SegmentationModel(checkpoint_path=DEFAULT_WEIGHTS, device=cuda_device).segment(img)
    cpu = SegmentationModel(checkpoint_path=DEFAULT_WEIGHTS, device="cpu").segment(img)
    assert abs(int(card.max()) - int(cpu.max())) <= 1 and (card == cpu).mean() >= 0.99


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, a NaN against a NaN whatever its payload."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0).view(torch.int32), b.masked_fill(nb, 0).view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_percentile_stretch_matches_plain_bit_for_bit(cuda_device, name):
    t = _device_input(_case(name))
    hp, wp = (s + (-s) % 16 for s in t.shape[1:])
    stretch_cuda.reset_launch_counts()
    got = stretch_cuda.percentile_stretch([t.to(cuda_device)], hp, wp)
    torch.cuda.synchronize()
    assert stretch_cuda.launch_counts == {"percentile_stretch": 1}
    assert _same_bits(got.cpu(), stretch_cuda.percentile_stretch_plain([t], hp, wp))


@pytest.mark.gpu
def test_percentile_stretch_chunk_matches_prepare_image(cuda_device):
    """A chunk of mixed dtypes, channels and sizes, planes that start off a
    16-byte boundary (odd sizes), and two 2048^2 integer-valued images, as
    the benchmark's segment cell sends: the plain version bit for bit, and
    `_prepare_image` (np.array_equal)."""
    rng = np.random.default_rng(7)
    big = synthetic_wells(2, 1, 2048, 2048, 300, seed=4)[:, 0].astype(np.float64)
    for xs, hp, wp in (
        ([rng.normal(100, 10, size=(61, 49)), rng.integers(0, 4000, size=(2, 63, 63)).astype(
            np.uint16), rng.normal(size=(3, 49, 63)).astype(np.float32),
          np.where(rng.random((2, 50, 60)) < 0.01, np.nan, rng.normal(size=(2, 50, 60)))], 64, 64),
        (list(big), 2048, 2048),
    ):
        host = [_device_input(x) for x in xs]
        got = stretch_cuda.percentile_stretch([t.to(cuda_device) for t in host], hp, wp).cpu()
        assert _same_bits(got, stretch_cuda.percentile_stretch_plain(host, hp, wp))
        want = np.stack([SegmentationModel._prepare_image(x)[0] for x in xs])
        assert np.array_equal(got.numpy(), want, equal_nan=True)


@pytest.mark.gpu
def test_segmentation_device_route_launches_the_stretch(cuda_device):
    model = SegmentationModel(checkpoint_path=DEFAULT_WEIGHTS, device=cuda_device)
    imgs = list(synthetic_wells(3, 1, 128, 128, 6, seed=5)[:, 0].astype(np.float64))
    stretch_cuda.reset_launch_counts()
    out = model.batch_segment(imgs, batch_size=2, show_progress=False)
    assert all(m is not None for m in out)
    assert stretch_cuda.launch_counts == {"percentile_stretch": 2}
    assert "segment.prepare.host" not in model.stages.counts
    model.segment(imgs[0], cell_diameter_px=15)
    assert stretch_cuda.launch_counts == {"percentile_stretch": 2}
    assert model.stages.counts["segment.prepare.host"] == 1


def _rank_input(kind: str, shape, g, device) -> torch.Tensor:
    if kind == "equal":
        return torch.full(shape, -2.5, device=device)
    if kind == "special":  # +-inf, a positive and a negative NaN, signed zeros
        vals = torch.tensor([float("inf"), -float("inf"), 0.0, -0.0, 1.0], device=device)
        nans = torch.tensor([0x7FC00000, -0x400000], dtype=torch.int32, device=device)
        vals = torch.cat([vals, nans.view(torch.float32)])
        return vals[torch.randint(0, len(vals), shape, generator=g, device=device)]
    x = torch.round(torch.randn(shape, generator=g, device=device) * 2)
    return torch.where(x == 0, torch.where(torch.rand(shape, generator=g, device=device) < 0.5,
                                           -0.0, 0.0), x)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "window, ranks, shape, kind",
    [(11, (60,), (2, 100, 130), "rounded"), (15, (0, 224), (3, 37, 53), "rounded"),
     (21, (220,), (1, 256, 300), "rounded"), (22, (241, 242), (2, 64, 80), "rounded"),
     (255, (32512,), (1, 40, 50), "rounded"),
     (21, (220,), (1, 70, 90), "equal"), (21, (0, 440), (1, 70, 90), "special"),
     (1, (0,), (2, 33, 47), "rounded"), (3, (4,), (2, 33, 47), "special"),
     (35, (612,), (1, 70, 90), "rounded"), (36, (647, 648), (1, 70, 90), "rounded"),
     (74, (2737, 2738), (1, 90, 100), "rounded"), (75, (2812,), (1, 90, 100), "rounded"),
     (225, (25312,), (1, 40, 50), "rounded"), (226, (25537, 25538), (1, 40, 50), "rounded")],
)
def test_rank_select_matches_plain_bit_for_bit(cuda_device, window, ranks, shape, kind):
    """Signed zeros, ties and negative values, all-equal windows, +-inf and
    NaNs of both signs, the smallest windows and the windows on each side of
    the kernel's branch switches (35/36, 74/75, 225/226); window 255 reads
    its keys from device memory."""
    g = torch.Generator(device=cuda_device).manual_seed(window)
    x = _rank_input(kind, shape, g, cuda_device)
    for mode in filters.PAD_MODES:
        got = rank_cuda.rank_select(x, window, ranks, mode)
        want = rank_cuda.rank_select_plain(x, window, ranks, mode)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), mode


@pytest.mark.gpu
def test_median_filter_launches_the_rank_kernel(cuda_device):
    rank_cuda.reset_launch_counts()
    x = torch.randn((2, 64, 64), device=cuda_device)
    out = filters.median_filter(x, 12)
    assert rank_cuda.launch_counts == {"rank_select": 1}
    assert torch.equal(out.cpu(), filters.median_filter(x.cpu(), 12))
    filters.median_filter(x, 9)  # the stacked-view sort: no launch
    assert rank_cuda.launch_counts == {"rank_select": 1}


@pytest.mark.gpu
def test_unet_plate_well_program_on_the_card_matches_the_cpu(cuda_device):
    """The U-Net plate program on the card launches kernels 4-6, and its
    compact mask tail, fed the card's network output, equals the CPU's bit
    for bit."""
    from arcadia_microscopy_tools_tpu_torch.models.weights import load_weights
    from arcadia_microscopy_tools_tpu_torch.parallel import plate

    config = plate.PlateRunConfig(method="unet", max_cells=256)
    wells = torch.from_numpy(synthetic_wells(2, 2, 512, 512, 40, seed=3)).to(cuda_device)
    net = plate.unet_network(load_weights(), cuda_device)
    for mod in (conv_cuda, gn_cuda, flows_cuda):
        mod.reset_launch_counts()
    packed, health, labels = plate._build_well_program(config, 2, net, debug_labels=True)(wells)
    assert conv_cuda.launch_counts["conv3x3_fused"] == 16
    assert gn_cuda.launch_counts["lane_moments"] == 1
    assert flows_cuda.launch_counts["diffuse"] == 1
    assert health[:, 1].eq(0).all() and labels.amax() > 10
    with torch.inference_mode():
        x = plate._normalised(wells[:, 0].float())
        out = net(x[..., None].expand(-1, -1, -1, 3))
        cap = plate.foreground_capacity(config, 512, 512)
        card = flows.compute_masks_sparse_compact(out, cap, max_cells=256)
        cpu = flows.compute_masks_sparse_compact(out.cpu(), cap, max_cells=256)
    for name, a, b in zip(card._fields, card, cpu):
        assert torch.equal(a.cpu(), b), name
    assert torch.equal(card.labels.cpu(), labels.cpu())


@pytest.mark.gpu
def test_float32_forward_on_the_card_runs_the_plain_blocks(cuda_device):
    from arcadia_microscopy_tools_tpu_torch.models.unet import UNet, UNetConfig
    from arcadia_microscopy_tools_tpu_torch.models.weights import load_weights

    nets = []
    for device in (cuda_device, "cpu"):
        net = UNet(UNetConfig(compute_dtype=torch.float32), generator=torch.Generator())
        net.load_state_dict(load_weights())
        nets.append(net.to(device).eval())
    x = torch.from_numpy(np.random.default_rng(5).random((1, 128, 128, 3), dtype=np.float32))
    conv_cuda.reset_launch_counts()
    card = nets[0](x.to(cuda_device)).cpu()
    assert conv_cuda.launch_counts["conv3x3_fused"] == 0
    cpu = nets[1](x)
    assert (card - cpu).abs().max() <= 1e-3 * cpu.abs().max()


@pytest.mark.gpu
def test_training_step_on_the_card_matches_the_cpu(cuda_device):
    """One trainer step from the trained weights (full width, bf16, batch 2
    of 64^2): the flow targets launch the diffusion kernel once and match
    the CPU's (fg equal, flows within 0.02), the loss and its parts within
    1e-2 relative, and the training forward launches no bf16 forward
    kernel."""
    from arcadia_microscopy_tools_tpu_torch.models import train
    from arcadia_microscopy_tools_tpu_torch.models.unet import UNet, UNetConfig
    from arcadia_microscopy_tools_tpu_torch.models.weights import load_weights

    images, labels = train.make_batch(np.random.default_rng(2), 2, 64)
    results = []
    for device in (cuda_device, torch.device("cpu")):
        net = UNet(UNetConfig(), generator=torch.Generator())
        net.load_state_dict(load_weights())
        net = net.to(device)
        flows_cuda.reset_launch_counts()
        conv_cuda.reset_launch_counts()
        gn_cuda.reset_launch_counts()
        flow_t, fg = train._flow_targets(torch.from_numpy(labels).to(device))
        losses = train.train_step(net, train.make_optimizer(net), 3e-4,
                                  torch.from_numpy(images).to(device), flow_t, fg.float())
        launched = (flows_cuda.launch_counts["diffuse"], conv_cuda.launch_counts["conv3x3_fused"],
                    gn_cuda.launch_counts["lane_moments"])
        results.append(([float(v) for v in losses], flow_t.cpu(), fg.cpu(), launched))
    (card, flow_d, fg_d, launched), (cpu, flow_c, fg_c, _) = results
    assert launched == (1, 0, 0)
    assert torch.equal(fg_d, fg_c) and float((flow_d - flow_c).abs().max()) <= 0.02
    np.testing.assert_allclose(card, cpu, rtol=1e-2)


def _tail_operands(b, h, w, c, form, device, seed):
    """Kernel 9's operands: signed zeros where the affine, the residual add
    and the ReLU meet them (at pixels (0, 0, 0-1) of image 0, channels 0-7,
    y -0 times a positive scale plus a bias of -0, plus a residual of -0,
    is relu(-0)), NaNs in y, skip and up."""
    g = torch.Generator(device=device).manual_seed(seed)
    y = _bf16(g, b, h, w, c, scale=3.0, device=device)
    scale = torch.randn((b, c), generator=g, device=device) + 1
    bias = torch.randn((b, c), generator=g, device=device) * 0.5
    skip = _bf16(g, b, h, w, c, device=device)
    up = _bf16(g, b, (h + 1) // 2, (w + 1) // 2, c, device=device) if "split" in form else None
    style = _bf16(g, b, c, scale=0.3, device=device) if "style" in form else None
    scale[0, :8] = scale[0, :8].abs() + 0.5
    bias[0, :8] = -0.0
    y[0, 0, :6, :8] = -0.0
    skip[0, 0, :3, :8] = -0.0
    if up is not None:
        up[0, 0, :1, :8] = -0.0  # pixels (0, 0-1) of the split residual sum to -0
    y[-1, -1, -1, -1] = float("nan")
    skip[-1, 3, 5] = float("nan")
    if up is not None:
        up[-1, -1, 0] = float("nan")
    return y, scale, bias, skip, up, style


@pytest.mark.gpu
@pytest.mark.parametrize("c", [32, 64, 128, 256])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("form", ["skip", "skip and style", "split skip", "split skip and style"])
@pytest.mark.parametrize("in_place", [False, True])
def test_unet_tail_matches_plain_bit_for_bit(cuda_device, c, b, form, in_place):
    """Kernel 9 against its plain version on the card, as int16 views (NaNs
    and the sign of zero included), 37 x 53 pixels so that the pixels do
    not divide the blocks."""
    y, scale, bias, skip, up, style = _tail_operands(b, 37, 53, c, form, cuda_device, c + b)
    want = tail_cuda.unet_tail_plain(y, scale, bias, skip, up=up, style=style)
    tail_cuda.reset_launch_counts()
    got = tail_cuda.unet_tail(y, scale, bias, skip, up=up, style=style,
                              out=y if in_place else None)
    torch.cuda.synchronize()
    assert tail_cuda.launch_counts == {"unet_tail": 1}
    assert (got.data_ptr() == y.data_ptr()) == in_place
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.gpu
def test_unet_tail_rejects_what_the_kernel_does_not_take(cuda_device):
    y, scale, bias, skip, up, _ = _tail_operands(1, 8, 8, 32, "split skip", cuda_device, 0)
    with pytest.raises(ValueError):
        tail_cuda.unet_tail(y.float(), scale, bias, skip.float())
    with pytest.raises(ValueError):
        tail_cuda.unet_tail(y, scale, bias, skip, up=up[:, :3].contiguous())
    with pytest.raises(ValueError):
        tail_cuda.unet_tail(y, scale, bias, skip.transpose(1, 2))
    with pytest.raises(ValueError):
        tail_cuda.unet_tail(y[..., :12], scale[:, :12], bias[:, :12], skip[..., :12])


@pytest.mark.gpu
def test_unet_forward_launches_the_tail_seven_times_bit_for_bit_the_plain_tail(cuda_device,
                                                                              monkeypatch):
    """The bf16 forward launches kernel 9 once per block, 7 times, and gives
    the bits of the same forward with the plain tail (the PyTorch sequence
    the kernel replaced)."""
    from arcadia_microscopy_tools_tpu_torch.models import unet
    from arcadia_microscopy_tools_tpu_torch.models.weights import load_weights

    net = unet.UNet(unet.UNetConfig(), generator=torch.Generator())
    net.load_state_dict(load_weights())
    net = net.to(cuda_device).eval()
    x = torch.from_numpy(np.random.default_rng(8).random((2, 128, 192, 3), dtype=np.float32))
    x = x.to(cuda_device)
    tail_cuda.reset_launch_counts()
    got = net(x)
    assert tail_cuda.launch_counts["unet_tail"] == 7
    monkeypatch.setattr(unet, "unet_tail", tail_cuda.unet_tail_plain)
    want = net(x)
    assert tail_cuda.launch_counts["unet_tail"] == 7
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
