"""PyTorch port: Cellpose-SAM (`models/vit_sam.py`), kernel 8's plain
version (`models/sam_attention.py`) and `batch_segment(network="cpsam")`,
against the plain float32 reference `tests/reference_cpsam.py`, on seeded
weights at a tiny size: tile 64, patch 8 (an 8 x 8 token grid), width 128,
2 heads of 64, depth 2 (block 1 "global": stored tables of 127 rows, block
0 of 27), neck 32.

The maps are compared as the benchmark compares them: per map, the 99.9th
percentile of |program - reference| over the reference map's standard
deviation, the largest (`_gap`). Tolerances, each with its reason:
- float32 network: 1e-4. The same equations in float32; only the order of
  sums differs (unfolded GEMMs against convolutions, float32 against the
  reference's float64 blend), ~1e-6 of the spread.
- bfloat16 network (what `batch_segment` runs): 0.1. Weights, activations
  and the residual stream rounded to 8 bits of mantissa (~0.4% each) through
  2 blocks; the readings are ~0.03-0.05.
Each fault (the bias dropped, the taper replaced by a flat mean, one tile's
maps copied from its neighbour) reads well above 0.1.

The weights are `seeded_state_dict`'s with the relative-position tables
and `pos_embed` drawn wider (0.2 and 0.3), so that both move the logits as
much as the benchmark's recipe makes them.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import reference_cpsam as ref
from arcadia_microscopy_tools_tpu_torch.models import sam_attention, segmentation, vit_sam
from arcadia_microscopy_tools_tpu_torch.models.flows import compute_masks
from arcadia_microscopy_tools_tpu_torch.models.segmentation import SegmentationModel
from arcadia_microscopy_tools_tpu_torch.models.stretch_cuda import percentile_stretch_plain
from arcadia_microscopy_tools_tpu_torch.models.vit_sam import CellposeSAM, SamConfig

torch.set_num_threads(1)

TINY = SamConfig(width=128, depth=2, heads=2, mlp=512, patch=8, tile=64, neck=32,
                 global_blocks=(1,))
SIZES = {"tile": 64, "patch": 8, "heads": 2, "overlap": 0.1, "taper_sigma": 7.5}
F32_TOL = 1e-4
BF16_TOL = 0.1
# the taper differs from flat only at Cellpose-SAM's 256-pixel tile (Cellpose
# crops its mask from at least 224 pixels): the faults run a narrow network on it
WIDE_TILE = SamConfig(width=64, depth=1, heads=1, mlp=256, patch=8, tile=256, neck=16,
                      global_blocks=())


def _state(seed: int = 0, config: SamConfig = TINY) -> dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    state = vit_sam.seeded_state_dict(config, g)
    for name, t in state.items():
        if "rel_pos" in name:
            state[name] = 0.2 * torch.randn(t.shape, generator=g)
    state["encoder.pos_embed"] = 0.3 * torch.randn(state["encoder.pos_embed"].shape, generator=g)
    return state


def _image(h: int, w: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = rng.normal(150, 15, size=(3, h, w))
    yy, xx = np.mgrid[:h, :w]
    for _ in range(12):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        img += 2000 * rng.uniform(0.2, 1, size=(3, 1, 1)) * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / 60)
    return img


def _stretched(img: np.ndarray) -> torch.Tensor:
    """Kernel 7's plain stretch: (H, W, 3) float32."""
    return percentile_stretch_plain([torch.from_numpy(img)], *img.shape[1:])[0]


def _gap(prog: torch.Tensor, want: torch.Tensor) -> float:
    out = 0.0
    for c in range(want.shape[-1]):
        d = (prog[..., c].float() - want[..., c]).abs().flatten()
        out = max(out, float(d.kthvalue(max(1, int(np.ceil(0.999 * d.numel())))).values
                             / want[..., c].std()))
    return out


def _model(**kw) -> SegmentationModel:
    model = SegmentationModel(device="cpu", network="cpsam", max_cells=512, **kw)
    model._sam_config = TINY  # the published sizes are the only public ones
    return model


def _reference_maps(img: np.ndarray, state, sizes: dict = SIZES) -> torch.Tensor:
    return ref.maps(_stretched(img).permute(2, 0, 1), state, sizes)


@pytest.mark.parametrize("h, w", [(200, 300), (64, 64), (50, 90)])
def test_float32_network_matches_reference(h, w):
    state = _state()
    img = _image(h, w)
    model = _model()
    model._network = CellposeSAM(state, TINY, dtype=torch.float32)
    got = model._sam_maps(_stretched(img)[None])[0]
    assert got.shape == (h, w, 3)
    assert _gap(got, _reference_maps(img, state)) < F32_TOL


def test_batch_segment_cpsam_matches_reference(tmp_path):
    state = _state(3)
    path = tmp_path / "cpsam.pt"
    torch.save(state, path)
    model = _model(checkpoint_path=path)
    imgs = [_image(200, 300, seed=s) for s in (1, 2)] + [_image(120, 100, seed=3)]
    masks, flows = model.batch_segment(imgs, return_flows=True, num_iterations=50,
                                       show_progress=False)
    for img, mask, flow in zip(imgs, masks, flows):
        assert mask.shape == img.shape[1:] and mask.dtype == np.int64
        assert flow.shape == (*img.shape[1:], 3) and flow.dtype == np.float32
        assert _gap(torch.from_numpy(flow), _reference_maps(img, state)) < BF16_TOL
        # the masks are compute_masks of the returned maps
        want = compute_masks(torch.from_numpy(flow)[None], 0.0, 0.4, 50, 512, 15)[0].numpy()
        assert np.array_equal(mask, want.astype(np.int64))
    # the default output is the masks alone, the same masks
    again = model.batch_segment(imgs, num_iterations=50, show_progress=False)
    assert isinstance(again, list) and all(np.array_equal(a, b) for a, b in zip(again, masks))
    counts = model.stages.counts
    assert counts["segment.tiles"] == 4 and counts["segment.blend"] == 4
    tiles = 2 * (2 * 4 * 6 + 3 * 2)  # two calls: two 200 x 300 images, one 120 x 100
    assert counts["segment.encoder.tiles"] == tiles and counts["segment.encoder"] == 4
    assert "segment.forward" not in counts


def test_segment_returns_flows():
    state = _state(4)
    model = _model()
    model._network = CellposeSAM(state, TINY)
    img = _image(80, 70)
    mask, flow = model.segment(img, return_flows=True, num_iterations=20)
    assert mask.shape == (80, 70) and flow.shape == (80, 70, 3)
    assert np.array_equal(mask, model.segment(img, num_iterations=20))


def test_unet_return_flows_keeps_its_masks():
    model = SegmentationModel(device="cpu", max_cells=64)
    imgs = [_image(48, 40, seed=5)[0], _image(64, 64, seed=6)[0]]
    masks = model.batch_segment(imgs, num_iterations=10, show_progress=False)
    got, flows = model.batch_segment(imgs, num_iterations=10, show_progress=False,
                                     return_flows=True)
    assert all(np.array_equal(a, b) for a, b in zip(masks, got))
    assert [f.shape for f in flows] == [(48, 40, 3), (64, 64, 3)]
    # at a zoom the flows come back at the original size
    _, zoomed = model.batch_segment(imgs[:1], cell_diameter_px=45, num_iterations=10,
                                    show_progress=False, return_flows=True)
    assert zoomed[0].shape == (48, 40, 3) and zoomed[0].dtype == np.float32


def _explicit_attention(q, k, v, rh, rw, grid):
    """Float64, the bias written element by element."""
    q, k, v, rh, rw = (t.double().numpy() for t in (q, k, v, rh, rw))
    n, length, d = q.shape
    iy, ix = np.divmod(np.arange(length), grid)
    bias_idx_h = iy[:, None] - iy[None, :] + grid - 1
    bias_idx_w = ix[:, None] - ix[None, :] + grid - 1
    out = np.empty_like(q)
    for b in range(n):
        s = q[b] @ k[b].T / np.sqrt(d)
        s += np.einsum("ic,ijc->ij", q[b], rh[bias_idx_h]) + np.einsum("ic,ijc->ij", q[b],
                                                                      rw[bias_idx_w])
        p = np.exp(s - s.max(1, keepdims=True))
        out[b] = (p / p.sum(1, keepdims=True)) @ v[b]
    return torch.from_numpy(out)


@pytest.mark.parametrize("grid", [8, 16])
def test_plain_attention_matches_materialised_bias(grid):
    g = torch.Generator().manual_seed(grid)
    qkv = torch.randn(2, grid * grid, 3 * 2 * 64, generator=g)  # 2 tiles, 2 heads of 64
    rh, rw = (0.2 * torch.randn(2 * grid - 1, 64, generator=g) for _ in range(2))
    got = sam_attention.sam_attention(qkv, rh, rw, 2, grid)  # CPU: the plain version
    q, k, v = sam_attention.split_qkv(qkv, 2)
    want = _explicit_attention(q, k, v, rh, rw, grid)  # (tiles x heads, L, 64)
    want = want.view(2, 2, grid * grid, 64).transpose(1, 2).reshape(2, grid * grid, 128)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    # the bias matters: without it the output moves
    flat = sam_attention.sam_attention_plain(qkv, 0 * rh, 0 * rw, 2, grid)
    assert (flat - got).abs().max() > 0.05
    assert sam_attention.launch_counts["sam_attention"] == 0  # no kernel on the CPU


def test_attention_checks_its_input():
    qkv = torch.zeros(2, 64, 3 * 64)
    with pytest.raises(ValueError, match="grid"):
        sam_attention.sam_attention(qkv, torch.zeros(15, 64), torch.zeros(15, 64), 1, 7)
    with pytest.raises(ValueError, match="tables"):
        sam_attention.sam_attention(qkv, torch.zeros(14, 64), torch.zeros(15, 64), 1, 8)
    with pytest.raises(ValueError, match="heads"):
        sam_attention.sam_attention(qkv, torch.zeros(15, 64), torch.zeros(15, 64), 5, 8)


@pytest.mark.parametrize("rows", [27, 127])
@pytest.mark.parametrize("grid", [8, 32])
def test_rel_pos_resize(rows, grid):
    table = torch.randn(rows, 64, generator=torch.Generator().manual_seed(rows))
    got = vit_sam.resize_rel_pos(table, 2 * grid - 1)
    # SAM's get_rel_pos gathers the same resized table
    idx = torch.arange(grid)
    torch.testing.assert_close(got[idx[:, None] - idx[None, :] + grid - 1],
                               ref.get_rel_pos(grid, grid, table), rtol=0, atol=0)
    # linear interpolation with half-pixel centres, written out in float64
    # (PyTorch computes source positions up to 126 in float32: weights ~1e-5 apart)
    out = 2 * grid - 1
    src = np.clip((np.arange(out) + 0.5) * rows / out - 0.5, 0, rows - 1)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, rows - 1)
    t = (src - lo)[:, None]
    want = table.numpy()[lo] * (1 - t) + table.numpy()[hi] * t
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=5e-5)


def test_published_state_dict_on_meta():
    state = vit_sam.seeded_state_dict(SamConfig(), device="meta")
    shapes = vit_sam.published_shapes()
    assert set(state) == set(shapes) and len(state) == 350
    assert all(t.is_meta and tuple(t.shape) == shapes[k] for k, t in state.items())
    assert sum(t.numel() for t in state.values()) == 304_628_930
    for i in range(24):
        rows = 127 if i in (5, 11, 17, 23) else 27
        assert shapes[f"encoder.blocks.{i}.attn.rel_pos_h"] == (rows, 64)
        assert shapes[f"encoder.blocks.{i}.attn.rel_pos_w"] == (rows, 64)
    assert shapes["encoder.blocks.0.attn.qkv.weight"] == (3072, 1024)
    assert shapes["encoder.blocks.0.mlp.lin1.weight"] == (4096, 1024)
    assert shapes["encoder.pos_embed"] == (1, 32, 32, 1024)
    assert shapes["encoder.patch_embed.proj.weight"] == (1024, 3, 8, 8)
    assert shapes["encoder.neck.2.weight"] == (256, 256, 3, 3)
    assert shapes["out.weight"] == (192, 256, 1, 1) and shapes["W2"] == (192, 3, 8, 8)


def test_state_dict_is_checked():
    state = _state()
    CellposeSAM(state, TINY)
    missing = dict(state)
    del missing["encoder.blocks.1.attn.rel_pos_w"]
    with pytest.raises(ValueError, match="missing"):
        CellposeSAM(missing, TINY)
    wrong = dict(state, **{"encoder.blocks.0.attn.qkv.weight": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="shape"):
        CellposeSAM(wrong, TINY)
    w2 = dict(state, W2=state["W2"].flip(0))
    with pytest.raises(ValueError, match="W2"):
        CellposeSAM(w2, TINY)
    with pytest.raises(ValueError, match="network"):
        SegmentationModel(device="cpu", network="sam2")


def test_checkpoint_and_seeded_weights(tmp_path):
    state = _state(7)
    path = tmp_path / "cpsam.pt"
    torch.save(state, path)
    tiles = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(8))
    from_file = _model(checkpoint_path=path).network(tiles)
    assert torch.equal(from_file, CellposeSAM(state, TINY)(tiles))
    seeded = _model(seed=3).network(tiles)
    assert torch.equal(seeded, _model(seed=3).network(tiles))
    assert not torch.equal(seeded, _model(seed=4).network(tiles))


def _plain_sum(y, n, h, w):
    from arcadia_microscopy_tools_tpu_torch.models.sam_tiles import tile_starts

    _, c, b, _ = y.shape
    ys, xs = tile_starts(h, b), tile_starts(w, b)
    y = y.view(n, len(ys), len(xs), c, b, b)
    out = torch.zeros((n, c, h, w))
    for j, y0 in enumerate(ys):
        for i, x0 in enumerate(xs):
            out[..., y0 : y0 + b, x0 : x0 + b] += y[:, j, i]
    return out


def _faults():
    real_blend = segmentation.average_tiles
    real_attention = vit_sam.sam_attention

    def no_bias(qkv, rh, rw, heads, grid):
        return real_attention(qkv, torch.zeros_like(rh), torch.zeros_like(rw), heads, grid)

    def flat(y, n, h, w, *a, **kw):
        return _plain_sum(y, n, h, w) / _plain_sum(torch.ones_like(y), n, h, w)

    def copied(y, n, h, w, *a, **kw):
        y = y.clone()
        y[1] = y[2]  # one tile's maps are its right neighbour's
        return real_blend(y, n, h, w, *a, **kw)

    return {"bias dropped": (vit_sam, "sam_attention", no_bias),
            "flat taper": (segmentation, "average_tiles", flat),
            "tile copied": (segmentation, "average_tiles", copied)}


@pytest.mark.parametrize("fault", ["bias dropped", "flat taper", "tile copied"])
def test_faults_fail_the_comparison(fault, monkeypatch):
    state = _state(9, WIDE_TILE)
    img = _image(300, 600, seed=9)  # 2 x 3 tiles of 256
    model = _model()
    model._network = CellposeSAM(state, WIDE_TILE)
    want = _reference_maps(img, state, dict(SIZES, tile=256, heads=1))
    assert _gap(model._sam_maps(_stretched(img)[None])[0], want) < BF16_TOL
    module, name, broken = _faults()[fault]
    monkeypatch.setattr(module, name, broken)
    assert _gap(model._sam_maps(_stretched(img)[None])[0], want) > 2 * BF16_TOL


@pytest.mark.gpu
def test_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(3, 1024, 3 * 1024, generator=g, device=dev).to(torch.bfloat16)
    rh, rw = ((0.05 * torch.randn(63, 64, generator=g, device=dev)).to(torch.bfloat16)
              for _ in range(2))
    before = sam_attention.launch_counts["sam_attention"]
    got = sam_attention.sam_attention(qkv, rh, rw, 16, 32).float()
    assert sam_attention.launch_counts["sam_attention"] == before + 1
    want = sam_attention.sam_attention_plain(qkv, rh, rw, 16, 32).float()
    # within two bfloat16 steps at the largest |o| (the output's own rounding
    # is half a step; the kernel rounds P to bfloat16 before P V, the plain
    # version does not)
    step = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
    assert (got - want).abs().max() <= 2 * step
    assert (got - want).abs().mean() < 2e-3 * want.abs().mean() + 1e-4


@pytest.mark.gpu
def test_cpsam_network_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    big = SamConfig(width=256, depth=2, heads=4, mlp=1024, global_blocks=(1,))
    state = vit_sam.seeded_state_dict(big, torch.Generator().manual_seed(1))
    tiles = torch.rand(2, 3, 256, 256, generator=torch.Generator().manual_seed(2))
    card = CellposeSAM(state, big, device="cuda")(tiles.cuda()).cpu()
    cpu = CellposeSAM(state, big, dtype=torch.float32)(tiles)
    assert _gap(card.permute(0, 2, 3, 1), cpu.permute(0, 2, 3, 1)) < BF16_TOL
    assert F.mse_loss(card, cpu) < 1e-2 * cpu.var()
