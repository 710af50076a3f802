"""PyTorch port: flow tracking, mask reconstruction and the QC diffusion
against the JAX package.

The integer stages (landing indices, sink clustering, relabeling, the final
labels) must equal the JAX functions bit for bit; the plain diffusion must
equal both `diffuse_xla` and the Pallas kernel in interpret mode bit for
bit. The port runs every function over a batch; each image is compared
with the JAX function on that image alone. Inputs come from numpy seeds.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu.models import flows as jflows
from arcadia_microscopy_tools_tpu.models.flows_pallas import diffuse_pallas, diffuse_xla
from arcadia_microscopy_tools_tpu.models.synthetic import synthesize_cells
from arcadia_microscopy_tools_tpu.models.unet_s2d import apply_unet_s2d, s2d_params
from arcadia_microscopy_tools_tpu.models.weights import load_checkpoint
from arcadia_microscopy_tools_tpu.ops import labeling as jlabeling
from arcadia_microscopy_tools_tpu_torch.models import flows, flows_cuda
from arcadia_microscopy_tools_tpu_torch.models.segmentation import SegmentationModel
from arcadia_microscopy_tools_tpu_torch.ops import labeling

# one torch thread per test worker process (the suite runs several at once)
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _labels(seeds, size=96, n_cells=6) -> np.ndarray:
    return np.stack(
        [synthesize_cells(np.random.default_rng(s), (size, size), n_cells=n_cells)[1] for s in seeds]
    ).astype(np.int32)


def _seam_cells(size=256) -> tuple[np.ndarray, np.ndarray]:
    """Cells centred on the 128-pixel tile seams, one source pixel each."""
    yy, xx = np.mgrid[0:size, 0:size]
    lbl = np.zeros((size, size), np.int32)
    for k, (cy, cx) in enumerate([(128, 64), (64, 128), (128, 128), (200, 128), (5, 250)], 1):
        lbl[(yy - cy) ** 2 + (xx - cx) ** 2 < 120] = k
    src = np.zeros((size, size), np.float32)
    for k in range(1, lbl.max() + 1):
        ys, xs = np.where(lbl == k)
        src[ys[len(ys) // 2], xs[len(xs) // 2]] = 1.0
    return lbl, src


def _flow_scene(seeds, size=96, noise=0.3):
    """Labels, and network-style output from their own flows plus noise:
    (B, H, W, 3) with dY, dX scaled by 5 and cell-probability logits."""
    lbl = _labels(seeds, size)
    outs = []
    for k, s in enumerate(seeds):
        rng = np.random.default_rng(100 + s)
        f, fg = jflows.masks_to_flows(jnp.asarray(lbl[k]), 64)
        f = np.asarray(f) + rng.normal(0, noise, f.shape).astype(np.float32)
        prob = np.where(np.asarray(fg), 3.0, -3.0) + rng.normal(0, 1, fg.shape)
        outs.append(np.concatenate([5 * f, prob[..., None]], -1).astype(np.float32))
    return lbl, np.stack(outs)


class TestDiffusion:
    def test_plain_equals_diffuse_xla_and_pallas(self):
        """Bit for bit, with cells straddling the Pallas tile seams and a
        remainder pass (11 iterations in passes of 4)."""
        lbl, src = _seam_cells()
        lbl2 = _labels([3], 256, 12)[0]
        src2 = (lbl2 > 0) & (np.random.default_rng(1).random(lbl2.shape) < 0.01)
        L = np.stack([lbl, lbl2])
        S = np.stack([src, src2.astype(np.float32)])
        got = flows_cuda.diffuse(torch.from_numpy(L), torch.from_numpy(S), 11).numpy()
        for k in range(2):
            lj, sj = jnp.asarray(L[k]), jnp.asarray(S[k])
            np.testing.assert_array_equal(got[k], np.asarray(diffuse_xla(lj, sj, 11)))
            np.testing.assert_array_equal(
                got[k], np.asarray(diffuse_pallas(lj, sj, 11, ts=128, halo=4, interpret=True))
            )

    @pytest.mark.parametrize("seed, n_iter", [(7, 37), (8, 1), (9, 2), (10, 13), (11, 128)])
    def test_labels_diffuse_independently(self, seed, n_iter):
        """What the card's cell pass rests on: the diffusion of a label image
        equals, label by label, the diffusion of that label alone, and
        `diffuse_xla`. Touching labels, a label split between two far
        corners and labels on the image edge."""
        rng = np.random.default_rng(seed)
        lbl = np.zeros((70, 90), np.int32)
        lbl[10:30, 10:25] = 1
        lbl[10:30, 25:40] = 2  # touches label 1
        lbl[30:45, 15:35] = 3  # touches both
        lbl[40:70, 60:90] = 5  # on the bottom and right edges
        lbl[:6, :8] = 4
        lbl[-5:, -9:] = 4  # split between far corners, beside label 5
        lbl[0:20, 70:90] = rng.integers(6, 9, (20, 20))  # speckled labels on the top edge
        lbl[50:55, 0:4] = -2  # negative labels are background
        src = ((lbl > 0) & (rng.random(lbl.shape) < 0.05)).astype(np.float32)
        for k in range(1, 9):
            src[np.argwhere(lbl == k)[0][0], np.argwhere(lbl == k)[0][1]] = 1.0
        whole = flows_cuda.diffuse_plain(
            torch.from_numpy(lbl[None]), torch.from_numpy(src[None]), n_iter
        )[0]
        np.testing.assert_array_equal(
            whole.numpy(), np.asarray(diffuse_xla(jnp.asarray(lbl), jnp.asarray(src), n_iter))
        )
        for k in range(1, 9):
            own = lbl == k
            alone = flows_cuda.diffuse_plain(
                torch.from_numpy(np.where(own, lbl, 0)[None]),
                torch.from_numpy(np.where(own, src, 0)[None]), n_iter,
            )[0]
            np.testing.assert_array_equal(whole.numpy()[own], alone.numpy()[own])
        assert not whole.numpy()[lbl <= 0].any()

    def test_wrapper_validates(self):
        lbl = torch.zeros((1, 8, 8), dtype=torch.int32)
        with pytest.raises(ValueError):
            flows_cuda.diffuse(lbl.long(), torch.zeros(1, 8, 8), 4)
        with pytest.raises(ValueError):
            flows_cuda.diffuse(lbl, torch.zeros(1, 8, 8), -1)
        assert torch.equal(flows_cuda.diffuse(lbl, torch.ones(1, 8, 8), 0), torch.ones(1, 8, 8))


class TestIntegerStagesBitExact:
    def test_follow_flows_indices(self):
        _, out = _flow_scene([0, 1])
        fl = out[..., :2] * np.float32(0.2)
        act = out[..., 2] > 0
        got = flows.follow_flows_indices(torch.from_numpy(fl), torch.from_numpy(act), niter=200)
        for k in range(2):
            want = jflows.follow_flows_indices(jnp.asarray(fl[k]), jnp.asarray(act[k]), niter=200)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))

    @pytest.mark.parametrize("min_size", [0, 15])
    def test_masks_from_landing(self, min_size):
        _, out = _flow_scene([2, 3])
        fl = out[..., :2] * np.float32(0.2)
        act = out[..., 2] > 0
        landing = flows.follow_flows_indices(torch.from_numpy(fl), torch.from_numpy(act))
        got = flows.masks_from_landing(landing, torch.from_numpy(act), min_size=min_size)
        assert got.dtype == torch.int32
        for k in range(2):
            want = jflows.masks_from_landing(
                jnp.asarray(landing[k].numpy().astype(np.int32)), jnp.asarray(act[k]),
                min_size=min_size,
            )
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))

    def test_relabel_sequential(self):
        rng = np.random.default_rng(8)
        lbl = (rng.integers(0, 40, (2, 48, 40)) * rng.integers(1, 50000, (2, 1, 1))).astype(np.int32)
        lbl[0, :5] = 0
        got = labeling.relabel_sequential(torch.from_numpy(lbl))
        for k in range(2):
            want = jlabeling.relabel_sequential(jnp.asarray(lbl[k]))
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            labeling.relabel_sequential(torch.from_numpy(lbl[1])).numpy(), got[1].numpy()
        )

    @pytest.mark.parametrize("min_size", [1, 15, 60])
    def test_relabel_sequential_filtered(self, min_size):
        lbl = _labels([4, 5], 64, 10)
        lbl[0][lbl[0] == 3] = 0
        lbl[1] = np.where(lbl[1] > 0, lbl[1] * 1000, 0)
        got = labeling.relabel_sequential_filtered(torch.from_numpy(lbl), min_size)
        for k in range(2):
            want = jlabeling.relabel_sequential_filtered(jnp.asarray(lbl[k]), min_size)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))


class TestQcMatchesJax:
    @staticmethod
    def _assert_flows_close(lbl: np.ndarray, max_cells: int):
        """Centres and the diffusion are equal bit for bit; XLA's and
        PyTorch's log1p may round apart by an ulp. Unit flows agree within
        1e-5 except next to a cell's centre, where the gradient is a
        difference of near-equal values and an ulp turns the unit vector:
        there within 0.02."""
        got, fg = flows.masks_to_flows(torch.from_numpy(lbl), max_cells)
        centres = flows._centre_sources(torch.from_numpy(lbl), max_cells)
        near_centre = torch.nn.functional.max_pool2d(centres[:, None], 3, 1, 1)[:, 0].bool()
        for k in range(lbl.shape[0]):
            want, wfg = jflows.masks_to_flows(jnp.asarray(lbl[k]), max_cells)
            np.testing.assert_array_equal(fg[k].numpy(), np.asarray(wfg))
            d = np.abs(got[k].numpy() - np.asarray(want)).max(-1)
            assert d[~near_centre[k].numpy()].max() <= 1e-5
            assert d.max() <= 0.02

    def test_masks_to_flows(self):
        self._assert_flows_close(_labels([6, 7]), 32)

    def test_labels_above_max_cells_share_a_segment(self):
        self._assert_flows_close(_labels([9], 96, 8), 3)

    def test_flow_error(self):
        """Float64 sums against JAX's float32 hi/lo-split sums, and the
        log1p ulps next to the centres (see above), which move a pixel's
        squared error by up to ~1e-2 in a cell of >= 100 pixels: 1e-4
        relative."""
        lbl, out = _flow_scene([10, 11], noise=0.5)
        pred = out[..., :2] * np.float32(0.2)
        got = flows.flow_error(torch.from_numpy(lbl), torch.from_numpy(pred), 32)
        for k in range(2):
            want = jflows.flow_error(jnp.asarray(lbl[k]), jnp.asarray(pred[k]), 32)
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want), rtol=1e-4, atol=1e-7)


def _qc_margin(out: np.ndarray, max_cells: int, min_size: int = 15) -> float:
    """Smallest distance of a mask's flow error from 0.4 in the JAX path."""
    fl = jnp.asarray(out[..., :2]) / 5.0
    act = jnp.asarray(out[..., 2] > 0)
    landing = jflows.follow_flows_indices(fl, act, niter=200)
    lbl = jlabeling.relabel_sequential_filtered(
        jflows.masks_from_landing(landing, act, min_size=0), min_size
    )
    n = int(lbl.max())
    err = np.asarray(jflows.flow_error(lbl, fl, max_cells))[:n]
    return float(np.abs(err - 0.4).min()) if n else 1.0


class TestComputeMasksBitExact:
    """`compute_masks` given the same network output, with the QC on. Each
    case first checks that no mask's flow error lies within 1e-5 of the
    threshold in the JAX path, where float rounding could flip the QC."""

    @staticmethod
    def _check(out: np.ndarray, max_cells: int):
        for k in range(out.shape[0]):
            assert _qc_margin(out[k], max_cells) > 1e-5
        got = flows.compute_masks(torch.from_numpy(out.copy()), flow_threshold=0.4, max_cells=max_cells)
        for k in range(out.shape[0]):
            want = jflows.compute_masks(jnp.asarray(out[k]), flow_threshold=0.4, max_cells=max_cells)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))
        return got

    def test_noisy_flows_some_masks_dropped(self):
        _, out = _flow_scene([12, 13], noise=0.3)
        got = self._check(out, 64)
        assert int(got.max()) > 0

    def test_trained_network_output(self):
        """The JAX S2D forward with the trained checkpoint on prepared
        synthetic cell images."""
        params = s2d_params(load_checkpoint(REPO / "checkpoints" / "unet"))
        rng = np.random.default_rng(14)
        imgs = []
        for _ in range(2):
            img, _ = synthesize_cells(rng, (128, 128), n_cells=8)
            imgs.append(SegmentationModel._prepare_image(img)[0])
        out = np.asarray(apply_unet_s2d(params, jnp.asarray(np.stack(imgs))))
        got = self._check(out, 256)
        assert int(got.max()) > 0
