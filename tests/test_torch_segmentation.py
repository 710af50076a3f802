"""PyTorch port: `SegmentationModel` against the JAX package, and its API.

The whole slice - host preparation, U-Net forward, flow tracking, QC,
relabel - runs on the CPU through the plain versions of the kernels and is
held against the JAX `SegmentationModel.batch_segment` with the trained
checkpoint. The API tests mirror tests/test_models.py: defaults,
validation ranges, failure isolation, batching.
"""

from __future__ import annotations

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu.model import SegmentationModel as JaxSegmentationModel
from arcadia_microscopy_tools_tpu.models.weights import load_checkpoint
from arcadia_microscopy_tools_tpu_torch import SegmentationModel
from arcadia_microscopy_tools_tpu_torch.exceptions import SegmentationWarning
from arcadia_microscopy_tools_tpu_torch.models.weights import (
    DEFAULT_WEIGHTS,
    flatten_tree,
    load_weights,
)
from arcadia_microscopy_tools_tpu_torch.testing import synthetic_wells

# one torch thread per test worker process (the suite runs several at once)
torch.set_num_threads(1)

CHECKPOINT = Path(__file__).resolve().parent.parent / "checkpoints" / "unet"


def _images(n: int, size: int, blobs: int, seed: int) -> list[np.ndarray]:
    return list(synthetic_wells(n, 1, size, size, blobs, seed=seed)[:, 0].astype(np.float64))


def _cpu_model(**kw) -> SegmentationModel:
    return SegmentationModel(device="cpu", **kw)


class TestWholeSliceMatchesJax:
    def test_batch_segment_with_trained_weights(self):
        """Same cell count within one and >= 99% of pixels with the same
        label: the bf16 forwards round at different points (see
        test_torch_unet.py), which can move a boundary pixel or a cell near
        the QC threshold; everything after the forward is exact."""
        imgs = _images(2, 192, 12, seed=3) + _images(1, 160, 8, seed=4)
        want = JaxSegmentationModel(checkpoint_path=CHECKPOINT, max_cells=256).batch_segment(
            imgs, show_progress=False
        )
        got = _cpu_model(checkpoint_path=DEFAULT_WEIGHTS, max_cells=256).batch_segment(
            imgs, show_progress=False
        )
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.int64
            assert w.max() >= 5
            assert abs(int(g.max()) - int(w.max())) <= 1
            assert (g == w).mean() >= 0.99


class TestWeights:
    def test_npz_equals_the_orbax_checkpoint_leaf_by_leaf(self):
        want = flatten_tree(jax.tree.map(np.asarray, load_checkpoint(CHECKPOINT)))
        with np.load(DEFAULT_WEIGHTS) as got:
            assert sorted(got.files) == sorted(want)
            for name, leaf in want.items():
                assert got[name].dtype == leaf.dtype, name
                np.testing.assert_array_equal(got[name], leaf, err_msg=name)

    def test_loaded_state_dict_fills_the_network(self):
        model = _cpu_model(checkpoint_path=DEFAULT_WEIGHTS)
        sd = load_weights(DEFAULT_WEIGHTS)
        for name, p in model.network.named_parameters():
            assert torch.equal(p.detach(), sd[name]), name

    def test_orbax_directory_is_refused_before_any_load(self):
        """The reference's checkpoint is an orbax directory; the port reads
        only the .npz export and says how to make one."""
        with pytest.raises(ValueError, match=r"directory.*unet_checkpoint\.npz.*np\.savez"):
            _cpu_model(checkpoint_path=CHECKPOINT)
        with pytest.raises(ValueError, match="flatten_tree"):
            _cpu_model(checkpoint_path=str(CHECKPOINT))

    @pytest.mark.parametrize("seed", [0, 5])
    def test_seeded_weights_follow_init_unet_in_names_shapes_and_spread(self, seed):
        """jax.random and torch.Generator draw different numbers from one
        seed by design: the seeded U-Net matches `init_unet` in leaf names,
        shapes and each large weight leaf's spread (within 10%), not in
        values."""
        from arcadia_microscopy_tools_tpu.models.unet import init_unet
        from arcadia_microscopy_tools_tpu_torch.models.weights import state_dict_from_tree

        tree = jax.tree.map(np.asarray, init_unet(jax.random.PRNGKey(seed)))
        want = state_dict_from_tree(flatten_tree(tree))
        got = _cpu_model(seed=seed).network.state_dict()
        assert sorted(got) == sorted(want)
        large = 0
        for name, leaf in want.items():
            assert tuple(got[name].shape) == tuple(leaf.shape), name
            if leaf.numel() >= 1000:
                large += 1
                ratio = float(got[name].float().std()) / float(leaf.std())
                assert abs(ratio - 1) <= 0.1, (name, ratio)
        assert large >= 10
        assert not torch.equal(got["down.1.conv1"], want["down.1.conv1"])


class TestSegmentationModelAPI:
    def test_parameter_defaults(self):
        p = _cpu_model()._resolve_and_validate_parameters(None, None, None, None, None)
        assert p == {
            "diameter": 30,
            "flow_threshold": 0.4,
            "cellprob_threshold": 0,
            "niter": None,
            "batch_size": 8,
        }

    def test_parameter_overrides(self):
        p = _cpu_model()._resolve_and_validate_parameters(50, 0.6, -2, 400, 16)
        assert p == {
            "diameter": 50,
            "flow_threshold": 0.6,
            "cellprob_threshold": -2,
            "niter": 400,
            "batch_size": 16,
        }

    @pytest.mark.parametrize(
        "args, match",
        [
            ((-5, None, None, None, None), "must be positive"),
            ((0, None, None, None, None), "must be positive"),
            ((None, -0.1, None, None, None), "non-negative"),
            ((None, None, 50, None, None), "between -10 and 10"),
            ((None, None, -10.5, None, None), "between -10 and 10"),
        ],
    )
    def test_validation_ranges(self, args, match):
        with pytest.raises(ValueError, match=match):
            _cpu_model()._resolve_and_validate_parameters(*args)

    def test_device_is_the_card_unless_cpu_is_named(self):
        assert _cpu_model().device == torch.device("cpu")
        if torch.cuda.is_available():
            assert SegmentationModel().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                SegmentationModel()

    def test_seeded_network_is_cached_and_deterministic(self):
        a, b = _cpu_model(seed=3), _cpu_model(seed=3)
        assert a.network is a.network
        for pa, pb in zip(a.network.parameters(), b.network.parameters()):
            assert torch.equal(pa, pb)

    def test_segment_runs_end_to_end(self):
        img = (np.random.default_rng(0).random((48, 40)) * 1000).astype(np.float64)
        mask = _cpu_model(max_cells=64).segment(img, num_iterations=10)
        assert mask.shape == (48, 40) and mask.dtype == np.int64 and mask.min() >= 0

    def test_segment_rescales_by_diameter(self):
        img = _images(1, 96, 4, seed=5)[0]
        mask = _cpu_model(checkpoint_path=DEFAULT_WEIGHTS).segment(img, cell_diameter_px=45)
        assert mask.shape == (96, 96)

    def test_segment_wraps_device_failures(self, monkeypatch):
        model = _cpu_model()
        monkeypatch.setattr(model, "_labels_of", lambda *a: 1 / 0)
        with pytest.raises(RuntimeError, match="Segmentation failed"):
            model.segment(np.zeros((32, 32)))

    def test_batch_segment_failure_isolation(self):
        model = _cpu_model(max_cells=64)
        good = (np.random.default_rng(1).random((48, 48)) * 1000).astype(np.float64)
        bad = np.zeros((4, 4, 4, 4))  # wrong rank: fails in host preparation
        with pytest.warns(SegmentationWarning, match="image 1"):
            out = model.batch_segment([good, bad, good], num_iterations=10, show_progress=False)
        assert out[0] is not None and out[1] is None and out[2] is not None

    def test_batch_failure_retries_per_image(self, monkeypatch):
        """A failed chunk is retried image by image. Image 1 is poisoned by
        its prepared input (`_prepared`, which every chunk goes through)."""
        model = _cpu_model(max_cells=64)
        imgs = _images(3, 64, 2, seed=6)
        real = model._labels_of
        poisoned = model._prepared([model._staged(1, imgs[1], 1.0)], 1.0)[0]

        def flaky(x, params):
            if len(x) > 1:
                raise RuntimeError("batch failed")
            if torch.equal(x[0], poisoned):
                raise RuntimeError("image failed")
            return real(x, params)

        monkeypatch.setattr(model, "_labels_of", flaky)
        with pytest.warns(SegmentationWarning, match="image 1"):
            out = model.batch_segment(imgs, num_iterations=10, show_progress=False)
        assert out[0] is not None and out[1] is None and out[2] is not None

    def test_batch_segment_matches_single(self):
        model = _cpu_model(checkpoint_path=DEFAULT_WEIGHTS, max_cells=64)
        imgs = _images(3, 64, 3, seed=7)
        batched = model.batch_segment(imgs, batch_size=2, show_progress=False)
        for b, img in zip(batched, imgs):
            np.testing.assert_array_equal(b, model.segment(img))

    def test_batch_segment_mixed_shapes(self):
        model = _cpu_model(max_cells=64)
        rng = np.random.default_rng(8)
        imgs = [rng.random((48, 48)), rng.random((64, 48)), rng.random((48, 48))]
        out = model.batch_segment(imgs, num_iterations=10, show_progress=False)
        assert [m.shape for m in out] == [(48, 48), (64, 48), (48, 48)]

    def test_batch_segment_validates_once(self):
        with pytest.raises(ValueError, match="must be positive"):
            _cpu_model().batch_segment([np.zeros((8, 8))], cell_diameter_px=-1, show_progress=False)

    def test_facade_exports(self):
        from arcadia_microscopy_tools_tpu_torch import model

        assert model.SegmentationModel is SegmentationModel
        assert model.CellposeParams is model.SegmentationParams
