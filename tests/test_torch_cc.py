"""PyTorch port: connected components against the JAX package.

The plain tile sweeps must equal the Pallas kernels (run in interpret mode)
bit for bit, including tiles that hit the 256-sweep cap; `component_roots`
and `label` must equal the JAX functions exactly. The GPU-marked tests that
hold each CUDA kernel against its plain version on the card are in
test_torch_cuda_kernels.py, which imports no JAX so that it runs on a
machine with PyTorch alone.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from arcadia_microscopy_tools_tpu.ops import labeling as jax_labeling
from arcadia_microscopy_tools_tpu.ops.cc_pallas import local_cc_pallas, local_resweep_pallas
from arcadia_microscopy_tools_tpu_torch.ops import cc_cuda, labeling
from arcadia_microscopy_tools_tpu_torch.testing import serpentine
from test_cc_pallas import xla_local_fixpoint

# the suite runs in several worker processes at once; one torch thread per
# process keeps them from oversubscribing the host's cores
torch.set_num_threads(1)


def blob_mask(seed: int, shape, quantile: float = 0.8, sigma: float = 4.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    noise = ndi.gaussian_filter(rng.random(shape), sigma)
    return noise > np.quantile(noise, quantile)


def serpentine_mask(shape=(256, 256)) -> np.ndarray:
    """A component snaking through tile (0, 0) far beyond the sweep cap;
    blobs fill the rest of the image."""
    return serpentine(blob_mask(7, shape))


def _t(mask: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(mask))[None]


MASKS_256 = {
    "blobs": lambda: blob_mask(0, (256, 256)),
    "serpentine": serpentine_mask,
    "empty": lambda: np.zeros((256, 256), bool),
    "full": lambda: np.ones((256, 256), bool),
}


class TestPlainSweepsMatchPallas:
    """Exact equality with the Pallas kernels in interpret mode (no tolerance)."""

    @pytest.mark.parametrize("name", list(MASKS_256))
    @pytest.mark.parametrize("connectivity", [1, 2])
    def test_local_cc(self, name, connectivity):
        mask = MASKS_256[name]()
        ref = np.asarray(local_cc_pallas(jnp.asarray(mask), connectivity, interpret=True))
        out = cc_cuda.local_cc_plain(_t(mask), connectivity)[0].numpy()
        np.testing.assert_array_equal(out, ref)

    @pytest.mark.parametrize("name", ["blobs", "serpentine"])
    @pytest.mark.parametrize("connectivity", [1, 2])
    def test_local_resweep(self, name, connectivity):
        mask = MASKS_256[name]()
        rng = np.random.default_rng(3)
        init = np.where(mask, rng.integers(0, mask.size, mask.shape), mask.size).astype(np.int32)
        ref = np.asarray(
            local_resweep_pallas(jnp.asarray(mask), jnp.asarray(init), connectivity, interpret=True)
        )
        out = cc_cuda.local_resweep_plain(_t(mask), torch.from_numpy(init)[None], connectivity)
        np.testing.assert_array_equal(out[0].numpy(), ref)

    def test_serpentine_hits_the_cap(self):
        """The serpentine tile really stops at the cap: its labels are not
        yet the in-tile component minimum."""
        mask = serpentine_mask()
        out = cc_cuda.local_cc_plain(_t(mask), 2)[0].numpy()
        assert out[126, 0] != 0 and out[0, 0] == 0


class TestRaggedShapes:
    @pytest.mark.parametrize("shape", [(200, 300), (130, 517)])
    @pytest.mark.parametrize("connectivity", [1, 2])
    def test_local_cc_matches_numpy_oracle(self, shape, connectivity):
        mask = blob_mask(1, shape)
        out = cc_cuda.local_cc_plain(_t(mask), connectivity)[0].numpy()
        if connectivity == 2:
            expected = xla_local_fixpoint(mask, cc_cuda.CC_BLOCK)
        else:
            expected = self._oracle_4(mask)
        np.testing.assert_array_equal(np.where(mask, out, -1), np.where(mask, expected, -1))
        assert (out[~mask] == cc_cuda.SENTINEL).all()

    @staticmethod
    def _oracle_4(mask):
        """In-tile component minimum by scipy's 4-connected labeling of each
        tile separately (the fixpoint the sweeps converge to)."""
        h, w = mask.shape
        b = cc_cuda.CC_BLOCK
        out = np.full((h, w), cc_cuda.SENTINEL, np.int64)
        idx = np.arange(h * w).reshape(h, w)
        for y in range(0, h, b):
            for x in range(0, w, b):
                lab, n = ndi.label(mask[y : y + b, x : x + b])
                tile_idx = idx[y : y + b, x : x + b]
                mins = ndi.minimum(tile_idx, lab, np.arange(1, n + 1))
                tile_out = out[y : y + b, x : x + b]
                tile_out[lab > 0] = np.asarray(mins)[lab[lab > 0] - 1]
        return out


class TestComponentRoots:
    @pytest.mark.parametrize("shape", [(256, 384), (200, 300), (130, 517)])
    @pytest.mark.parametrize("connectivity", [1, 2])
    def test_matches_jax(self, shape, connectivity):
        masks = np.stack([blob_mask(s, shape, quantile=0.7) for s in (2, 3)])
        roots, converged = labeling.component_roots(torch.from_numpy(masks), connectivity)
        for i, m in enumerate(masks):
            ref_roots, ref_conv = jax_labeling.component_roots(jnp.asarray(m), connectivity)
            np.testing.assert_array_equal(roots[i].numpy(), np.asarray(ref_roots))
            assert bool(converged[i]) == bool(ref_conv)

    @pytest.mark.parametrize("connectivity", [1, 2])
    def test_serpentine_never_silently_wrong(self, connectivity):
        mask = serpentine_mask((256, 384))
        roots, converged = labeling.component_roots(torch.from_numpy(mask), connectivity)
        structure = ndi.generate_binary_structure(2, connectivity)
        lab, n = ndi.label(mask, structure)
        idx = np.arange(mask.size).reshape(mask.shape)
        mins = np.asarray(ndi.minimum(idx, lab, np.arange(1, n + 1)))
        truth = np.where(mask, mins[np.maximum(lab, 1) - 1], mask.size)
        wrong = (roots.numpy() != truth).any()
        assert wrong, "the serpentine is meant to exceed the tile sweep cap"
        assert not bool(converged)

    def test_unbatched_and_empty(self):
        roots, converged = labeling.component_roots(torch.zeros((64, 96), dtype=torch.bool))
        assert roots.shape == (64, 96) and bool(converged)
        assert (roots == 64 * 96).all()


class TestLabel:
    @pytest.mark.parametrize("shape", [(256, 256), (200, 300)])
    @pytest.mark.parametrize("connectivity", [1, 2])
    def test_matches_jax(self, shape, connectivity):
        mask = blob_mask(4, shape, quantile=0.6)
        out = labeling.label(torch.from_numpy(mask), connectivity).numpy()
        ref = np.asarray(jax_labeling.label(jnp.asarray(mask), connectivity))
        np.testing.assert_array_equal(out, ref)

    def test_checked_labels_serpentine_exactly(self):
        mask = serpentine_mask()
        out = labeling.label(torch.from_numpy(mask)).numpy()
        lab, _ = ndi.label(mask, np.ones((3, 3)))
        np.testing.assert_array_equal(out, lab)


class TestWrappers:
    def test_cpu_tensors_take_the_plain_version(self):
        before = dict(cc_cuda.launch_counts)
        mask = _t(blob_mask(5, (128, 256)))
        np.testing.assert_array_equal(
            cc_cuda.local_cc(mask).numpy(), cc_cuda.local_cc_plain(mask).numpy()
        )
        assert cc_cuda.launch_counts == before

    def test_rejects_what_the_kernel_does_not_take(self):
        with pytest.raises(TypeError):
            cc_cuda.local_cc(torch.zeros((1, 8, 8), dtype=torch.uint8))
        with pytest.raises(ValueError):
            cc_cuda.local_cc(torch.zeros((8, 8), dtype=torch.bool))
        with pytest.raises(ValueError):
            cc_cuda.local_cc(torch.zeros((1, 8, 8), dtype=torch.bool), connectivity=3)
        with pytest.raises(ValueError):
            cc_cuda.local_resweep(
                torch.zeros((1, 8, 8), dtype=torch.bool), torch.zeros((1, 8, 8), dtype=torch.int64)
            )
