"""PyTorch port: binary morphology and small-object / hole removal against
the JAX package. Every output is boolean and compared bit for bit."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu.ops import morphology as jax_morphology
from arcadia_microscopy_tools_tpu_torch.ops import morphology

# the suite runs in several worker processes at once; one torch thread per
# process keeps them from oversubscribing the host's cores
torch.set_num_threads(1)

FOOTPRINTS = {
    "disk1": morphology.disk(1),
    "disk2": morphology.disk(2),
    "square3": morphology.square(3),
    "asymmetric": np.array([[0, 1, 0], [0, 1, 1], [0, 0, 0]], bool),
}


def _mask(seed: int, h: int = 40, w: int = 56, p: float = 0.55) -> np.ndarray:
    """Random speckle, smoothed into blobs, touching the borders."""
    rng = np.random.default_rng(seed)
    noise = rng.random((h + 2, w + 2))
    smooth = sum(noise[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)) / 9
    return smooth > np.quantile(smooth, 1 - p)


def test_footprints_equal_jax():
    for r in range(5):
        np.testing.assert_array_equal(morphology.disk(r), jax_morphology.disk(r))
    np.testing.assert_array_equal(morphology.square(4), jax_morphology.square(4))


@pytest.mark.parametrize("name", list(FOOTPRINTS))
@pytest.mark.parametrize(
    "op", ["binary_erosion", "binary_dilation", "binary_opening", "binary_closing"]
)
def test_binary_morphology_equals_jax(op, name):
    """Erosion treats out-of-image neighbours as foreground, dilation as
    background and mirrors the footprint: equal masks at the borders too."""
    fp = FOOTPRINTS[name]
    m = _mask(len(name))
    ours = getattr(morphology, op)(torch.from_numpy(m), fp).numpy()
    ref = np.asarray(getattr(jax_morphology, op)(jnp.asarray(m), fp))
    np.testing.assert_array_equal(ours, ref)


def test_default_footprint_and_batches():
    masks = np.stack([_mask(1), _mask(2)])
    ours = morphology.binary_opening(torch.from_numpy(masks)).numpy()
    for k in range(2):
        np.testing.assert_array_equal(ours[k], np.asarray(jax_morphology.binary_opening(jnp.asarray(masks[k]))))
    assert morphology.binary_erosion(torch.ones(4, 5, dtype=torch.bool)).all()
    assert not morphology.binary_dilation(torch.zeros(4, 5, dtype=torch.bool)).any()


@pytest.mark.parametrize("connectivity", [1, 2])
def test_remove_small_objects_equals_jax(connectivity):
    m = _mask(3, p=0.3)
    ours = morphology.remove_small_objects(torch.from_numpy(m), 12, connectivity).numpy()
    ref = np.asarray(jax_morphology.remove_small_objects(jnp.asarray(m), 12, connectivity))
    np.testing.assert_array_equal(ours, ref)
    assert ours.sum() < m.sum()


@pytest.mark.parametrize("connectivity", [1, 2])
def test_remove_small_holes_equals_jax(connectivity):
    m = _mask(4, p=0.7)
    ours = morphology.remove_small_holes(torch.from_numpy(m), 10, connectivity).numpy()
    ref = np.asarray(jax_morphology.remove_small_holes(jnp.asarray(m), 10, connectivity))
    np.testing.assert_array_equal(ours, ref)
    assert ours.sum() > m.sum()


def test_removal_runs_per_image_of_a_batch():
    """Component sizes are counted per image: a batch equals its images."""
    masks = np.stack([_mask(5, p=0.3), _mask(6, p=0.3)])
    objects = morphology.remove_small_objects(torch.from_numpy(masks), 12).numpy()
    holes = morphology.remove_small_holes(torch.from_numpy(~masks), 12).numpy()
    for k in range(2):
        one = torch.from_numpy(masks[k])
        np.testing.assert_array_equal(objects[k], morphology.remove_small_objects(one, 12).numpy())
        np.testing.assert_array_equal(holes[k], morphology.remove_small_holes(~one, 12).numpy())
