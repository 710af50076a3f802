"""PyTorch port: `models.synthetic` (a numpy copy of the JAX package's
module) gives the JAX package's images and labels exactly for the same
generator state."""

import numpy as np
import pytest

from arcadia_microscopy_tools_tpu.models import synthetic as jax_synthetic
from arcadia_microscopy_tools_tpu_torch.models import synthesize_cells
from arcadia_microscopy_tools_tpu_torch.models import synthetic


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"shape": (96, 80), "n_cells": 12, "separation": 0.6, "invert": True, "blur_sigma": 1.5},
        {"shape": (64, 64), "n_cells": 8, "shot_noise": 0.05, "membrane_only": 1.0,
         "edge_cells": True, "background_level": 0.1},
    ],
)
def test_synthesize_cells_equals_jax(kwargs):
    ours = synthesize_cells(np.random.default_rng(3), **kwargs)
    theirs = jax_synthetic.synthesize_cells(np.random.default_rng(3), **kwargs)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_fixture_stats_equal_jax():
    assert synthetic.load_fixture_stats() == jax_synthetic.load_fixture_stats()


@pytest.mark.parametrize("record", [0, -1])
def test_synthesize_cells_like_equals_jax(record):
    stats = list(synthetic.load_fixture_stats().values())[record]
    ours = synthetic.synthesize_cells_like(np.random.default_rng(5), stats, shape=(80, 96))
    theirs = jax_synthetic.synthesize_cells_like(np.random.default_rng(5), stats, shape=(80, 96))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
