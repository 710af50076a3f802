"""PyTorch port: `clear_border`, `num_labels` and `compact_labels` against
the JAX package, bit for bit, on the CPU.

Label values below 2^31 must give the JAX package's labels exactly. At and
above 2^31 the port keeps its input's integer dtype, so such labels stay
distinct cells, where the JAX package's int32 arithmetic wraps them (to
negative values, which its relabeling treats as background); the tests
below pin the port's behaviour there.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu.ops import labeling as jax_labeling
from arcadia_microscopy_tools_tpu_torch.ops import labeling

torch.set_num_threads(1)


def _blocks(shape=(24, 30)) -> np.ndarray:
    """Labels on each edge, a label that touches only a corner pixel, and
    interior labels with gaps in their values."""
    lbl = np.zeros(shape, np.int32)
    lbl[0, 5:9] = 3  # top edge
    lbl[-1, 10:14] = 4  # bottom edge
    lbl[6:9, 0] = 9  # left edge
    lbl[12:15, -1] = 11  # right edge
    lbl[-1, -1] = 17  # a corner pixel only
    lbl[4:8, 10:14] = 21  # interior
    lbl[14:18, 4:9] = 40
    lbl[10:12, 20:24] = 41
    return lbl


def _random_labels(seed: int, shape=(40, 56), n=30) -> np.ndarray:
    rng = np.random.default_rng(seed)
    lbl = np.zeros(shape, np.int32)
    for k in rng.choice(np.arange(1, 500), n, replace=False):
        y, x = rng.integers(0, shape[0] - 4), rng.integers(0, shape[1] - 4)
        lbl[y : y + rng.integers(1, 5), x : x + rng.integers(1, 5)] = k
    return lbl


CASES = {
    "edges and corner": _blocks(),
    "random seed 0": _random_labels(0),
    "random seed 1": _random_labels(1),
    "one label": np.full((9, 13), 5, np.int32),
    "interior only": np.pad(np.full((5, 5), 2, np.int32), 3),
    "empty": np.zeros((8, 8), np.int32),
}


@pytest.mark.parametrize("name", list(CASES))
def test_clear_border_is_bit_identical(name):
    lbl = CASES[name]
    got = labeling.clear_border(torch.from_numpy(lbl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_labeling.clear_border(lbl)))


def test_clear_border_drops_each_edge_and_the_corner():
    got = labeling.clear_border(torch.from_numpy(_blocks())).numpy()
    assert set(np.unique(got)) == {0, 21, 40, 41}


def test_clear_border_rejects_a_bool_mask():
    with pytest.raises(TypeError, match="integer label image"):
        labeling.clear_border(torch.zeros((4, 4), dtype=torch.bool))


@pytest.mark.parametrize("name", list(CASES))
def test_num_labels_is_bit_identical(name):
    lbl = CASES[name]
    got = labeling.num_labels(torch.from_numpy(lbl))
    assert got.dim() == 0
    assert int(got) == int(jax_labeling.num_labels(jnp.asarray(lbl)))


@pytest.mark.parametrize("max_labels", [8, 64, 600])
@pytest.mark.parametrize("name", list(CASES))
def test_compact_labels_is_bit_identical(name, max_labels):
    """max_labels 8 clips most labels of the random cases into the last value."""
    lbl = CASES[name]
    got = labeling.compact_labels(torch.from_numpy(lbl), max_labels)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_labeling.compact_labels(lbl, max_labels))
    )


def test_labels_at_and_above_2_31_stay_distinct():
    lbl = np.zeros((10, 12), np.int64)
    lbl[2:4, 2:4] = 7
    lbl[5:7, 3:6] = 2**31
    lbl[2:5, 7:10] = 2**32 + 7  # wraps onto 7 in int32
    lbl[0, 0] = 2**40  # on the border
    cleared = labeling.clear_border(torch.from_numpy(lbl))
    assert cleared.dtype == torch.int64
    np.testing.assert_array_equal(cleared.numpy(), np.where(lbl == 2**40, 0, lbl))
    assert int(labeling.num_labels(cleared)) == 2**32 + 7
    relabeled = labeling.relabel_sequential(cleared).numpy()
    expected = np.zeros_like(relabeled)
    expected[lbl == 7], expected[lbl == 2**31], expected[lbl == 2**32 + 7] = 1, 2, 3
    np.testing.assert_array_equal(relabeled, expected)
    # compact_labels clips into [0, max_labels]: the large labels share it
    compact = labeling.compact_labels(cleared, 8).numpy()
    np.testing.assert_array_equal(compact, np.where(lbl == 7, 1, np.where(expected > 1, 2, 0)))
