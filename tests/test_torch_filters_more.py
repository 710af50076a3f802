"""PyTorch port: boundary modes, Gaussian / DoG in every mode, windowed
means, small-window median and rank filters, grey morphology and the
rolling ball against the JAX package."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu.ops import filters as jax_filters
from arcadia_microscopy_tools_tpu_torch.ops import filters

# the suite runs in several worker processes at once; one torch thread per
# process keeps them from oversubscribing the host's cores
torch.set_num_threads(1)

MODES = filters.PAD_MODES


def _img(seed: int, h: int = 40, w: int = 56) -> np.ndarray:
    return np.random.default_rng(seed).random((h, w)).astype(np.float32)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@pytest.mark.parametrize("mode", MODES)
def test_pad_equals_jnp_pad_for_any_width(mode):
    """An index map, equal to jnp.pad bit for bit, also for pads wider than
    the image (the reflections repeat) and for 1-pixel axes."""
    rng = np.random.default_rng(0)
    for h, w in [(5, 7), (1, 3), (2, 9)]:
        x = rng.normal(size=(2, h, w)).astype(np.float32)
        for pad in (0, 1, 3, 6, 17):
            ours = filters._pad_last2(torch.from_numpy(x), pad, pad + 1, mode, 2.5).numpy()
            ref = np.asarray(jax_filters._pad_last2(jnp.asarray(x), pad, pad + 1, mode, 2.5))
            np.testing.assert_array_equal(ours, ref)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="boundary mode"):
        filters.gaussian_filter(torch.zeros(8, 8), 1.0, mode="bogus")


@pytest.mark.parametrize("mode", MODES)
def test_gaussian_filter_modes_match_jax(mode):
    """Convolution here, banded matmuls in the reference: both float32, max
    abs diff <= 1e-6 on the [0, 1] scale (as for mode "nearest")."""
    x = _img(1)
    ours = filters.gaussian_filter(torch.from_numpy(x), 2.0, mode=mode, cval=0.25).numpy()
    ref = np.asarray(jax_filters.gaussian_filter(jnp.asarray(x), 2.0, mode=mode, cval=0.25))
    assert np.abs(ours - ref).max() <= 1e-6


@pytest.mark.parametrize("mode", ["reflect", "constant"])
def test_difference_of_gaussians_modes_match_jax(mode):
    """"constant" is not centred (the zero fill does not shift); max abs
    diff <= 1e-6 on the [0, 1] scale."""
    x = (_img(2) * 60000).astype(np.uint16)
    ours = filters.difference_of_gaussians(torch.from_numpy(x), 1.0, 4.0, mode=mode).numpy()
    ref = np.asarray(jax_filters.difference_of_gaussians(jnp.asarray(x), 1.0, 4.0, mode=mode))
    assert np.abs(ours - ref).max() <= 1e-6


@pytest.mark.parametrize("window", [3, 15])
def test_box_filter_and_window_mean_std_match_jax(window):
    """Per-axis cumsum differences on both sides, summed in another order:
    a window sum may differ by two float32 ulps of the largest cumulative
    sum (values in [0, 1]: at most window * (H + window + 1)), so a mean by
    that over window^2; standard deviations within 1e-4 absolute on the
    [0, 1] scale (a square root of a cancelling difference)."""
    x = _img(3)
    tol = 2 * float(np.spacing(np.float32(window * (x.shape[0] + window + 1)))) / window**2
    ours = filters.box_filter(torch.from_numpy(x), window).numpy()
    ref = np.asarray(jax_filters.box_filter(jnp.asarray(x), window))
    assert np.abs(ours - ref).max() <= tol
    mean, std = filters.window_mean_std(torch.from_numpy(x), window)
    rmean, rstd = jax_filters.window_mean_std(jnp.asarray(x), window)
    assert np.abs(mean.numpy() - np.asarray(rmean)).max() <= tol
    assert np.abs(std.numpy() - np.asarray(rstd)).max() <= 1e-4


def test_box_filter_needs_an_odd_window():
    with pytest.raises(ValueError, match="odd"):
        filters.box_filter(torch.zeros(8, 8), 4)


def _signed_zero_ties(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([-0.0, 0.0, 1.0, -1.0], np.float32), (24, 32))


@pytest.mark.parametrize("window", [3, 4, 5, 9])
def test_small_window_median_and_rank_equal_jax_bit_for_bit(window):
    """A stable sort of the same stacked views on both sides: equal in every
    bit, signed zeros included (ties keep their view order)."""
    for img in (_img(4, 24, 32), _signed_zero_ties(window)):
        ours = filters.median_filter(torch.from_numpy(img), window).numpy()
        ref = jax_filters.median_filter(jnp.asarray(img), window)
        np.testing.assert_array_equal(_bits(ours), _bits(ref))
        rank = window * window // 3
        ours = filters.rank_filter(torch.from_numpy(img), rank, window, mode="wrap").numpy()
        ref = jax_filters.rank_filter(jnp.asarray(img), rank, window, mode="wrap")
        np.testing.assert_array_equal(_bits(ours), _bits(ref))


def test_median_of_uint16_and_batches():
    x = (np.random.default_rng(5).random((2, 3, 20, 24)) * 4000).astype(np.uint16)
    ours = filters.median_filter(torch.from_numpy(x), 3).numpy()
    ref = np.asarray(jax_filters.median_filter(jnp.asarray(x), 3))
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("window", [3, 4, 7])
def test_grey_morphology_equals_jax(window):
    """Min and max are exact: equal, including the reference's one extra
    row and column for an even window."""
    x = _img(6)
    for name in ("grey_erosion", "grey_dilation", "grey_opening"):
        ours = getattr(filters, name)(torch.from_numpy(x), window).numpy()
        ref = np.asarray(getattr(jax_filters, name)(jnp.asarray(x), window))
        assert ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("kernel, radius", [("paraboloid", 8), ("sphere", 4)])
def test_rolling_ball_equals_jax(kernel, radius):
    """Each tap is one float32 add of the same constant and min/max are
    exact, so the background is equal bit for bit."""
    x = (_img(7, 2 * 20, 2 * 24) * 4000).reshape(2, 20, 48)
    ours = filters.rolling_ball_background(torch.from_numpy(x), radius, kernel).numpy()
    ref = np.asarray(jax_filters.rolling_ball_background(jnp.asarray(x), radius, kernel))
    np.testing.assert_array_equal(_bits(ours), _bits(ref))
    ours = filters.subtract_background_rolling_ball(torch.from_numpy(x), radius, kernel).numpy()
    ref = np.asarray(jax_filters.subtract_background_rolling_ball(jnp.asarray(x), radius, kernel))
    np.testing.assert_array_equal(ours, ref)
    assert (ours >= 0).all()


def test_rolling_ball_rejects_unknown_kernel():
    with pytest.raises(ValueError, match="rolling-ball kernel"):
        filters.rolling_ball_background(torch.zeros(8, 8), 3, "cube")
