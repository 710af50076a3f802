"""PyTorch port: percentiles, the float histogram, image-level global
thresholds, local threshold images and `apply_threshold` against the JAX
package."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu.ops import stats as jax_stats
from arcadia_microscopy_tools_tpu.ops import threshold as jax_threshold
from arcadia_microscopy_tools_tpu_torch.ops import stats, threshold
from test_threshold_parity import bimodal_uint16

# the suite runs in several worker processes at once; one torch thread per
# process keeps them from oversubscribing the host's cores
torch.set_num_threads(1)


def _bimodal(seed: int) -> np.ndarray:
    return bimodal_uint16(np.random.default_rng(seed), shape=(48, 64))


def _float_img(seed: int) -> np.ndarray:
    return (_bimodal(seed) / 2000.0).astype(np.float32)


@pytest.mark.parametrize("q", [0.0, 0.5, 37.3, 50.0, 99.9, 100.0])
def test_percentile_equals_jnp_percentile(q):
    """The same float32 position and interpolation as the reference's
    compiled program: equal bit for bit, on several shapes."""
    rng = np.random.default_rng(0)
    for shape in [(37, 41), (5, 7), (64, 64), (2, 33, 17)]:
        x = rng.normal(size=shape).astype(np.float32)
        ours = stats.percentile(torch.from_numpy(x), q).numpy()
        ref = np.asarray(jax_stats.percentile(jnp.asarray(x), q))
        np.testing.assert_array_equal(ours, ref)
        assert abs(float(ours) - np.percentile(x, q)) <= np.spacing(np.abs(x).max())


def test_percentile_of_two_qs_and_nan():
    x = np.arange(10, dtype=np.float32)
    ours = stats.percentile(torch.from_numpy(x), [25.0, 75.0]).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_stats.percentile(jnp.asarray(x), jnp.asarray([25.0, 75.0]))))
    x[3] = np.nan
    assert np.isnan(stats.percentile(torch.from_numpy(x), 10.0).item())


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_float_equals_jax(seed):
    """Same sorted values, same float32 edges: equal counts and centres."""
    x = np.random.default_rng(seed).normal(size=(50, 60)).astype(np.float32)
    counts, centers = stats.histogram_float(torch.from_numpy(x), 256)
    ref_counts, ref_centers = jax_stats.histogram_float(jnp.asarray(x), 256)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    np.testing.assert_array_equal(centers.numpy(), np.asarray(ref_centers))
    assert counts.sum() == x.size


def test_histogram_float_of_a_constant_image():
    """A span of zero becomes 1: every value lands in the first bin."""
    counts, centers = stats.histogram_float(torch.full((4, 5), 2.0), 8)
    ref_counts, ref_centers = jax_stats.histogram_float(jnp.full((4, 5), 2.0), 8)
    assert counts.tolist() == [20.0] + [0.0] * 7 == np.asarray(ref_counts).tolist()
    np.testing.assert_array_equal(centers.numpy(), np.asarray(ref_centers))


HIST_METHODS = ["otsu", "isodata", "yen", "triangle", "minimum"]


@pytest.mark.parametrize("method", ["otsu", "isodata", "yen", "triangle"])
def test_global_thresholds_on_integer_images_equal_jax(method):
    """Exact per-integer histograms: the same bin on every seed."""
    for seed in range(4):
        img = _bimodal(seed)
        ours = float(getattr(threshold, f"threshold_{method}")(torch.from_numpy(img)))
        ref = float(getattr(jax_threshold, f"threshold_{method}")(jnp.asarray(img)))
        assert ours == ref, f"seed {seed}"


def test_minimum_threshold_on_integer_images_masks_agree_with_jax():
    """Thousands of smoothing passes in float64 here and float32 in the
    reference may pick different bins of the same empty valley (ROADMAP
    queue 3); the masks agree on >= 99% of pixels."""
    for seed in range(4):
        img = _bimodal(seed)
        ours = float(threshold.threshold_minimum(torch.from_numpy(img)))
        ref = float(jax_threshold.threshold_minimum(jnp.asarray(img)))
        assert ((img > ours) == (img > ref)).mean() >= 0.99, f"seed {seed}"


@pytest.mark.parametrize("method", HIST_METHODS + ["mean", "li"])
def test_global_threshold_masks_on_float_images_match_jax(method):
    """256-bin float histograms, float64 arithmetic here and float32 in the
    reference (li's class sums in float64 here): thresholds within 1e-3 of
    the data range, masks equal on >= 99.5% of pixels (a threshold moved
    within its bin flips only pixels inside that bin)."""
    for seed in range(3):
        img = _float_img(seed)
        ours = float(threshold.GLOBAL_METHODS[method](torch.from_numpy(img)))
        ref = float(jax_threshold._GLOBAL_METHODS[method](jnp.asarray(img)))
        assert abs(ours - ref) <= 1e-3 * float(np.ptp(img)), f"seed {seed}"
        assert ((img > ours) == (img > ref)).mean() >= 0.995


def test_li_on_integer_images_matches_jax():
    """Tolerance 0.5 for integer images; the fixed point lands within one
    grey level of the reference's, and the masks agree on >= 99.9%."""
    for seed in range(4):
        img = _bimodal(seed)
        ours = float(threshold.threshold_li(torch.from_numpy(img)))
        ref = float(jax_threshold.threshold_li(jnp.asarray(img)))
        assert abs(ours - ref) <= 1.0
        assert ((img > ours) == (img > ref)).mean() >= 0.999


@pytest.mark.parametrize("method, block", [("gaussian", 15), ("mean", 15), ("median", 7), ("median", 21)])
def test_threshold_local_matches_jax(method, block):
    """Gaussian and mean images are float (convolution / cumsum order): within
    2e-4 absolute at a data range of ~2300 (~1e-7 relative); the median is a
    selection: equal."""
    img = _bimodal(5)
    ours = threshold.threshold_local(torch.from_numpy(img), block, method, offset=-3.0).numpy()
    ref = np.asarray(jax_threshold.threshold_local(jnp.asarray(img), block, method, offset=-3.0))
    if method == "median":
        np.testing.assert_array_equal(ours, ref)
    else:
        assert np.abs(ours - ref).max() <= 2e-4


def test_threshold_local_with_param_and_errors():
    img = _float_img(6)
    ours = threshold.threshold_local(torch.from_numpy(img), 11, "gaussian", param=3.0).numpy()
    ref = np.asarray(jax_threshold.threshold_local(jnp.asarray(img), 11, "gaussian", param=3.0))
    assert np.abs(ours - ref).max() <= 1e-6
    with pytest.raises(ValueError, match="odd"):
        threshold.threshold_local(torch.from_numpy(img), 10)
    with pytest.raises(ValueError, match="Unsupported local"):
        threshold.threshold_local(torch.from_numpy(img), 11, "mode")


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_niblack_and_sauvola_match_jax(dtype):
    """Windowed mean and std from cumsum differences in another order: within
    1e-4 of the data range; Sauvola's r from the dtype as in the reference."""
    img = _bimodal(7)
    img = img.astype(dtype) if dtype == np.uint16 else (img / 2000.0).astype(dtype)
    span = float(np.ptp(img))
    for name, kw in (("threshold_niblack", {"window_size": 15, "k": 0.3}),
                     ("threshold_sauvola", {"window_size": 15}),
                     ("threshold_sauvola", {"window_size": 9, "r": 64.0})):
        ours = getattr(threshold, name)(torch.from_numpy(img), **kw).numpy()
        ref = np.asarray(getattr(jax_threshold, name)(jnp.asarray(img), **kw))
        assert np.abs(ours - ref).max() <= 1e-4 * span, name
    assert threshold._sauvola_r(torch.uint16) == jax_threshold._sauvola_r(np.uint16)
    assert threshold._sauvola_r(torch.float32) == jax_threshold._sauvola_r(np.float32)


@pytest.mark.parametrize(
    "method, kwargs",
    [
        ("otsu", {}),
        ("Yen", {}),
        ("triangle", {}),
        ("local", {"block_size": 21, "method": "median", "offset": -40.0}),
        ("local", {"block_size": 9}),
        ("niblack", {"window_size": 11}),
    ],
)
def test_apply_threshold_masks_equal_jax(method, kwargs):
    """Integer images: the histogram methods and the median are exact, so
    the masks are equal; Gaussian and Niblack thresholds are float, and a
    pixel is allowed to flip only where the two thresholds straddle it.
    `method=` names the threshold family in `apply_threshold` (in both
    packages), so the median local threshold is composed by hand."""
    img = _bimodal(8)
    if "method" in kwargs:
        ours = (torch.from_numpy(img).float() > threshold.threshold_local(
            torch.from_numpy(img), **kwargs)).numpy()
        ref = np.asarray(jnp.asarray(img, jnp.float32) > jax_threshold.threshold_local(
            jnp.asarray(img), **kwargs))
        np.testing.assert_array_equal(ours, ref)
        return
    ours = threshold.apply_threshold(torch.from_numpy(img), method, **kwargs).numpy()
    ref = np.asarray(jax_threshold.apply_threshold(jnp.asarray(img), method, **kwargs))
    if method.lower() in ("otsu", "yen", "triangle"):
        np.testing.assert_array_equal(ours, ref)
    else:
        t_ours = threshold.LOCAL_METHODS[method](torch.from_numpy(img), **kwargs).numpy()
        t_ref = np.asarray(jax_threshold._LOCAL_METHODS[method](jnp.asarray(img), **kwargs))
        x = img.astype(np.float32)
        straddle = (x > np.minimum(t_ours, t_ref)) & (x <= np.maximum(t_ours, t_ref))
        assert not (ours != ref)[~straddle].any()


def test_apply_threshold_degenerate_inputs():
    assert not threshold.apply_threshold(torch.full((16, 16), 7, dtype=torch.uint16)).any()
    assert not threshold.apply_threshold(torch.full((16, 16), 0.5), "local", block_size=3).any()
    empty = threshold.apply_threshold(torch.zeros((0, 5)))
    assert empty.shape == (0, 5) and empty.dtype == torch.bool
    with pytest.raises(ValueError, match="Supported methods"):
        threshold.apply_threshold(torch.zeros((4, 4)), "bogus")
