"""PyTorch port: integer histograms, histogram thresholds and percentiles
against the JAX package."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu.ops import fused as jax_fused
from arcadia_microscopy_tools_tpu.ops.stats import histogram_int as jax_histogram_int
from arcadia_microscopy_tools_tpu_torch.ops import fused, stats, threshold
from test_threshold_parity import bimodal_uint16

# the suite runs in several worker processes at once; one torch thread per
# process keeps them from oversubscribing the host's cores
torch.set_num_threads(1)

SEEDS = list(range(100, 124))  # 24 seeded bimodal histograms


def _bimodal(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    frac = 0.1 + 0.03 * (seed % 10)
    return bimodal_uint16(rng, frac=frac)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_histogram_int_equals_jax(seed):
    img = _bimodal(seed)
    counts, centers = stats.histogram_int(torch.from_numpy(img), 65536)
    ref_counts, ref_centers = jax_histogram_int(jnp.asarray(img), 65536)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts).astype(np.int64))
    np.testing.assert_array_equal(centers.numpy(), np.asarray(ref_centers))


def test_histogram_int_drops_out_of_range_values():
    counts, _ = stats.histogram_int(torch.tensor([-1, 0, 3, 3, 4]), 4)
    assert counts.tolist() == [1, 0, 0, 2]


def test_integer_bin_count():
    assert stats.integer_bin_count(np.uint16) == 65536
    assert stats.integer_bin_count(np.uint8) == 256
    assert stats.integer_bin_count(bool) == 2
    assert stats.integer_bin_count(np.float32) is None


EXACT_METHODS = ["otsu", "isodata", "yen", "triangle"]


@pytest.mark.parametrize("method", EXACT_METHODS)
def test_exact_thresholds_pick_the_jax_bin(method):
    """Same bin as the JAX function (exact equality) on every seed; the
    whole batch of histograms goes through the port in one call."""
    imgs = [_bimodal(s) for s in SEEDS]
    counts = torch.stack([stats.histogram_int(torch.from_numpy(i), 65536)[0] for i in imgs])
    centers = torch.arange(65536, dtype=torch.float32)
    ours = getattr(threshold, f"{method}_from_hist")(counts, centers).numpy()
    for k, img in enumerate(imgs):
        ref_counts, ref_centers = jax_histogram_int(jnp.asarray(img), 65536)
        ref = float(jax_fused.HIST_THRESHOLD_METHODS[method](ref_counts, ref_centers))
        assert float(ours[k]) == ref, f"seed {SEEDS[k]}"


def test_mean_threshold_matches_jax():
    """The histogram mean is not a bin: float64 here, float32 in the
    reference, so equal to float32 rounding (rel 1e-6)."""
    for seed in SEEDS:
        img = _bimodal(seed)
        counts, centers = stats.histogram_int(torch.from_numpy(img), 65536)
        ref_counts, ref_centers = jax_histogram_int(jnp.asarray(img), 65536)
        ref = float(jax_fused.HIST_THRESHOLD_METHODS["mean"](ref_counts, ref_centers))
        assert float(threshold.mean_from_hist(counts, centers)) == pytest.approx(ref, rel=1e-6)


def test_minimum_threshold_mask_agrees_with_jax():
    """The minimum method smooths the histogram thousands of times; float64
    here and float32 in the reference may pick different bins of the same
    empty valley, so the criterion is the mask (>= 99% pixel agreement), as
    in test_threshold_parity.

    Both sides take the first 4096 bins of each 65536-bin histogram (every
    value of the recipe lies below 4096): thousands of smoothing passes over
    65536 bins cost seconds per histogram on the CPU, and the methods are
    generic in the bin count."""
    nbins = 4096
    centers = torch.arange(nbins, dtype=torch.float32)
    for seed in SEEDS:
        img = _bimodal(seed)
        assert int(img.max()) < nbins
        counts, _ = stats.histogram_int(torch.from_numpy(img), nbins)
        ref = float(
            jax_fused.HIST_THRESHOLD_METHODS["minimum"](
                jnp.asarray(counts.numpy(), jnp.float32), jnp.asarray(centers.numpy())
            )
        )
        ours = float(threshold.minimum_from_hist(counts, centers))
        assert ((img > ours) == (img > ref)).mean() >= 0.99, f"seed {seed}"


def test_occupied_range_masks():
    counts = torch.tensor([0, 0, 3, 0, 1, 0])
    after_first, before_last = threshold._occupied_range_masks(counts)
    assert after_first.tolist() == [False, False, True, True, True, True]
    assert before_last.tolist() == [True, True, True, True, True, False]


@pytest.mark.parametrize("q", [0.5, 50.0, 99.9])
def test_percentile_from_cum_equals_numpy_at_2048_squared(q):
    """At n = 2048^2 the order-statistic position must not round (float32
    spacing there is 0.5): both order statistics are exact and the
    interpolation equals np.percentile to float32 rounding (rel 2.5e-7, two
    float32 ulps); it equals the JAX function exactly."""
    rng = np.random.default_rng(0)
    n = 2048 * 2048
    data = rng.integers(0, 65536, n, dtype=np.int64)
    counts = np.bincount(data, minlength=65536)
    cum = torch.from_numpy(np.cumsum(counts)).to(torch.float32)
    ours = float(fused._percentile_from_cum(cum, q, n))
    expected = float(np.percentile(data, q))
    assert ours == pytest.approx(expected, rel=2.5e-7, abs=0)
    ref = float(jax_fused._percentile_from_cum(jnp.asarray(np.cumsum(counts), jnp.float32), q, n))
    assert ours == ref
