"""PyTorch port: Gaussian / DoG filters and the fused classical mask
against the JAX package."""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu.ops import filters as jax_filters
from arcadia_microscopy_tools_tpu.ops import fused as jax_fused
from arcadia_microscopy_tools_tpu_torch.ops import filters, fused
from arcadia_microscopy_tools_tpu_torch.testing import synthetic_wells

# the suite runs in several worker processes at once; one torch thread per
# process keeps them from oversubscribing the host's cores
torch.set_num_threads(1)


# images on which the reference's float32 Otsu finds the exact argmax; on
# others it can land a few bins off (test_reference_float32_otsu_...)
SEED_EXACT = 16
SEED_OTSU_F32_OFF = 11


@pytest.fixture(scope="module")
def images():
    """Two 256x384 segmentation channels with ~20 blobs each."""
    return synthetic_wells(2, 1, 256, 384, 20, seed=SEED_EXACT)[:, 0]


@pytest.mark.parametrize("sigma", [1.0, 4.0, 16.0])
def test_gaussian_filter_matches_jax(images, sigma):
    """float32 on both sides; max abs diff <= 1e-6 on the [0, 1] scale."""
    x = images.astype(np.float32) / 65535.0
    ours = filters.gaussian_filter(torch.from_numpy(x), sigma).numpy()
    ref = np.asarray(jax_filters.gaussian_filter(jnp.asarray(x), sigma))
    assert np.abs(ours - ref).max() <= 1e-6


def test_difference_of_gaussians_matches_jax(images):
    """Per-image DoG (the reference's well program DoGs one image at a
    time); max abs diff <= 1e-6 on the [0, 1] scale."""
    ours = filters.difference_of_gaussians(torch.from_numpy(images), 1.0, 16.0).numpy()
    for k, img in enumerate(images):
        ref = np.asarray(jax_filters.difference_of_gaussians(jnp.asarray(img), 1.0, 16.0))
        assert np.abs(ours[k] - ref).max() <= 1e-6


def test_to_float_scales_like_skimage():
    x = torch.tensor([0, 65535], dtype=torch.uint16)
    assert filters.to_float(x).tolist() == [0.0, 1.0]
    assert filters.to_float(torch.tensor([-128, 0], dtype=torch.int8)).tolist() == [-1.0, 0.0]


def test_constant_image_gives_zero_dog_and_empty_mask():
    img = torch.full((2, 64, 96), 1234, dtype=torch.uint16)
    dog = filters.difference_of_gaussians(img, 1.0, 16.0)
    assert (dog == 0).all()
    for method in fused.HIST_THRESHOLD_METHODS:
        assert not fused.fused_classical_mask(img, method=method).any()


@jax.jit
def _reference_q0_one(img):
    """The reference's quantization (ops/fused.py:124-134) of its own DoG,
    jitted per image like `fused_classical_mask` itself."""
    dog = jax_filters.difference_of_gaussians(img, 1.0, 16.0)
    mn = jnp.min(dog)
    mx = jnp.max(dog)
    step = jnp.maximum(mx - mn, 1e-30) / 65535.0
    q0 = jnp.clip(jnp.floor((dog - mn) / step), 0.0, 65535.0).astype(jnp.uint16)
    return q0, mn, mx


def _reference_q0(images: np.ndarray):
    parts = [_reference_q0_one(jnp.asarray(img)) for img in images]
    return (
        torch.from_numpy(np.stack([np.asarray(p[0]) for p in parts]).astype(np.int32)),
        torch.tensor([float(p[1]) for p in parts], dtype=torch.float32),
        torch.tensor([float(p[2]) for p in parts], dtype=torch.float32),
    )


@pytest.fixture(scope="module")
def reference_masks(images):
    return {
        method: np.stack(
            [
                np.asarray(jax_fused.fused_classical_mask(jnp.asarray(img), method=method))
                for img in images
            ]
        )
        for method in BIT_EXACT_METHODS
    }


# "minimum" is held by test_torch_stats_threshold: thousands of smoothing
# passes over 65536 bins cost tens of seconds here
BIT_EXACT_METHODS = ["otsu", "isodata", "yen", "triangle", "mean"]


@pytest.mark.parametrize("method", BIT_EXACT_METHODS)
def test_mask_from_reference_q0_is_bit_exact(images, reference_masks, method):
    q0, mn, mx = _reference_q0(images)
    ours = fused.mask_from_q0(q0, mn, mx, method=method).numpy()
    np.testing.assert_array_equal(ours, reference_masks[method])


@pytest.mark.parametrize("method", ["otsu", "mean"])
def test_end_to_end_mask_disagreement_is_tiny(images, reference_masks, method):
    """The port's own DoG differs from the reference's in float rounding,
    which can move a pixel across a quantization boundary: at most 1e-4
    of the pixels may disagree."""
    ours = fused.fused_classical_mask(torch.from_numpy(images), method=method).numpy()
    assert (ours != reference_masks[method]).mean() <= 1e-4


def _exact_otsu_bin(hist: np.ndarray) -> int:
    """Otsu by exact rational arithmetic over the occupied bins: the
    between-class variance of the split after bin a is
    (w2 * s1 - w1 * s2)^2 / (w1 * w2); the first maximum wins."""
    occupied = np.nonzero(hist)[0]
    total_w = int(hist.sum())
    total_s = sum(int(hist[b]) * int(b) for b in occupied)
    best, arg, w1, s1 = None, None, 0, 0
    for a in occupied[:-1]:
        w1 += int(hist[a])
        s1 += int(hist[a]) * int(a)
        w2, s2 = total_w - w1, total_s - s1
        v = Fraction((w2 * s1 - w1 * s2) ** 2, w1 * w2)
        if best is None or v > best:
            best, arg = v, int(a)
    return arg


def test_reference_float32_otsu_misses_the_exact_bin():
    """Known disagreement (ROADMAP queue 3): on the 65536-bin pushforward
    histogram the reference's float32 cumulative sums round, and its Otsu
    lands a few bins away from the exact argmax. The port's float64 Otsu
    picks the exact bin; the masks then differ in at most 1e-4 of pixels."""
    imgs = synthetic_wells(2, 1, 256, 384, 20, seed=SEED_OTSU_F32_OFF)[:, 0]
    q0, mn, mx = _reference_q0(imgs)
    img0 = q0[0].reshape(-1).long()
    n = img0.numel()
    counts = torch.bincount(img0, minlength=65536)
    cum = torch.cumsum(counts, -1).to(torch.float32)[None]
    p1 = fused._percentile_from_cum(cum, 0.5, n)
    p2 = fused._percentile_from_cum(cum, 99.9, n)
    i = torch.arange(65536, dtype=torch.float32)
    j = torch.floor(((i - p1) * 65535.0 / (p2 - p1)).clamp(0.0, 65535.0)).long()
    hist2 = torch.zeros(65536, dtype=torch.int64).scatter_add_(0, j, counts)

    exact = _exact_otsu_bin(hist2.numpy())
    assert float(fused.HIST_THRESHOLD_METHODS["otsu"](hist2, i)) == exact
    ref_t = float(
        jax_fused.HIST_THRESHOLD_METHODS["otsu"](
            jnp.asarray(hist2.numpy(), jnp.float32), jnp.asarray(i.numpy())
        )
    )
    assert ref_t != exact  # the documented reference-side rounding

    ours = fused.mask_from_q0(q0, mn, mx).numpy()
    ref = np.stack([np.asarray(jax_fused.fused_classical_mask(jnp.asarray(x))) for x in imgs])
    assert (ours != ref).mean() <= 1e-4


def test_unbatched_input(images):
    one = fused.fused_classical_mask(torch.from_numpy(images[0]))
    both = fused.fused_classical_mask(torch.from_numpy(images))
    assert one.shape == images.shape[1:]
    np.testing.assert_array_equal(one.numpy(), both[0].numpy())


def test_unknown_method_raises(images):
    with pytest.raises(ValueError, match="histogram thresholds"):
        fused.fused_classical_mask(torch.from_numpy(images), method="li")


def test_other_boundary_modes_are_not_ported():
    """Every scipy boundary mode is ported now (each is held against the
    reference in test_torch_filters_more); only an unknown mode raises."""
    x = np.random.default_rng(0).random((8, 8)).astype(np.float32)
    ours = filters.gaussian_filter(torch.from_numpy(x), 1.0, mode="reflect").numpy()
    ref = np.asarray(jax_filters.gaussian_filter(jnp.asarray(x), 1.0, mode="reflect"))
    assert np.abs(ours - ref).max() <= 1e-6
    with pytest.raises(ValueError, match="boundary mode"):
        filters.gaussian_filter(torch.zeros((8, 8)), 1.0, mode="periodic")
