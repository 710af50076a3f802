"""PyTorch port: `ImageOperation` / `Pipeline`, the basic operations and the
facades against the JAX package, and the two preprocessing configurations
of `chip_smoke.py` at 2 frames of 128^2."""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu import operations as jax_operations
from arcadia_microscopy_tools_tpu.ops import basic as jax_basic
from arcadia_microscopy_tools_tpu.ops import filters as jax_filters
from arcadia_microscopy_tools_tpu.ops import labeling as jax_labeling
from arcadia_microscopy_tools_tpu.ops import morphology as jax_morphology
from arcadia_microscopy_tools_tpu.ops import threshold as jax_threshold
from arcadia_microscopy_tools_tpu.ops.pipeline import ImageOperation as JaxOp
from arcadia_microscopy_tools_tpu.ops.pipeline import Pipeline as JaxPipeline
from arcadia_microscopy_tools_tpu_torch import ImageOperation, Pipeline, operations, pipeline
from arcadia_microscopy_tools_tpu_torch.ops import basic, filters, labeling, morphology, threshold
from arcadia_microscopy_tools_tpu_torch.testing import noise_tiles, synthetic_timelapse

# the suite runs in several worker processes at once; one torch thread per
# process keeps them from oversubscribing the host's cores
torch.set_num_threads(1)

ULP_4096 = float(np.spacing(np.float32(4096)))


def _stack(seed: int, n: int = 2, h: int = 48, w: int = 64) -> np.ndarray:
    """Frames of different brightness ranges (uint16)."""
    rng = np.random.default_rng(seed)
    scale = np.array([1000, 9000, 30000][:n], float)[:, None, None]
    return (rng.random((n, h, w)) * scale + 50).astype(np.uint16)


# -- ImageOperation ---------------------------------------------------------------------


def test_image_operation_is_immutable_hashable_and_reprs_like_jax():
    op = ImageOperation(filters.median_filter, 3, mode="wrap")
    assert op == ImageOperation(filters.median_filter, 3, mode="wrap")
    assert hash(op) == hash(ImageOperation(filters.median_filter, 3, mode="wrap"))
    assert op != ImageOperation(filters.median_filter, 5, mode="wrap")
    assert repr(op) == repr(JaxOp(jax_filters.median_filter, 3, mode="wrap")) == "median_filter(3, mode='wrap')"
    with pytest.raises(AttributeError):
        op.args = (5,)
    with pytest.raises(AttributeError):
        del op.func
    assert torch.equal(op(torch.ones(4, 4)), torch.ones(4, 4))


# -- Pipeline contract --------------------------------------------------------------------


def test_pipeline_validation_matches_jax():
    with pytest.raises(ValueError, match="at least one operation"):
        Pipeline([], device="cpu")
    with pytest.raises(TypeError, match="callable"):
        Pipeline([3], device="cpu")
    with pytest.raises(ValueError, match="max_workers"):
        Pipeline([ImageOperation(basic.crop_to_center, (2, 2))], max_workers=0, device="cpu")
    with pytest.warns(UserWarning, match="copy=True has no effect"):
        Pipeline([ImageOperation(basic.crop_to_center, (2, 2))], copy=True, parallel=True, device="cpu")
    pipe = Pipeline([ImageOperation(basic.crop_to_center, (2, 2))], parallel=True, device="cpu")
    with pytest.raises(ValueError, match="at least 3D"):
        pipe(np.zeros((4, 4)))
    ref = JaxPipeline([JaxOp(jax_basic.crop_to_center, (2, 2))], parallel=True)
    assert repr(pipe) == repr(ref) and len(pipe) == 1


def test_pipeline_default_device_is_cuda_or_raises():
    ops = [ImageOperation(basic.crop_to_center, (2, 2))]
    if torch.cuda.is_available():
        assert Pipeline(ops).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Pipeline(ops)


def test_parallel_runs_the_fold_per_frame():
    """Percentiles and thresholds are global over an op's input: with
    parallel=True each frame gets its own, as the reference's vmap gives.
    The reference compiles the vmapped stretch as one program that rounds
    the affine map differently: within 2 float32 ulps at 1.0 (2.4e-7)."""
    stack = _stack(0, 3)
    ops = [ImageOperation(basic.rescale_by_percentile, (1, 99))]
    ours = Pipeline(ops, parallel=True, device="cpu")(stack)
    ref = JaxPipeline([JaxOp(jax_basic.rescale_by_percentile, (1, 99))], parallel=True)(stack)
    assert np.abs(ours - ref).max() <= 2 * float(np.spacing(np.float32(1.0)))
    whole = Pipeline(ops, device="cpu")(stack)
    assert not np.allclose(ours, whole)
    for k in range(3):  # each frame spans [0, 1] on its own
        assert ours[k].min() == 0.0 and ours[k].max() == 1.0


def test_host_dtype_contract_and_preserve_dtype():
    stack = _stack(1)
    ops = [ImageOperation(filters.gaussian_filter, 1.0)]
    out = Pipeline(ops, device="cpu")(stack)
    assert isinstance(out, np.ndarray) and out.dtype == np.float64
    kept = Pipeline(ops, preserve_dtype=True, device="cpu")(stack)
    ref = JaxPipeline([JaxOp(jax_filters.gaussian_filter, 1.0)], preserve_dtype=True)(stack)
    assert kept.dtype == np.uint16 == ref.dtype
    # truncation toward zero of values that differ by float32 rounding
    assert np.abs(kept.astype(int) - ref.astype(int)).max() <= 1
    tensor = Pipeline(ops, device="cpu")(torch.from_numpy(stack))
    assert isinstance(tensor, torch.Tensor) and tensor.dtype == torch.float32


def test_tensor_input_stays_and_copy_protects_it():
    def bump(x):
        x += 1  # an operation that mutates its input
        return x

    x = torch.zeros(3, 4)
    out = Pipeline([ImageOperation(bump)], copy=True, device="cpu")(x)
    assert torch.equal(x, torch.zeros(3, 4)) and torch.equal(out, torch.ones(3, 4))
    host = np.zeros((3, 4), np.float32)
    Pipeline([ImageOperation(bump)], device="cpu")(host)  # NumPy input is always copied
    assert (host == 0).all()


# -- basic operations and facades --------------------------------------------------------------


@pytest.mark.parametrize("prange", [(0, 100), (0.5, 99.9), (2, 98)])
def test_rescale_by_percentile_equals_jax(prange):
    """The same float32 percentiles, clip and affine map: equal."""
    img = _stack(2)[1]
    ours = basic.rescale_by_percentile(torch.from_numpy(img), prange, (-1, 3)).numpy()
    ref = np.asarray(jax_basic.rescale_by_percentile(jnp.asarray(img), prange, (-1, 3)))
    np.testing.assert_array_equal(ours, ref)


def test_rescale_degenerate_inputs_and_errors():
    const = basic.rescale_by_percentile(torch.full((8, 8), 7.0), (1, 99), (0.25, 1))
    assert (const == 0.25).all()
    assert basic.rescale_by_percentile(torch.zeros((0, 4))).shape == (0, 4)
    with pytest.raises(ValueError, match="Invalid percentile range"):
        basic.rescale_by_percentile(torch.zeros(4, 4), (50, 10))


def test_subtract_background_dog_matches_jax():
    """DoG by convolution here and banded matmuls there: within 1e-6 on the
    [0, 1] scale; negatives clipped in both."""
    img = _stack(3)[0]
    ours = basic.subtract_background_dog(torch.from_numpy(img), 1.0, 6.0, 5).numpy()
    ref = np.asarray(jax_basic.subtract_background_dog(jnp.asarray(img), 1.0, 6.0, 5))
    assert np.abs(ours - ref).max() <= 1e-6
    assert ours.min() == 0.0
    with pytest.raises(ValueError, match="low_sigma"):
        basic.subtract_background_dog(torch.from_numpy(img), 6.0, 1.0)
    with pytest.raises(ValueError, match="Percentile"):
        basic.subtract_background_dog(torch.from_numpy(img), percentile=101)


def test_crop_to_center_equals_jax():
    img = _stack(4)
    for shape in [(10, 20), (100, 7), (48, 64)]:
        ours = basic.crop_to_center(torch.from_numpy(img), shape).numpy()
        np.testing.assert_array_equal(ours, np.asarray(jax_basic.crop_to_center(jnp.asarray(img), shape)))


def test_operations_facade_host_boundary():
    img = _stack(5)[0]
    out = operations.rescale_by_percentile(img, (1, 99), device="cpu")
    ref = jax_operations.rescale_by_percentile(img, (1, 99))
    assert isinstance(out, np.ndarray) and out.dtype == np.float64 == ref.dtype
    np.testing.assert_array_equal(out, ref)
    mask = operations.apply_threshold(img, "otsu", device="cpu")
    np.testing.assert_array_equal(mask, jax_operations.apply_threshold(img, "otsu"))
    assert mask.dtype == bool
    dog = operations.subtract_background_dog(img, device="cpu")
    assert dog.dtype == np.float64
    tensor = operations.apply_threshold(torch.from_numpy(img))
    assert isinstance(tensor, torch.Tensor)
    assert operations.crop_to_center(img, (4, 4)).shape == (4, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            operations.rescale_by_percentile(img)


def test_pipeline_facade_and_package_exports():
    assert pipeline.Pipeline is Pipeline and pipeline.ImageOperation is ImageOperation


# -- the two preprocessing configurations, shrunk -------------------------------------------


def test_denoise_configuration_matches_jax():
    """Gaussian -> 3x3 median -> rolling ball (radius 25), parallel, 2 frames
    of 128^2 uint16 noise tiles. The Gaussian is float (convolution here,
    banded matmuls there); a median and a grey opening are 1-Lipschitz in
    the max norm, so the output may differ by at most twice the Gaussian
    stage's difference plus a few float32 ulps at the data's magnitude."""
    tiles = noise_tiles(2, 128, seed=0)
    ours = Pipeline([
        ImageOperation(filters.gaussian_filter, 2.0),
        ImageOperation(filters.median_filter, 3),
        ImageOperation(filters.subtract_background_rolling_ball, radius=25),
    ], parallel=True, device="cpu")(tiles)
    ref = JaxPipeline([
        JaxOp(jax_filters.gaussian_filter, 2.0),
        JaxOp(jax_filters.median_filter, 3),
        JaxOp(jax_filters.subtract_background_rolling_ball, radius=25),
    ], parallel=True)(tiles)
    assert ours.dtype == ref.dtype == np.float64 and ours.shape == ref.shape
    g_ours = filters.gaussian_filter(torch.from_numpy(tiles), 2.0).numpy()
    g_ref = np.asarray(jax_filters.gaussian_filter(jnp.asarray(tiles), 2.0))
    g_err = float(np.abs(g_ours - g_ref).max())
    assert np.abs(ours - ref).max() <= 2 * g_err + 4 * ULP_4096


def _median_mask(img):
    return img.to(torch.float32) > threshold.threshold_local(img, 21, "median", -150.0)


def _jax_median_mask(img):
    return img.astype(jnp.float32) > jax_threshold.threshold_local(img, 21, "median", -150.0)


def test_local_threshold_configuration_equals_jax():
    """21x21 median local threshold -> opening with disk(2) -> label,
    parallel, 2 frames of 128^2 blob timelapse: the median of integers plus
    150 is exact in float32, so masks and labels are equal."""
    stack = synthetic_timelapse(2, 128, 4, seed=0)
    ours = Pipeline([
        ImageOperation(_median_mask),
        ImageOperation(morphology.binary_opening, morphology.disk(2)),
        ImageOperation(labeling.label),
    ], parallel=True, device="cpu")(stack)
    ref = JaxPipeline([
        JaxOp(_jax_median_mask),
        JaxOp(jax_morphology.binary_opening, jax_morphology.disk(2)),
        JaxOp(jax_labeling.label),
    ], parallel=True)(stack)
    assert ours.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)
    assert ours.max() >= 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert Pipeline([ImageOperation(_median_mask)], device="cpu")(stack[0]).dtype == bool
