"""PyTorch port: exact window rank selection (the plain version of the
rank kernel, and median / rank filters over windows above 9) against the
JAX package's Pallas kernel and filters."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu.ops import filters as jax_filters
from arcadia_microscopy_tools_tpu.ops.rank_pallas import rank_select_pallas
from arcadia_microscopy_tools_tpu_torch.ops import filters, rank_cuda

# the suite runs in several worker processes at once; one torch thread per
# process keeps them from oversubscribing the host's cores
torch.set_num_threads(1)


def _tied_image(seed: int, h: int = 40, w: int = 56) -> np.ndarray:
    """Small integers (many ties, negatives) with every zero given a random
    sign: -0.0 and +0.0 are equal as values but not as int32 keys."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.normal(0.0, 2.0, (h, w))).astype(np.float32)
    signs = rng.choice(np.array([-1.0, 1.0], np.float32), (h, w))
    return np.where(v == 0, np.copysign(np.float32(0.0), signs), v).astype(np.float32)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@pytest.mark.parametrize(
    "window, ranks",
    [(11, (0, 60)), (15, (112, 224)), (21, (220,)), (22, (241, 242))],
)
def test_plain_equals_the_pallas_kernel_bit_for_bit(window, ranks):
    """Both order values by their int32 keys, so they agree in every bit,
    signed zeros included (the Pallas kernel in interpret mode)."""
    img = _tied_image(window)
    ours = rank_cuda.rank_select_plain(torch.from_numpy(img), window, ranks).numpy()
    ref = np.asarray(rank_select_pallas(jnp.asarray(img), window, ranks, interpret=True))
    assert ours.shape == ref.shape == (len(ranks),) + img.shape
    np.testing.assert_array_equal(_bits(ours), _bits(ref))


@pytest.mark.parametrize("window", [11, 33])
def test_filters_equal_the_jax_filters_by_value(window):
    """The JAX filters take the strip sort on the CPU; equal by value (==,
    so -0.0 == +0.0) for the median and a rank filter."""
    img = _tied_image(100 + window, 48, 60)
    k = window * window
    ours = filters.median_filter(torch.from_numpy(img), window).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_filters.median_filter(jnp.asarray(img), window)))
    rank = k // 5
    ours = filters.rank_filter(torch.from_numpy(img), rank, window).numpy()
    ref = np.asarray(jax_filters.rank_filter(jnp.asarray(img), rank, window))
    np.testing.assert_array_equal(ours, ref)


def test_even_window_median_matches_jax():
    """Window 12: the two middle ranks in one selection, averaged in float32."""
    img = np.random.default_rng(5).normal(size=(36, 44)).astype(np.float32)
    ours = filters.median_filter(torch.from_numpy(img), 12).numpy()
    np.testing.assert_array_equal(_bits(ours), _bits(jax_filters.median_filter(jnp.asarray(img), 12)))


def test_signed_zeros_follow_the_kernel_not_the_strip_sort():
    """The JAX package's two routes differ in the sign bit: its Pallas kernel
    orders -0.0 below +0.0, its strip sort keeps equal values in view order.
    The port follows the kernel (ROADMAP queue 3)."""
    rng = np.random.default_rng(0)
    img = rng.choice(np.array([-0.0, 0.0, 1.0], np.float32), (24, 40))
    ours = rank_cuda.rank_select_plain(torch.from_numpy(img), 11, (60,)).numpy()
    kernel = np.asarray(rank_select_pallas(jnp.asarray(img), 11, (60,), interpret=True))
    strips = np.asarray(jax_filters._rank_select_strips(jnp.asarray(img), (60,), 11, "reflect"))
    np.testing.assert_array_equal(_bits(ours), _bits(kernel))
    np.testing.assert_array_equal(ours, strips)  # equal values
    assert (_bits(ours) != _bits(strips)).sum() > 0  # not equal bits


@pytest.mark.parametrize("mode", filters.PAD_MODES)
def test_every_pad_mode_matches_the_pallas_kernel(mode):
    img = _tied_image(7, 20, 26)
    ours = rank_cuda.rank_select_plain(torch.from_numpy(img), 11, (60,), mode).numpy()
    ref = np.asarray(rank_select_pallas(jnp.asarray(img), 11, (60,), pad_mode=mode, interpret=True))
    np.testing.assert_array_equal(_bits(ours), _bits(ref))


def test_keys_are_order_isomorphic_and_an_involution():
    vals = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf], np.float32)
    keys = rank_cuda.float_to_key(torch.from_numpy(vals))
    assert torch.all(keys[1:] > keys[:-1])
    np.testing.assert_array_equal(_bits(rank_cuda.key_to_float(keys).numpy()), _bits(vals))


def test_batch_and_leading_axes_select_per_image():
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.normal(size=(2, 3, 30, 34)).astype(np.float32))
    out = rank_cuda.rank_select(imgs, 11, (10, 110))
    assert out.shape == (2, 2, 3, 30, 34)
    for i in range(2):
        for j in range(3):
            one = rank_cuda.rank_select(imgs[i, j], 11, (10, 110))
            assert torch.equal(out[:, i, j].view(torch.int32), one.view(torch.int32))


def test_strips_of_the_plain_version_do_not_change_the_result(monkeypatch):
    img = torch.from_numpy(_tied_image(9, 30, 40))
    whole = rank_cuda.rank_select_plain(img, 11, (60,))
    monkeypatch.setattr(rank_cuda, "_PLAIN_CHUNK", 121 * 40 * 3)  # strips of 3 rows
    assert torch.equal(rank_cuda.rank_select_plain(img, 11, (60,)).view(torch.int32),
                       whole.view(torch.int32))


@pytest.mark.parametrize(
    "args, error",
    [
        ((torch.zeros(8, 8), 11, (121,)), ValueError),
        ((torch.zeros(8, 8), 11, (-1,)), ValueError),
        ((torch.zeros(8, 8), 11, (1, 2, 3)), ValueError),
        ((torch.zeros(8, 8, dtype=torch.float64), 11, (1,)), TypeError),
        ((torch.zeros(8), 11, (1,)), ValueError),
        ((torch.zeros(8, 8, device="meta"), 11, (1,)), ValueError),
    ],
)
def test_rank_select_rejects_what_the_kernel_does_not_take(args, error):
    with pytest.raises(error):
        rank_cuda.rank_select(*args)


def test_cpu_calls_do_not_count_as_launches():
    rank_cuda.reset_launch_counts()
    filters.median_filter(torch.zeros(20, 20), 11)
    assert rank_cuda.launch_counts == {"rank_select": 0}
