"""PyTorch port: the percentile stretch of segmentation input
(`models/stretch_cuda.py`) and `batch_segment`'s device route.

The plain version, which CPU tensors run and the CUDA kernel is held
against on the card, must give `SegmentationModel._prepare_image`'s output
bit for bit (np.array_equal: NaN equal to NaN, -0 to +0) and np.percentile's
percentiles bit for bit.
"""

from __future__ import annotations

import weakref

import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu_torch.models import stretch_cuda
from arcadia_microscopy_tools_tpu_torch.models.segmentation import SegmentationModel
from arcadia_microscopy_tools_tpu_torch.testing import synthetic_wells

# one torch thread per test worker process (the suite runs several at once)
torch.set_num_threads(1)


def _case(name: str) -> np.ndarray:
    rng = np.random.default_rng(CASES.index(name))
    if name == "normal":
        return rng.normal(size=(50, 37))
    if name == "integer float64":  # what the benchmark's segment cell sends
        return synthetic_wells(1, 1, 80, 72, 6, seed=2)[0, 0].astype(np.float64)
    if name == "uint16":
        return rng.integers(0, 65536, size=(2, 45, 33)).astype(np.uint16)
    if name == "float32":
        return rng.normal(3, 2, size=(3, 40, 41)).astype(np.float32)
    if name == "int32":
        return rng.integers(-1000, 1000, size=(3, 31, 29)).astype(np.int32)
    if name == "constant":
        return np.full((17, 19), 3.0)
    if name == "nan":
        x = rng.normal(size=(2, 30, 30))
        x[0][rng.random((30, 30)) < 0.01] = np.nan
        return x
    if name == "inf":
        x = rng.normal(size=(3, 30, 30))
        x[0][rng.random((30, 30)) < 0.02] = np.inf
        x[1][rng.random((30, 30)) < 0.02] = -np.inf
        x[2][:2] = np.inf  # the interpolation meets inf - inf
        return x
    if name == "signed zeros":
        x = np.where(rng.random((40, 40)) < 0.5, -0.0, 0.0)
        return np.where(rng.random((40, 40)) < 0.3, rng.normal(-1, 1, size=(40, 40)), x)
    if name == "four channels":
        return rng.gamma(2, 100, size=(4, 48, 50))
    if name == "one pixel":
        return np.array([[5.0]])
    if name == "one infinite pixel":
        return np.array([[np.inf]])
    raise KeyError(name)


CASES = ["normal", "integer float64", "uint16", "float32", "int32", "constant", "nan", "inf",
         "signed zeros", "four channels", "one pixel", "one infinite pixel"]


def _device_input(x: np.ndarray) -> torch.Tensor:
    """What `batch_segment`'s device route copies: the first three planes in
    float64, float32 or uint16, any other dtype cast to float32."""
    return SegmentationModel(device="cpu")._upload(np.asarray(x))


def _padded(h: int, w: int) -> tuple[int, int]:
    return h + (-h) % 16, w + (-w) % 16


@pytest.mark.parametrize("name", CASES)
def test_plain_equals_prepare_image(name):
    x = _case(name)
    t = _device_input(x)
    got = stretch_cuda.percentile_stretch([t], *_padded(*t.shape[1:]))[0].numpy()
    want = SegmentationModel._prepare_image(x)[0]
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.uint16])
def test_plain_equals_prepare_image_by_channels(channels, dtype):
    rng = np.random.default_rng(channels)
    x = (rng.gamma(2, 300, size=(channels, 50, 37))).astype(dtype)
    t = _device_input(x)
    assert t.shape[0] == min(channels, 3) and t.dtype == torch.from_numpy(x).dtype
    got = stretch_cuda.percentile_stretch([t], 64, 48)[0].numpy()
    assert np.array_equal(got, SegmentationModel._prepare_image(x)[0], equal_nan=True)


@pytest.mark.parametrize("first", [1, 100, 1000, 4000])
def test_plan_gives_np_percentile(first):
    """The sorted keys at `percentile_plan`'s positions, interpolated as the
    plain version does, are np.percentile's float32 results bit for bit,
    over every plane size from `first` on."""
    rng = np.random.default_rng(first)
    for n in range(first, first + 60):
        x = rng.normal(size=(1, n)).astype(np.float32)
        got = stretch_cuda.percentile_stretch_plain([torch.from_numpy(x[None])], 16, n + (-n) % 16)
        want = SegmentationModel._prepare_image(x[None])[0]
        assert np.array_equal(got[0].numpy(), want), n
        positions, weights = stretch_cuda.percentile_plan(n)
        assert all(0 <= p < n for p in positions) and all(w.dtype == np.float32 for w in weights)
        srt = np.sort(x[0])
        for q, (lo, hi), (t, omt) in zip((1, 99), (positions[:2], positions[2:]),
                                          (weights[:2], weights[2:])):
            a, b = srt[lo], srt[hi]
            p = b - (b - a) * omt if t >= 0.5 else a + (b - a) * t
            assert np.float32(p).view(np.uint32) == np.percentile(x[0], q).view(np.uint32), (n, q)


def test_plan_at_the_cell_size():
    """2048^2: the positions numpy's float32 virtual index gives."""
    positions, weights = stretch_cuda.percentile_plan(2048 * 2048)
    assert positions == (41943, 41944, 4152360, 4152361)
    assert [float(w) for w in weights] == [0.02734375, 0.97265625, 0.0, 1.0]


def test_chunk_of_mixed_dtypes_and_sizes():
    """One chunk, one padded shape, images of other sizes, dtypes and
    channels: each its own `_prepare_image`."""
    rng = np.random.default_rng(5)
    xs = [rng.normal(100, 10, size=(60, 50)), rng.integers(0, 4000, size=(2, 64, 64)).astype(
        np.uint16), rng.normal(size=(3, 49, 63)).astype(np.float32)]
    got = stretch_cuda.percentile_stretch([_device_input(x) for x in xs], 64, 64).numpy()
    assert got.shape == (3, 64, 64, 3) and got.flags.c_contiguous
    for g, x in zip(got, xs):
        assert np.array_equal(g, SegmentationModel._prepare_image(x)[0])


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    stretch_cuda.reset_launch_counts()
    t = torch.from_numpy(_case("normal")[None])
    assert torch.equal(stretch_cuda.percentile_stretch([t], 64, 48),
                       stretch_cuda.percentile_stretch_plain([t], 64, 48))
    assert stretch_cuda.launch_counts == {"percentile_stretch": 0}


@pytest.mark.parametrize("shape, dtype, hp, wp, match", [
    ((4, 8, 8), torch.float32, 16, 16, "C of 1-3"),
    ((8, 8), torch.float32, 16, 16, "C of 1-3"),
    ((1, 8, 8), torch.int32, 16, 16, "unsupported dtype"),
    ((1, 20, 8), torch.float32, 16, 16, "does not fit"),
    ((1, 0, 8), torch.float32, 16, 16, "does not fit"),
])
def test_rejects_what_the_kernel_does_not_take(shape, dtype, hp, wp, match):
    with pytest.raises(ValueError, match=match):
        stretch_cuda.percentile_stretch([torch.zeros(shape, dtype=dtype)], hp, wp)
    with pytest.raises(ValueError, match="at least one"):
        stretch_cuda.percentile_stretch([], hp, wp)


# -- batch_segment's device route, on the CPU model --------------------------------


def _images(n: int, size: int, seed: int) -> list[np.ndarray]:
    return list(synthetic_wells(n, 1, size, size, 3, seed=seed)[:, 0].astype(np.float64))


def test_batch_segment_equals_segment_for_every_dtype():
    model = SegmentationModel(device="cpu", max_cells=64)
    base = _images(3, 64, seed=11)
    imgs = [base[0], base[1].astype(np.uint16), base[2].astype(np.float32)]
    batched = model.batch_segment(imgs, num_iterations=10, batch_size=3, show_progress=False)
    for b, img in zip(batched, imgs):
        np.testing.assert_array_equal(b, model.segment(img, num_iterations=10))


def test_batch_segment_mixed_shapes_group_by_padded_shape():
    """50x37 and 64x48 pad to one shape, 40x40 to another: two chunks, each
    image cropped back to its own size."""
    model = SegmentationModel(device="cpu", max_cells=64)
    rng = np.random.default_rng(3)
    imgs = [rng.random((50, 37)), rng.random((40, 40)), rng.random((64, 48))]
    seen = []
    real = model._prepared

    def prepared(chunk, scale):
        seen.append([item.index for item in chunk])
        return real(chunk, scale)

    model._prepared = prepared
    out = model.batch_segment(imgs, num_iterations=10, show_progress=False)
    assert [m.shape for m in out] == [(50, 37), (40, 40), (64, 48)]
    assert sorted(seen) == [[0, 2], [1]]


def test_at_most_one_chunk_is_prepared_at_a_time():
    """Each chunk is prepared just before its forward, and the previous
    chunk's input is gone by then."""
    model = SegmentationModel(device="cpu", max_cells=64)
    events, alive = [], []
    prepared_real, labels_real = model._prepared, model._labels_of

    def prepared(chunk, scale):
        assert all(ref() is None for ref in alive), "an earlier chunk's input is alive"
        x = prepared_real(chunk, scale)
        alive.append(weakref.ref(x))
        events.append(("prepare", len(chunk)))
        return x

    def labels_of(x, params):
        events.append(("forward", len(x)))
        return labels_real(x, params)

    model._prepared, model._labels_of = prepared, labels_of
    out = model.batch_segment(_images(5, 64, seed=12), num_iterations=5, batch_size=2,
                              show_progress=False)
    assert all(m is not None for m in out)
    assert events == [("prepare", 2), ("forward", 2)] * 2 + [("prepare", 1), ("forward", 1)]


@pytest.mark.parametrize("diameter, host_share", [(30, 0.0), (15, 1.0)])
def test_host_route_share(diameter, host_share):
    """Scale 1 (diameter 30) takes the device route for every image; a zoom
    (diameter 15) takes `_prepare_image` for every image."""
    model = SegmentationModel(device="cpu", max_cells=64)
    out = model.batch_segment(_images(3, 64, seed=13), cell_diameter_px=diameter,
                              num_iterations=5, batch_size=2, show_progress=False)
    assert [m.shape for m in out] == [(64, 64)] * 3
    counts = model.stages.counts
    assert counts["segment.prepare"] == 3
    assert counts.get("segment.prepare.host", 0) / counts["segment.prepare"] == host_share
    assert ("segment.stretch" in counts) == (host_share == 0)
    assert ("segment.upload" in counts) == (host_share == 1)


def test_device_route_gives_the_network_prepare_images_input():
    """The chunk's input equals `_prepare_image`'s outputs stacked, bit for
    bit, so the forward sees the numpy route's input."""
    model = SegmentationModel(device="cpu")
    imgs = _images(2, 56, seed=14) + [_images(1, 56, seed=15)[0].astype(np.uint16)]
    chunk = [model._staged(i, x, 1.0) for i, x in enumerate(imgs)]
    got = model._prepared(chunk, 1.0).numpy()
    want = np.stack([SegmentationModel._prepare_image(x)[0] for x in imgs])
    assert got.shape == want.shape == (3, 64, 64, 3) and np.array_equal(got, want)


@pytest.mark.parametrize("bad, match", [
    (np.zeros((2, 2, 2, 2)), r"\(\[C\], H, W\)"),
    (np.zeros((0, 5)), "non-empty"),
])
def test_segment_rejects_bad_images_as_value_errors(bad, match):
    with pytest.raises(ValueError, match=match):
        SegmentationModel(device="cpu").segment(bad)
