"""PyTorch port: the native C++ host kernels (the port's own build of
native/amt_host.cpp, made by `_native.build()` into a directory git
ignores) vs their Python fallbacks; twin of test_native.py."""

import numpy as np
import pytest

import reference_impl as ref
from arcadia_microscopy_tools_tpu_torch import _native


def make_labels(rng, shape=(96, 96), n=6):
    from scipy import ndimage as ndi

    noise = ndi.gaussian_filter(rng.random(shape), 3)
    mask = noise > np.quantile(noise, 0.72)
    lbl, _ = ndi.label(mask, structure=np.ones((3, 3)))
    return lbl.astype(np.int64)


@pytest.fixture(scope="module", autouse=True)
def native_library():
    """Builds the port's library once per checkout (g++, about a second);
    without g++ the tests skip, as the reference's do without its library.
    Decided in a fixture, so that every test worker collects the same tests."""
    if not _native.build():
        pytest.skip("native library not built (no g++ or no source)")


class TestNativeConvex:
    def test_matches_reference(self, rng):
        lbl = make_labels(rng)
        got = _native.convex_areas(lbl)
        assert got is not None
        for k in range(1, int(lbl.max()) + 1):
            expected = ref.convex_area(lbl == k)
            area = (lbl == k).sum()
            assert got[k - 1] >= area - 1  # hull contains the region
            assert abs(got[k - 1] - expected) <= 0.05 * expected + 5

    def test_disk_exact(self):
        lbl = ref.disk_mask((40, 40), 20, 20, 9).astype(np.int64)
        got = _native.convex_areas(lbl)
        # a disk is convex: hull pixel count equals the disk area
        assert got[0] == lbl.sum()


class TestNativeOutlines:
    def test_trace_count_and_membership(self, rng):
        lbl = make_labels(rng)
        outlines = _native.trace_outlines(lbl)
        assert outlines is not None
        assert len(outlines) == int(lbl.max())
        for k, outline in enumerate(outlines, start=1):
            if len(outline) == 0:
                continue
            ys = outline[:, 0].astype(int)
            xs = outline[:, 1].astype(int)
            # every traced pixel belongs to its label
            assert (lbl[ys, xs] == k).all()

    def test_closed_loop_on_disk(self):
        lbl = ref.disk_mask((40, 40), 20, 20, 8).astype(np.int64)
        outline = _native.trace_outlines(lbl)[0]
        d = np.hypot(outline[:, 0] - 20, outline[:, 1] - 20)
        assert abs(d.mean() - 8) < 1.2

    def test_used_by_the_nd2_planarize(self, valid_multichannel_nd2_path):
        """The port's ND2 reader planarizes multichannel frames through the
        C++ kernel when it is built, with the numpy transpose's pixels.
        (The reference's twin drives `SegmentationMask`, which the port
        does not have yet.)"""
        from arcadia_microscopy_tools_tpu_torch.io import nd2

        before = dict(nd2.planarize_counts)
        with nd2.ND2File(valid_multichannel_nd2_path) as f:
            planar = f.asarray()
            frame = f._read_frame(0)
        assert nd2.planarize_counts["native"] == before["native"] + 1
        assert nd2.planarize_counts["numpy"] == before["numpy"]
        np.testing.assert_array_equal(planar, frame.transpose(2, 0, 1))


class TestDeinterleave:
    def test_matches_numpy_transpose(self, rng):
        from arcadia_microscopy_tools_tpu_torch import _native

        for c in (2, 3, 4, 5):
            frame = (rng.random((37, 53, c)) * 60000).astype(np.uint16)
            src = np.ascontiguousarray(frame).reshape(-1)
            dst = np.empty(c * 37 * 53, dtype=np.uint16)
            assert _native.deinterleave_u16(src, 37 * 53, c, dst)
            expected = frame.transpose(2, 0, 1).reshape(-1)
            np.testing.assert_array_equal(dst, expected)
