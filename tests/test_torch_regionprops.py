"""PyTorch port: `measure_labels`, `measure_intensity` and
`measure_intensity_stack` - twins of tests/test_regionprops.py run through
the port, and the port against the JAX package on the same label images.

Tolerances against the JAX package (which sums in float32 through bf16
hi/lo splits; the port sums in float64): label, valid, area and the bbox
columns equal; the other morphology columns rtol 1e-5 plus atol 1e-4;
orientation modulo pi on elongated cells whose exact moments do not tie;
intensity_min and intensity_max equal (uint16 values are exact in
float32); intensity_mean and intensity_std rtol 1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

import reference_impl as ref
from arcadia_microscopy_tools_tpu.ops import labeling as jax_labeling
from arcadia_microscopy_tools_tpu.ops import regionprops as jax_regionprops
from arcadia_microscopy_tools_tpu_torch.ops import label, measure_intensity, measure_labels
from arcadia_microscopy_tools_tpu_torch.ops import regionprops
from arcadia_microscopy_tools_tpu_torch.ops.segment_reduce import table_lookup

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
INTEGER_PROPS = ["label", "valid", "area", "bbox_min_row", "bbox_min_col", "bbox_max_row",
                 "bbox_max_col"]
FLOAT_PROPS = ["centroid_y", "centroid_x", "perimeter", "eccentricity", "axis_major_length",
               "axis_minor_length", "extent"]


def make_label_image(shape=(64, 64), cells=((32, 32, 8),)):
    lbl = np.zeros(shape, dtype=np.int32)
    for i, (cy, cx, r) in enumerate(cells, start=1):
        lbl[ref.disk_mask(shape, cy, cx, r)] = i
    return lbl


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable copy


def trimmed(props, key):
    valid = props["valid"].numpy()
    return props[key].numpy()[valid]


# -- twins of tests/test_regionprops.py ------------------------------------------


class TestMorphologyProps:
    def test_disk_area_and_centroid(self):
        lbl = make_label_image(cells=[(20, 24, 7), (45, 40, 10)])
        props = measure_labels(t(lbl), max_cells=8)
        exp0 = ref.disk_mask((64, 64), 20, 24, 7).sum()
        exp1 = ref.disk_mask((64, 64), 45, 40, 10).sum()
        np.testing.assert_allclose(trimmed(props, "area"), [exp0, exp1])
        np.testing.assert_allclose(trimmed(props, "centroid_y"), [20, 45], atol=0.01)
        np.testing.assert_allclose(trimmed(props, "centroid_x"), [24, 40], atol=0.01)

    def test_circularity_of_disk(self):
        props = measure_labels(t(make_label_image(cells=[(32, 32, 10)])), max_cells=4)
        area = trimmed(props, "area")[0]
        perim = trimmed(props, "perimeter")[0]
        assert 4 * np.pi * area / perim**2 > 0.85

    def test_perimeter_matches_reference(self):
        lbl = make_label_image(cells=[(20, 20, 9), (45, 45, 6)])
        perims = trimmed(measure_labels(t(lbl), max_cells=8), "perimeter")
        for k, expected_label in enumerate([1, 2]):
            assert perims[k] == pytest.approx(ref.perimeter(lbl == expected_label), rel=1e-5)

    def test_perimeter_matches_reference_random_blobs(self, rng):
        noise = ndi.gaussian_filter(rng.random((96, 96)), 2.5)
        mask = noise > np.quantile(noise, 0.7)
        lbl = label(t(mask))
        n = int(lbl.max())
        perims = trimmed(measure_labels(lbl, max_cells=64), "perimeter")
        lbl = lbl.numpy()
        for k in range(n):
            expected = ref.perimeter(lbl == k + 1)
            assert perims[k] == pytest.approx(expected, rel=1e-4), f"label {k + 1}"

    def test_ellipse_axes_and_orientation(self):
        yy, xx = np.mgrid[0:80, 0:80]
        ellipse = ((yy - 40) / 18.0) ** 2 + ((xx - 40) / 9.0) ** 2 <= 1
        props = measure_labels(t(ellipse.astype(np.int32)), max_cells=4)
        expected = ref.region_moments(ellipse)
        for name in ("axis_major_length", "axis_minor_length", "eccentricity"):
            assert trimmed(props, name)[0] == pytest.approx(expected[name], rel=1e-4)
        assert trimmed(props, "orientation")[0] == pytest.approx(expected["orientation"], abs=1e-4)
        ratio = trimmed(props, "axis_major_length")[0] / trimmed(props, "axis_minor_length")[0]
        assert ratio == pytest.approx(2.0, rel=0.03)

    def test_rotated_ellipse_orientation(self):
        yy, xx = np.mgrid[0:100, 0:100]
        theta = np.deg2rad(30)
        yr = (yy - 50) * np.cos(theta) - (xx - 50) * np.sin(theta)
        xr = (yy - 50) * np.sin(theta) + (xx - 50) * np.cos(theta)
        ellipse = (yr / 20.0) ** 2 + (xr / 8.0) ** 2 <= 1
        props = measure_labels(t(ellipse.astype(np.int32)), max_cells=4)
        expected = ref.region_moments(ellipse)
        assert trimmed(props, "orientation")[0] == pytest.approx(expected["orientation"], abs=1e-3)

    def test_bbox(self):
        props = measure_labels(t(make_label_image(cells=[(20, 24, 5)])), max_cells=4)
        assert trimmed(props, "bbox_min_row")[0] == 15
        assert trimmed(props, "bbox_max_row")[0] == 26
        assert trimmed(props, "bbox_min_col")[0] == 19
        assert trimmed(props, "bbox_max_col")[0] == 30

    def test_valid_mask_padding(self):
        props = measure_labels(t(make_label_image(cells=[(20, 24, 5)])), max_cells=16)
        valid = props["valid"].numpy()
        assert valid.sum() == 1
        assert valid[0]
        assert not valid[1:].any()


class TestIntensityProps:
    def test_constant_region(self):
        lbl = make_label_image(cells=[(32, 32, 6)])
        img = np.where(lbl > 0, 500, 10).astype(np.uint16)
        props = measure_intensity(t(lbl), t(img), max_cells=4)
        for stat in ("intensity_mean", "intensity_max", "intensity_min"):
            assert props[stat][0] == 500
        assert props["intensity_std"][0] == 0

    def test_matches_numpy(self, rng):
        lbl = make_label_image(cells=[(20, 20, 7), (45, 45, 9)])
        img = (rng.random((64, 64)) * 1000).astype(np.uint16)
        props = {k: v.numpy() for k, v in measure_intensity(t(lbl), t(img), max_cells=8).items()}
        for k in (1, 2):
            vals = img[lbl == k].astype(np.float64)
            assert props["intensity_mean"][k - 1] == pytest.approx(vals.mean(), rel=1e-5)
            assert props["intensity_max"][k - 1] == vals.max()
            assert props["intensity_min"][k - 1] == vals.min()
            assert props["intensity_std"][k - 1] == pytest.approx(vals.std(), rel=1e-4)


class TestIntensityStdPrecision:
    """Uniform regions at uint16-scale intensities must read std ~= 0."""

    def test_uniform_bright_region_zero_std(self):
        lbl = np.zeros((64, 64), np.int32)
        lbl[8:40, 8:40] = 1
        img = np.where(lbl > 0, 50000, 120).astype(np.uint16)
        stats = measure_intensity(t(lbl), t(img), max_cells=4)
        assert float(stats["intensity_mean"][0]) == 50000.0
        assert float(stats["intensity_std"][0]) < 1.0

    def test_uniform_bright_region_compacted_path(self):
        from arcadia_microscopy_tools_tpu_torch.ops.compaction import compact_by_root
        from arcadia_microscopy_tools_tpu_torch.ops.labeling import component_roots

        mask = np.zeros((128, 128), bool)
        mask[16:80, 16:80] = True
        roots, _ = component_roots(t(mask))
        comp = compact_by_root(roots, 8192)
        stack = np.where(mask, 60000, 50)[None].astype(np.uint16)
        _, intensity = regionprops.measure_compacted(comp.seg, comp.idx, roots, t(stack), 16, 128)
        assert float(intensity[0]["intensity_mean"][0]) == 60000.0
        assert float(intensity[0]["intensity_std"][0]) < 1.0

    def test_true_std_still_correct(self):
        rng = np.random.default_rng(5)
        lbl = np.zeros((64, 64), np.int32)
        lbl[4:60, 4:60] = 1
        img = np.clip(rng.normal(30000, 500, (64, 64)), 0, 65535).astype(np.uint16)
        stats = measure_intensity(t(lbl), t(img), max_cells=4)
        region = img[lbl > 0].astype(np.float64)
        np.testing.assert_allclose(float(stats["intensity_std"][0]), region.std(), rtol=2e-3)


class TestTableLookup:
    """The port's `table_lookup` is a plain gather: exact for every 32-bit
    payload class, and an error (not a silent zero) for ids out of range."""

    def test_f32_bit_exact_incl_nonfinite(self):
        rng = np.random.default_rng(0)
        tab = (rng.standard_normal(1025) * 1e6).astype(np.float32)
        tab[3], tab[5], tab[7], tab[9] = np.inf, -np.inf, np.nan, -0.0
        ids = rng.integers(0, 1025, 200_003)
        got = table_lookup(t(tab)[None], t(ids)[None])[0].numpy()
        np.testing.assert_array_equal(got.view(np.uint32), tab[ids].view(np.uint32))

    def test_multi_table_int32(self):
        rng = np.random.default_rng(1)
        tabs = rng.integers(-(2**31), 2**31 - 1, (3, 517), dtype=np.int32)
        ids = rng.integers(0, 517, (3, 10_001))
        np.testing.assert_array_equal(
            table_lookup(t(tabs), t(ids)).numpy(), np.take_along_axis(tabs, ids, 1)
        )

    def test_out_of_range_ids_raise(self):
        tab = torch.arange(1, 9, dtype=torch.int32)[None]
        with pytest.raises(RuntimeError):
            table_lookup(tab, torch.tensor([[0, 7, 8, 100]]))


# -- the port against the JAX package ------------------------------------------------


def _blob_labels(seed: int, shape=(96, 128)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    noise = ndi.gaussian_filter(rng.random(shape), 2.5)
    return np.asarray(jax_labeling.label(jnp.asarray(noise > np.quantile(noise, 0.7))))


def _exact_ties(lbl: np.ndarray, max_cells: int) -> np.ndarray:
    """Per slot: whether the cell's exact central moments tie (mu20 == mu02)."""
    tie = np.zeros(max_cells, bool)
    for k in range(1, min(int(lbl.max()), max_cells - 1) + 1):
        ys, xs = np.nonzero(lbl == k)
        ys, xs, m = ys.astype(np.int64), xs.astype(np.int64), len(ys)
        tie[k - 1] = m * (ys * ys).sum() - ys.sum() ** 2 == m * (xs * xs).sum() - xs.sum() ** 2
    return tie


def _hold_morphology(ours: dict, theirs: dict, lbl: np.ndarray, max_cells: int) -> None:
    assert set(ours) == set(theirs)
    for name in INTEGER_PROPS:
        np.testing.assert_array_equal(ours[name].numpy(), np.asarray(theirs[name]), err_msg=name)
    for name in FLOAT_PROPS:
        np.testing.assert_allclose(ours[name].numpy(), np.asarray(theirs[name]), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    for name, dtype in jax_regionprops.PROPERTY_DTYPES.items():
        assert str(ours[name].dtype) == f"torch.{np.dtype(dtype).name}", name
    o, r = ours["orientation"].numpy(), np.asarray(theirs["orientation"])
    d = np.abs(o - r)
    d = np.minimum(d, np.pi - d)
    held = (np.asarray(theirs["eccentricity"]) > 0.3) & ~_exact_ties(lbl, max_cells)
    held[-1] = False  # may merge several cells
    assert (d[held] <= 1e-4).all()


@pytest.mark.parametrize("max_cells", [64, 12])
@pytest.mark.parametrize("seed", [0, 1])
def test_measure_labels_matches_jax(seed, max_cells):
    """max_cells 12 is below the label count: the last slot merges the rest
    and is invalid in both; 64 leaves empty slots."""
    lbl = _blob_labels(seed)
    assert 12 < lbl.max() < 64
    ours = measure_labels(t(lbl), max_cells)
    _hold_morphology(ours, jax_regionprops.measure_labels(lbl, max_cells), lbl, max_cells)
    if max_cells == 12:
        assert not bool(ours["valid"][-1])
    else:
        assert not ours["valid"][lbl.max():].any()


def test_measure_labels_sparse_int64_labels_match_jax():
    """Gaps in the label values (as after clear_border), in an int64 image."""
    lbl = _blob_labels(2).astype(np.int64) * 3
    lbl[lbl > 60] = 0
    ours = measure_labels(t(lbl), 64)
    _hold_morphology(ours, jax_regionprops.measure_labels(lbl, 64), lbl, 64)


def _hold_intensity(ours: dict, theirs: dict) -> None:
    for stat in ("intensity_min", "intensity_max"):
        np.testing.assert_array_equal(ours[stat].numpy(), np.asarray(theirs[stat]), err_msg=stat)
    for stat in ("intensity_mean", "intensity_std"):
        np.testing.assert_allclose(ours[stat].numpy(), np.asarray(theirs[stat]), rtol=RTOL,
                                   err_msg=stat)
    assert all(v.dtype == torch.float32 for v in ours.values())


@pytest.mark.parametrize("max_cells", [64, 12])
def test_measure_intensity_stack_matches_jax(max_cells):
    lbl = _blob_labels(0)
    rng = np.random.default_rng(3)
    stack = rng.integers(0, 65535, (3,) + lbl.shape).astype(np.uint16)
    stack[1] = np.where(lbl > 0, 50000, 7)  # uniform cells: std 0
    ours = regionprops.measure_intensity_stack(t(lbl), t(stack), max_cells)
    theirs = jax_regionprops.measure_intensity_stack(lbl, stack, max_cells)
    assert set(ours) == set(theirs) == {0, 1, 2}
    for ci in ours:
        _hold_intensity(ours[ci], theirs[ci])
    empty = ~measure_labels(t(lbl), max_cells)["valid"].numpy()
    if max_cells == 64:  # empty slots read +inf / -inf
        assert np.isposinf(ours[0]["intensity_min"].numpy()[empty]).all()
        assert np.isneginf(ours[0]["intensity_max"].numpy()[empty]).all()


def test_measure_intensity_matches_jax():
    lbl = _blob_labels(1)
    img = np.random.default_rng(4).integers(0, 4000, lbl.shape).astype(np.uint16)
    _hold_intensity(measure_intensity(t(lbl), t(img), 64),
                    jax_regionprops.measure_intensity(lbl, img, 64))
