"""PyTorch port: `SegmentationMask` - twins of tests/test_masks.py run
through the port on the CPU, then the port against the JAX package's
`SegmentationMask` on the same bool and integer masks, and on the card
against the CPU (gpu-marked).

Tolerances against the JAX package (which sums in float32 through bf16
hi/lo splits; the port sums in float64): label images and every integer
column equal; the host columns (convex areas, solidity, Feret diameters,
the moment families, outlines) equal, since both compute them with the same
numpy code from equal label images; the other float columns rtol 1e-5 plus
atol 1e-4, orientation only on elongated cells whose exact moments do not
tie (mu20 == mu02 gives +-pi/4 by the last bit of the sums);
intensity_min and intensity_max equal; intensity_mean and intensity_std
rtol 1e-5. Integer labels at or above 2^31 stay distinct cells in the port,
where the JAX package's int32 arithmetic wraps them.
"""

import numpy as np
import pytest
import torch

import reference_impl as ref
from arcadia_microscopy_tools_tpu_torch import _native
from arcadia_microscopy_tools_tpu_torch.channels import DAPI, FITC
from arcadia_microscopy_tools_tpu_torch.masks import (
    DEFAULT_CELL_PROPERTY_NAMES,
    DEFAULT_INTENSITY_PROPERTY_NAMES,
    _extract_outlines_skimage,
)
from arcadia_microscopy_tools_tpu_torch.masks import SegmentationMask as PortMask

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def native_library():
    """The port's own build of the host geometry library, as the JAX
    package loads its copy (a no-op when it is built)."""
    _native.build()


def SegmentationMask(*args, **kwargs):
    """The port's class on the CPU, where the twins run."""
    kwargs.setdefault("device", "cpu")
    return PortMask(*args, **kwargs)


def make_label_image(shape=(50, 50), cells=None):
    label_image = np.zeros(shape, dtype=np.int64)
    if cells is None:
        cells = [(shape[0] // 2, shape[1] // 2, 8)]
    for label, (cy, cx, r) in enumerate(cells, start=1):
        label_image[ref.disk_mask(shape, cy, cx, r)] = label
    return label_image


def _make_mask(label_image):
    return SegmentationMask(mask_image=label_image, remove_edge_cells=False)


def _make_mask_with_intensity(label_image):
    rng = np.random.default_rng(42)
    dapi_img = rng.integers(100, 1000, size=label_image.shape).astype(np.uint16)
    fitc_img = rng.integers(0, 500, size=label_image.shape).astype(np.uint16)
    return SegmentationMask(
        mask_image=label_image,
        intensity_image_dict={DAPI: dapi_img, FITC: fitc_img},
        remove_edge_cells=False,
    )


@pytest.fixture
def interior_cell_image():
    return make_label_image(shape=(50, 50), cells=[(25, 25, 8)])


@pytest.fixture
def multi_cell_image():
    return make_label_image(shape=(60, 60), cells=[(15, 15, 6), (45, 45, 6)])


class TestValidation:
    def test_not_ndarray_raises(self):
        with pytest.raises(TypeError, match="numpy array"):
            SegmentationMask(mask_image=[[1, 2], [3, 4]])

    def test_non_2d_raises(self):
        with pytest.raises(ValueError, match="2D"):
            SegmentationMask(mask_image=np.ones((2, 2, 2), dtype=np.int64))

    def test_negative_values_raise(self):
        arr = np.zeros((5, 5), dtype=np.int64)
        arr[2, 2] = -1
        with pytest.raises(ValueError, match="non-negative"):
            SegmentationMask(mask_image=arr)

    def test_empty_mask_raises(self):
        with pytest.raises(ValueError, match="no cells"):
            SegmentationMask(mask_image=np.zeros((5, 5), dtype=np.int64))

    def test_intensity_shape_mismatch_raises(self, interior_cell_image):
        with pytest.raises(ValueError, match="same shape"):
            SegmentationMask(
                mask_image=interior_cell_image,
                intensity_image_dict={DAPI: np.zeros((3, 3), dtype=np.uint16)},
            )

    def test_intensity_not_mapping_raises(self, interior_cell_image):
        with pytest.raises(TypeError, match="Mapping"):
            SegmentationMask(
                mask_image=interior_cell_image,
                intensity_image_dict=[np.zeros((50, 50), dtype=np.uint16)],
            )

    def test_default_property_names(self, interior_cell_image):
        mask = _make_mask(interior_cell_image)
        assert mask.property_names == DEFAULT_CELL_PROPERTY_NAMES

    def test_default_intensity_property_names(self, interior_cell_image):
        mask = _make_mask_with_intensity(interior_cell_image)
        assert mask.intensity_property_names == DEFAULT_INTENSITY_PROPERTY_NAMES

    def test_immutability(self, interior_cell_image):
        mask = _make_mask(interior_cell_image)
        with pytest.raises(AttributeError, match="Cannot modify"):
            mask.mask_image = interior_cell_image
        with pytest.raises(AttributeError, match="Cannot modify"):
            mask.remove_edge_cells = True


class TestLabelImage:
    def test_bool_input_labeled(self):
        mask_bool = make_label_image(cells=[(25, 25, 6)]) > 0
        mask = SegmentationMask(mask_image=mask_bool, remove_edge_cells=False)
        assert mask.num_cells == 1
        assert mask.label_image.dtype == np.int64

    def test_remove_edge_cells(self):
        img = make_label_image(shape=(40, 40), cells=[(0, 0, 6), (20, 20, 6)])
        mask = SegmentationMask(mask_image=img, remove_edge_cells=True)
        assert mask.num_cells == 1
        # the surviving cell is the interior one, relabeled to 1
        assert mask.label_image[20, 20] == 1

    def test_all_edge_cells_raises(self):
        img = make_label_image(shape=(20, 20), cells=[(0, 0, 5)])
        mask = SegmentationMask(mask_image=img, remove_edge_cells=True)
        with pytest.raises(ValueError, match="No cells remain"):
            _ = mask.label_image

    def test_labels_consecutive_after_gap(self):
        img = make_label_image(shape=(60, 60), cells=[(15, 15, 6), (45, 45, 6)])
        img[img == 1] = 7  # introduce a gap
        mask = SegmentationMask(mask_image=img, remove_edge_cells=False)
        assert mask.num_cells == 2
        assert set(np.unique(mask.label_image)) == {0, 1, 2}


class TestCellProperties:
    def test_centroids_within_2px(self, multi_cell_image):
        mask = _make_mask(multi_cell_image)
        centroids = mask.centroids_yx
        assert centroids.shape == (2, 2)
        np.testing.assert_allclose(centroids[0], [15, 15], atol=2)
        np.testing.assert_allclose(centroids[1], [45, 45], atol=2)

    def test_disk_circularity_above_085(self, interior_cell_image):
        mask = _make_mask(interior_cell_image)
        circ = mask.cell_properties["circularity"]
        assert circ[0] > 0.85

    def test_property_keys(self, interior_cell_image):
        mask = _make_mask(interior_cell_image)
        props = mask.cell_properties
        for key in (
            "label",
            "centroid_y",
            "centroid_x",
            "area",
            "area_convex",
            "perimeter",
            "eccentricity",
            "circularity",
            "solidity",
            "axis_major_length",
            "axis_minor_length",
            "orientation",
            "volume",
        ):
            assert key in props, key
            assert len(props[key]) == 1

    def test_disk_solidity_near_one(self, interior_cell_image):
        mask = _make_mask(interior_cell_image)
        assert mask.cell_properties["solidity"][0] > 0.92

    def test_moments_match_bruteforce(self, multi_cell_image):
        """Raw/central moments equal the per-region numpy definition
        (bbox-local coordinates, skimage convention)."""
        mask = SegmentationMask(
            mask_image=multi_cell_image,
            remove_edge_cells=False,
            property_names=["label", "moments", "moments_central"],
        )
        props = mask.cell_properties
        lbl = mask.label_image
        for k in range(1, mask.num_cells + 1):
            ys, xs = np.nonzero(lbl == k)
            ry = (ys - ys.min()).astype(float)
            cx = (xs - xs.min()).astype(float)
            dy = ry - ry.mean()
            dx = cx - cx.mean()
            for p in range(4):
                for q in range(4):
                    np.testing.assert_allclose(
                        props[f"moments-{p}-{q}"][k - 1],
                        (ry**p * cx**q).sum(),
                        rtol=1e-10,
                    )
                    np.testing.assert_allclose(
                        props[f"moments_central-{p}-{q}"][k - 1],
                        (dy**p * dx**q).sum(),
                        rtol=1e-9,
                        atol=1e-6,
                    )

    def test_inertia_tensor_consistent_with_axes(self, interior_cell_image):
        """Eigenvalues of the inertia tensor reproduce the axis lengths the
        device kernel reports (skimage: major = 4*sqrt(lam_max))."""
        mask = SegmentationMask(
            mask_image=interior_cell_image,
            remove_edge_cells=False,
            property_names=[
                "label",
                "inertia_tensor",
                "inertia_tensor_eigvals",
                "axis_major_length",
                "axis_minor_length",
            ],
        )
        props = mask.cell_properties
        lam0 = props["inertia_tensor_eigvals-0"][0]
        lam1 = props["inertia_tensor_eigvals-1"][0]
        assert lam0 >= lam1
        np.testing.assert_allclose(
            4 * np.sqrt(lam0), props["axis_major_length"][0], rtol=1e-4
        )
        np.testing.assert_allclose(
            4 * np.sqrt(lam1), props["axis_minor_length"][0], rtol=1e-4
        )
        # tensor trace = sum of eigenvalues
        np.testing.assert_allclose(
            props["inertia_tensor-0-0"][0] + props["inertia_tensor-1-1"][0],
            lam0 + lam1,
            rtol=1e-10,
        )

    def test_feret_diameter_of_disk(self, interior_cell_image):
        """A radius-r disk's max Feret diameter is ~2r (sub-pixel contour)."""
        mask = SegmentationMask(
            mask_image=interior_cell_image,
            remove_edge_cells=False,
            property_names=["label", "feret_diameter_max"],
        )
        d = mask.cell_properties["feret_diameter_max"][0]
        assert 15.0 <= d <= 19.0  # interior_cell_image has a radius-8 disk

    def test_moments_normalized_scale_invariant(self):
        """Normalized central moments are identical for scaled disks."""
        a = make_label_image(shape=(64, 64), cells=[(32, 32, 8)])
        b = make_label_image(shape=(128, 128), cells=[(64, 64, 16)])
        out = []
        for img in (a, b):
            m = SegmentationMask(
                mask_image=img,
                remove_edge_cells=False,
                property_names=["label", "moments_normalized"],
            )
            out.append(m.cell_properties["moments_normalized-2-0"][0])
        np.testing.assert_allclose(out[0], out[1], rtol=0.05)

    def test_unsupported_property_lists_supported(self, interior_cell_image):
        mask = SegmentationMask(
            mask_image=interior_cell_image,
            remove_edge_cells=False,
            property_names=["label", "definitely_not_a_property"],
        )
        with pytest.raises(ValueError, match="Supported names"):
            _ = mask.cell_properties

    def test_micron_conversion_reaches_tensors(self, interior_cell_image):
        mask = SegmentationMask(
            mask_image=interior_cell_image,
            remove_edge_cells=False,
            property_names=["label", "inertia_tensor_eigvals", "feret_diameter_max"],
        )
        converted = mask.convert_properties_to_microns(0.5)
        base = mask.cell_properties
        np.testing.assert_allclose(
            converted["inertia_tensor_eigvals-0_um2"],
            base["inertia_tensor_eigvals-0"] * 0.25,
        )
        np.testing.assert_allclose(
            converted["feret_diameter_max_um"], base["feret_diameter_max"] * 0.5
        )

    def test_area_matches_pixel_count(self, multi_cell_image):
        mask = _make_mask(multi_cell_image)
        areas = mask.cell_properties["area"]
        for k in (1, 2):
            assert areas[k - 1] == (multi_cell_image == k).sum()

    def test_volume_prolate_spheroid(self, interior_cell_image):
        mask = _make_mask(interior_cell_image)
        props = mask.cell_properties
        a = props["axis_major_length"][0] / 2
        b = props["axis_minor_length"][0] / 2
        np.testing.assert_allclose(props["volume"][0], 4 / 3 * np.pi * a * b * b, rtol=1e-6)

    def test_intensity_properties_suffixed(self, interior_cell_image):
        mask = _make_mask_with_intensity(interior_cell_image)
        props = mask.cell_properties
        for base in DEFAULT_INTENSITY_PROPERTY_NAMES:
            assert f"{base}_dapi" in props
            assert f"{base}_fitc" in props

    def test_intensity_values_match_numpy(self, interior_cell_image):
        mask = _make_mask_with_intensity(interior_cell_image)
        dapi = mask.intensity_image_dict[DAPI]
        region = dapi[mask.label_image == 1].astype(np.float64)
        props = mask.cell_properties
        assert props["intensity_mean_dapi"][0] == pytest.approx(region.mean(), rel=1e-6)
        assert props["intensity_max_dapi"][0] == region.max()
        assert props["intensity_min_dapi"][0] == region.min()
        assert props["intensity_std_dapi"][0] == pytest.approx(region.std(), rel=1e-4)

    def test_custom_property_subset(self, interior_cell_image):
        mask = SegmentationMask(
            mask_image=interior_cell_image,
            remove_edge_cells=False,
            property_names=["label", "area"],
        )
        props = mask.cell_properties
        assert set(props.keys()) == {"label", "area"}

    def test_centroids_warns_without_centroid(self, interior_cell_image):
        mask = SegmentationMask(
            mask_image=interior_cell_image,
            remove_edge_cells=False,
            property_names=["label", "area"],
        )
        with pytest.warns(UserWarning, match="Centroid property not available"):
            out = mask.centroids_yx
        assert out.shape == (0, 2)

    def test_perimeter_matches_reference(self, multi_cell_image):
        mask = _make_mask(multi_cell_image)
        perims = mask.cell_properties["perimeter"]
        for k in (1, 2):
            expected = ref.perimeter(mask.label_image == k)
            assert perims[k - 1] == pytest.approx(expected, rel=1e-5)

    def test_area_convex_close_to_reference(self, interior_cell_image):
        mask = _make_mask(interior_cell_image)
        got = mask.cell_properties["area_convex"][0]
        expected = ref.convex_area(mask.label_image == 1)
        # rasterization boundary tolerance
        assert abs(got - expected) <= 0.05 * expected + 5


class TestFilter:
    def test_filter_by_area(self):
        img = make_label_image(shape=(80, 80), cells=[(20, 20, 4), (55, 55, 10)])
        mask = _make_mask(img)
        big_only = mask.filter("area", min_value=150)
        assert big_only.num_cells == 1
        np.testing.assert_allclose(big_only.centroids_yx[0], [55, 55], atol=2)

    def test_filter_max_value(self):
        img = make_label_image(shape=(80, 80), cells=[(20, 20, 4), (55, 55, 10)])
        mask = _make_mask(img)
        small_only = mask.filter("area", max_value=150)
        assert small_only.num_cells == 1
        np.testing.assert_allclose(small_only.centroids_yx[0], [20, 20], atol=2)

    def test_filter_requires_bound(self, interior_cell_image):
        mask = _make_mask(interior_cell_image)
        with pytest.raises(ValueError, match="At least one"):
            mask.filter("area")

    def test_filter_unknown_property(self, interior_cell_image):
        mask = _make_mask(interior_cell_image)
        with pytest.raises(ValueError, match="not found"):
            mask.filter("bogus", min_value=1)

    def test_filter_nothing_remains(self, interior_cell_image):
        mask = _make_mask(interior_cell_image)
        with pytest.raises(ValueError, match="No cells remain"):
            mask.filter("area", min_value=1e9)

    def test_filter_preserves_intensity_dict(self, multi_cell_image):
        mask = _make_mask_with_intensity(multi_cell_image)
        filtered = mask.filter("area", min_value=1)
        assert filtered.intensity_image_dict is not None
        assert set(filtered.intensity_image_dict) == {DAPI, FITC}


    def test_filter_chaining(self, multi_cell_image):
        """Filters compose: each derived mask filters again from its own
        property table (reference behavior)."""
        mask = SegmentationMask(multi_cell_image, remove_edge_cells=False)
        step1 = mask.filter("area", min_value=1)
        step2 = step1.filter("circularity", min_value=0.0)
        assert step2.num_cells <= step1.num_cells <= mask.num_cells
        assert step2.num_cells >= 1

    def test_only_circularity_requested_no_leaked_columns(self, interior_cell_image):
        """Requesting only a derived property must not leak its ingredients
        (area/perimeter) into the output table."""
        mask = SegmentationMask(
            interior_cell_image,
            remove_edge_cells=False,
            property_names=["circularity"],
        )
        assert set(mask.cell_properties) == {"circularity"}


class TestConvertToMicrons:
    def test_scaling_rules(self, interior_cell_image):
        mask = _make_mask(interior_cell_image)
        px = 0.5
        converted = mask.convert_properties_to_microns(px)
        props = mask.cell_properties
        np.testing.assert_allclose(converted["area_um2"], props["area"] * px**2)
        np.testing.assert_allclose(converted["perimeter_um"], props["perimeter"] * px)
        np.testing.assert_allclose(converted["volume_um3"], props["volume"] * px**3)
        # dimensionless unchanged
        np.testing.assert_allclose(converted["circularity"], props["circularity"])
        np.testing.assert_allclose(converted["eccentricity"], props["eccentricity"])
        assert "centroid_y" in converted  # centroids stay in pixels


class TestOutlines:
    def test_outline_count_and_format(self, multi_cell_image):
        mask = _make_mask(multi_cell_image)
        outlines = mask.cell_outlines
        assert len(outlines) == 2
        for outline in outlines:
            assert outline.ndim == 2 and outline.shape[1] == 2

    def test_outline_surrounds_centroid(self, interior_cell_image):
        mask = _make_mask(interior_cell_image)
        outline = mask.cell_outlines[0]
        cy, cx = mask.centroids_yx[0]
        assert outline[:, 0].min() < cy < outline[:, 0].max()
        assert outline[:, 1].min() < cx < outline[:, 1].max()

    def test_skimage_extractor_subpixel(self, interior_cell_image):
        mask = SegmentationMask(
            mask_image=interior_cell_image,
            remove_edge_cells=False,
            outline_extractor="skimage",
        )
        outline = mask.cell_outlines[0]
        assert len(outline) > 0
        # marching squares yields half-integer crossings
        assert np.any(outline % 1 != 0)

    def test_skimage_outline_closed(self, interior_cell_image):
        outlines = _extract_outlines_skimage(interior_cell_image)
        outline = outlines[0]
        np.testing.assert_allclose(outline[0], outline[-1])

    def test_border_touching_cell_outline(self):
        img = make_label_image(shape=(30, 30), cells=[(0, 15, 6)])
        mask = SegmentationMask(mask_image=img, remove_edge_cells=False)
        outline = mask.cell_outlines[0]
        assert len(outline) > 0

    def test_outline_radius_approx(self, interior_cell_image):
        mask = _make_mask(interior_cell_image)
        outline = mask.cell_outlines[0]
        d = np.hypot(outline[:, 0] - 25, outline[:, 1] - 25)
        assert abs(d.mean() - 8) < 1.5


class TestInertiaTensorConvention:
    def test_horizontal_bar_tensor_axes(self):
        """skimage's inertia_tensor-0-0 carries the COLUMN spread (inertia
        about axis 0): for a 1-row horizontal bar it is large while -1-1 is
        ~0. Regression for a swapped diagonal that eigenvalue tests cannot
        catch (trace and eigvals are swap-invariant)."""
        mask = np.zeros((16, 16), np.int64)
        mask[8, 3:13] = 1  # 1 x 10 horizontal bar
        sm = SegmentationMask(
            mask, remove_edge_cells=False, property_names=["inertia_tensor"]
        )
        t = sm.cell_properties
        # column spread of 10 consecutive columns: mean of (dc^2) = 8.25
        np.testing.assert_allclose(t["inertia_tensor-0-0"][0], 8.25, atol=1e-6)
        np.testing.assert_allclose(t["inertia_tensor-1-1"][0], 0.0, atol=1e-6)

    def test_default_column_order_matches_request(self):
        mask = np.zeros((16, 16), np.int64)
        mask[4:10, 4:10] = 1
        sm = SegmentationMask(mask, remove_edge_cells=False)
        cols = list(sm.cell_properties)
        # derived properties sit at their requested positions, not the tail
        assert cols.index("volume") < cols.index("area")
        assert cols.index("circularity") < cols.index("solidity")


# -- the port against the JAX package ------------------------------------------------

RTOL, ATOL = 1e-5, 1e-4
# columns computed on the host from the label image, by the same numpy code
_HOST_PREFIXES = ("area_convex", "solidity", "feret_diameter_max", "moments", "inertia_tensor")


def _blob_mask(seed: int, shape=(96, 120)) -> np.ndarray:
    from scipy import ndimage as ndi

    noise = ndi.gaussian_filter(np.random.default_rng(seed).random(shape), 2.5)
    return noise > np.quantile(noise, 0.7)


def _int_mask(seed: int) -> np.ndarray:
    """Blob components as an int64 label image with gaps in its values."""
    from scipy import ndimage as ndi

    lbl, _ = ndi.label(_blob_mask(seed), structure=np.ones((3, 3)))
    return (lbl * 5).astype(np.int64)


def _planes(shape, seed=7):
    rng = np.random.default_rng(seed)
    return {DAPI: rng.integers(0, 60000, shape).astype(np.uint16),
            FITC: rng.integers(0, 4000, shape).astype(np.uint16)}


def _jax_pair(mask, planes=None, **kwargs):
    """(JAX, port) SegmentationMask on the same inputs; the port on the CPU."""
    from arcadia_microscopy_tools_tpu.channels import DAPI as JAX_DAPI
    from arcadia_microscopy_tools_tpu.channels import FITC as JAX_FITC
    from arcadia_microscopy_tools_tpu.masks import SegmentationMask as JaxMask

    jax_planes = None
    if planes is not None:
        jax_planes = {{DAPI: JAX_DAPI, FITC: JAX_FITC}[ch]: p for ch, p in planes.items()}
    return JaxMask(mask, jax_planes, **kwargs), SegmentationMask(mask, planes, **kwargs)


def _exact_ties(lbl: np.ndarray) -> np.ndarray:
    """Per cell: whether its exact central moments tie (mu20 == mu02)."""
    ties = []
    for k in range(1, int(lbl.max()) + 1):
        ys, xs = np.nonzero(lbl == k)
        ys, xs, m = ys.astype(np.int64), xs.astype(np.int64), len(ys)
        ties.append(m * (ys * ys).sum() - ys.sum() ** 2 == m * (xs * xs).sum() - xs.sum() ** 2)
    return np.array(ties, bool)


def _hold_tables(jax_mask, port_mask) -> None:
    """`port_mask`'s label image and table against `jax_mask`'s (or, on the
    card, against the port's own on the CPU)."""
    np.testing.assert_array_equal(port_mask.label_image, jax_mask.label_image)
    assert port_mask.label_image.dtype == np.int64
    assert port_mask.num_cells == jax_mask.num_cells
    theirs, ours = jax_mask.cell_properties, port_mask.cell_properties
    assert list(ours) == list(theirs)
    for name, want in theirs.items():
        got = ours[name]
        assert got.dtype == want.dtype, name
        if want.dtype.kind in "iub" or name.startswith(_HOST_PREFIXES) or name.startswith(
            ("intensity_min", "intensity_max")
        ):
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name.startswith(("intensity_mean", "intensity_std")):
            np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name)
        elif name == "orientation":
            d = np.abs(got - want)
            d = np.minimum(d, np.pi - d)
            held = (theirs["eccentricity"] > 0.3) & ~_exact_ties(jax_mask.label_image)
            assert (d[held] <= 1e-4).all()
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)


MASKS = {"bool": lambda: _blob_mask(0), "int64 with gaps": lambda: _int_mask(1)}


@pytest.mark.parametrize("with_planes", [False, True])
@pytest.mark.parametrize("remove_edge_cells", [True, False])
@pytest.mark.parametrize("kind", list(MASKS))
def test_default_table_matches_jax(kind, remove_edge_cells, with_planes):
    mask = MASKS[kind]()
    planes = _planes(mask.shape) if with_planes else None
    _hold_tables(*_jax_pair(mask, planes, remove_edge_cells=remove_edge_cells))


@pytest.mark.parametrize("kind", list(MASKS))
def test_every_supported_column_matches_jax(kind):
    from arcadia_microscopy_tools_tpu_torch.masks import SUPPORTED_PROPERTY_NAMES

    mask = MASKS[kind]()
    pair = _jax_pair(mask, _planes(mask.shape), property_names=list(SUPPORTED_PROPERTY_NAMES))
    _hold_tables(*pair)
    np.testing.assert_allclose(
        pair[1].centroids_yx, pair[0].centroids_yx, rtol=RTOL, atol=ATOL
    )
    converted = [m.convert_properties_to_microns(0.325) for m in pair]
    assert list(converted[1]) == list(converted[0])


@pytest.mark.parametrize("extractor", ["cellpose", "skimage"])
def test_outlines_match_jax(extractor):
    jax_mask, port_mask = _jax_pair(_blob_mask(3), outline_extractor=extractor)
    assert len(port_mask.cell_outlines) == len(jax_mask.cell_outlines)
    for got, want in zip(port_mask.cell_outlines, jax_mask.cell_outlines):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", list(MASKS))
def test_filter_matches_jax(kind):
    mask = MASKS[kind]()
    jax_mask, port_mask = _jax_pair(mask, _planes(mask.shape))
    jax_child = jax_mask.filter("area", min_value=60).filter("circularity", max_value=0.9)
    port_child = port_mask.filter("area", min_value=60).filter("circularity", max_value=0.9)
    assert port_child.device == port_mask.device == torch.device("cpu")
    _hold_tables(jax_child, port_child)


def test_labels_at_and_above_2_31_stay_distinct():
    """The port keeps int64 labels: 7, 2^31 and 2^32 + 7 are three cells
    (int32 arithmetic would wrap 2^32 + 7 onto 7 and 2^31 below zero)."""
    lbl = np.zeros((20, 24), np.int64)
    lbl[3:7, 3:7] = 7
    lbl[10:15, 4:9] = 2**31
    lbl[4:9, 14:19] = 2**32 + 7
    m = SegmentationMask(lbl, remove_edge_cells=False, property_names=["label", "area"])
    assert m.num_cells == 3
    expected = np.select([lbl == 7, lbl == 2**31, lbl == 2**32 + 7], [1, 2, 3], 0)
    np.testing.assert_array_equal(m.label_image, expected)
    np.testing.assert_array_equal(m.cell_properties["area"], [16, 25, 25])


def test_no_device_means_the_card(monkeypatch):
    """Without `device`, the mask asks for the CUDA card and raises where
    there is none; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortMask(_blob_mask(0))


def test_label_image_is_uploaded_once_and_cached():
    m = SegmentationMask(_blob_mask(0), _planes((96, 120)))
    lbl, n = m._processed
    assert lbl.dtype == torch.int32 and int(lbl.max()) == n == m.num_cells
    _ = m.cell_properties
    assert m._processed[0] is lbl


# -- on the card against the CPU -----------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", list(MASKS))
def test_card_tables_match_cpu(cuda_device, kind):
    from arcadia_microscopy_tools_tpu_torch.masks import SUPPORTED_PROPERTY_NAMES
    from arcadia_microscopy_tools_tpu_torch.ops import cc_cuda

    mask = MASKS[kind]()
    kw = dict(property_names=list(SUPPORTED_PROPERTY_NAMES))
    cc_cuda.reset_launch_counts()
    card = PortMask(mask, _planes(mask.shape), device=cuda_device, **kw)
    cpu = PortMask(mask, _planes(mask.shape), device="cpu", **kw)
    _hold_tables(cpu, card)
    if kind == "bool":
        assert cc_cuda.launch_counts["local_cc"] >= 1
        assert cc_cuda.launch_counts["local_resweep"] >= 1
    child = card.filter("area", min_value=60)
    assert child.device == card.device
    np.testing.assert_array_equal(child.label_image, cpu.filter("area", min_value=60).label_image)
