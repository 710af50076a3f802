"""PyTorch port: the four documented examples (`docs/examples/*.py`), step
by step through the port on the CPU, each step against the same step
through the JAX package. The example files themselves drive the JAX
package; these tests call the port's counterpart of every call they make.

Tolerances: ND2 pixels, metadata, masks, label images, cell counts and
integer columns equal; float images rtol 1e-5 plus atol 1e-6 (float32
results); per-cell float columns rtol 1e-5 plus atol 1e-4 and orientation
left out (see tests/test_torch_masks.py); overlays atol 1e-6; the U-Net
step (bf16 forwards that round at different points) the same cell count
within one and >= 99% of pixels with the same label, as
tests/test_torch_segmentation.py holds it. The U-Net step runs on a 128^2
crop and loads the port's `models/unet_checkpoint.npz`, because the port
refuses the orbax directory that the example names.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import arcadia_microscopy_tools_tpu as jax_pkg
import arcadia_microscopy_tools_tpu_torch as port
from arcadia_microscopy_tools_tpu import operations as jax_ops
from arcadia_microscopy_tools_tpu_torch import _native
from arcadia_microscopy_tools_tpu_torch import operations as port_ops

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
CPU = {"device": "cpu"}


def _close(got, want, rtol=1e-5, atol=1e-6, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module", autouse=True)
def native_library():
    _native.build()


# -- basic_usage.py ----------------------------------------------------------------


@pytest.fixture(scope="module")
def multichannel():
    path = DATA / "example-multichannel.nd2"
    return (jax_pkg.MicroscopyImage.from_nd2_path(path),
            port.MicroscopyImage.from_nd2_path(path))


def test_basic_usage_load_and_metadata(multichannel):
    theirs, ours = multichannel
    assert ours.sizes == theirs.sizes
    assert [c.name for c in ours.channels] == [c.name for c in theirs.channels]
    assert ours.dimensions.value == theirs.dimensions.value  # two packages, two enum classes
    cm_t = theirs.metadata.instrument.channel_metadata_list[1]
    cm_o = ours.metadata.instrument.channel_metadata_list[1]
    assert cm_o.resolution.xy_step_um == cm_t.resolution.xy_step_um
    assert (cm_o.optics.objective, cm_o.optics.magnification) == (
        cm_t.optics.objective, cm_t.optics.magnification)
    assert cm_o.acquisition.exposure_time_s == cm_t.acquisition.exposure_time_s
    np.testing.assert_array_equal(
        np.asarray(ours.get_channel_intensities("DAPI")),
        np.asarray(theirs.get_channel_intensities("DAPI")),
    )


def test_basic_usage_pipeline_and_thresholds(multichannel):
    theirs, ours = multichannel

    def pipeline(pkg, ops, **kw):
        return pkg.Pipeline([
            pkg.ImageOperation(ops.subtract_background_dog, 1.0, 16.0),
            pkg.ImageOperation(ops.rescale_by_percentile, (0.5, 99.5)),
            pkg.ImageOperation(ops.crop_to_center, (192, 192)),
        ], **kw)

    got = ours.apply_pipeline(pipeline(port, port_ops, **CPU), "DAPI")
    want = theirs.apply_pipeline(pipeline(jax_pkg, jax_ops), "DAPI")
    assert got.dtype == want.dtype == np.float64
    _close(got, want, what="DoG -> rescale -> crop")

    dapi = np.asarray(theirs.get_channel_intensities("DAPI"))
    for method in ("otsu", "li", "triangle", "mean"):
        mask = port_ops.apply_threshold(dapi, method, **CPU)
        np.testing.assert_array_equal(mask, np.asarray(jax_ops.apply_threshold(dapi, method)),
                                      err_msg=method)


def test_basic_usage_timelapse_parallel_pipeline():
    path = DATA / "example-timelapse.nd2"
    theirs = jax_pkg.MicroscopyImage.from_nd2_path(path)
    ours = port.MicroscopyImage.from_nd2_path(path)
    got = ours.apply_pipeline(
        port.Pipeline([port.ImageOperation(port_ops.rescale_by_percentile, (1, 99))],
                      parallel=True, **CPU),
        ours.channels[0],
    )
    want = theirs.apply_pipeline(
        jax_pkg.Pipeline([jax_pkg.ImageOperation(jax_ops.rescale_by_percentile, (1, 99))],
                         parallel=True),
        theirs.channels[0],
    )
    assert got.shape == want.shape and got.shape[0] > 1
    _close(got, want, what="per-frame rescale")


# -- cell_segmentation.py -------------------------------------------------------------


def _mask_pair(binary, **kw):
    from arcadia_microscopy_tools_tpu.masks import SegmentationMask as JaxMask
    from arcadia_microscopy_tools_tpu_torch.masks import SegmentationMask

    return JaxMask(binary, {}, **kw), SegmentationMask(binary, {}, device="cpu", **kw)


def _hold_table(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for name, w in want.items():
        if w.dtype.kind in "iub" or name.startswith(("area_convex", "solidity")):
            np.testing.assert_array_equal(got[name], w, err_msg=name)
        elif name != "orientation":
            _close(got[name], w, atol=1e-4, what=name)


def test_cell_segmentation_classical_path():
    from arcadia_microscopy_tools_tpu.models.synthetic import synthesize_cells as jax_synth
    from arcadia_microscopy_tools_tpu_torch.models.synthetic import synthesize_cells

    image, truth = synthesize_cells(np.random.default_rng(0), (256, 256), n_cells=30)
    want_image, want_truth = jax_synth(np.random.default_rng(0), (256, 256), n_cells=30)
    np.testing.assert_array_equal(image, want_image)
    np.testing.assert_array_equal(truth, want_truth)
    intensities = (image * 65535).astype(np.uint16)

    normalized = port_ops.rescale_by_percentile(intensities, (1, 99), **CPU)
    want_norm = np.asarray(jax_ops.rescale_by_percentile(intensities, (1, 99)))
    _close(normalized, want_norm, what="rescale")
    quantised = (np.asarray(normalized) * 65535).astype(np.uint16)
    np.testing.assert_array_equal(quantised, (want_norm * 65535).astype(np.uint16))
    binary = np.asarray(port_ops.apply_threshold(quantised, **CPU))
    np.testing.assert_array_equal(binary, np.asarray(jax_ops.apply_threshold(quantised)))

    theirs, ours = _mask_pair(binary, remove_edge_cells=True)
    np.testing.assert_array_equal(ours.label_image, theirs.label_image)
    assert ours.num_cells == theirs.num_cells > 10
    _hold_table(ours.cell_properties, theirs.cell_properties)

    filtered_t = theirs.filter("area", min_value=60)
    filtered_o = ours.filter("area", min_value=60)
    np.testing.assert_array_equal(filtered_o.label_image, filtered_t.label_image)
    um_t = filtered_t.convert_properties_to_microns(pixel_size_um=0.325)
    um_o = filtered_o.convert_properties_to_microns(pixel_size_um=0.325)
    _hold_table(um_o, um_t)


def test_cell_segmentation_unet_path():
    from arcadia_microscopy_tools_tpu.model import SegmentationModel as JaxModel
    from arcadia_microscopy_tools_tpu_torch.exceptions import SegmentationWarning
    from arcadia_microscopy_tools_tpu_torch.model import SegmentationModel
    from arcadia_microscopy_tools_tpu_torch.models.synthetic import synthesize_cells
    from arcadia_microscopy_tools_tpu_torch.models.weights import DEFAULT_WEIGHTS

    image, _ = synthesize_cells(np.random.default_rng(0), (256, 256), n_cells=30)
    crop = image[64:192, 64:192].astype(np.float64)
    with pytest.raises(ValueError, match="directory"):
        SegmentationModel(checkpoint_path=REPO / "checkpoints" / "unet", **CPU)
    model = SegmentationModel(checkpoint_path=DEFAULT_WEIGHTS, **CPU)
    got = model.segment(crop)
    want = JaxModel(checkpoint_path=REPO / "checkpoints" / "unet").segment(crop)
    assert got.shape == want.shape and want.max() >= 3
    assert abs(int(got.max()) - int(want.max())) <= 1
    assert (got == want).mean() >= 0.99
    # batch segmentation with failure isolation: a bad image fails alone
    with pytest.warns(SegmentationWarning, match="image 1"):
        batch = model.batch_segment([crop, np.zeros((4,)), crop], show_progress=False)
    assert batch[1] is None
    for labels in (batch[0], batch[2]):
        np.testing.assert_array_equal(labels, got)


# -- fluorescence_overlays.py ---------------------------------------------------------


def test_fluorescence_overlays(multichannel):
    theirs, ours = multichannel
    norm_t = {ch.name: np.asarray(jax_ops.rescale_by_percentile(
        theirs.get_channel_intensities(ch), (1, 99.5))) for ch in theirs.channels}
    norm_o = {ch.name: port_ops.rescale_by_percentile(
        ours.get_channel_intensities(ch), (1, 99.5), **CPU) for ch in ours.channels}
    for name in norm_t:
        _close(norm_o[name], norm_t[name], what=name)
    fluor_t, fluor_o = theirs.channels[1:], ours.channels[1:]
    bg = theirs.channels[0].name

    overlay_t = jax_pkg.overlay_channels(
        background=norm_t[bg], channel_intensities={ch: norm_t[ch.name] for ch in fluor_t},
        blend_mode=jax_pkg.BlendMode.ADDITIVE)
    overlay_o = port.overlay_channels(
        background=norm_o[bg], channel_intensities={ch: norm_o[ch.name] for ch in fluor_o},
        blend_mode=port.BlendMode.ADDITIVE, **CPU)
    assert overlay_o.dtype == np.float64
    _close(overlay_o, overlay_t, rtol=0, atol=1e-6, what="overlay_channels")

    def layers(pkg, chans, norm):
        return [
            pkg.Layer(chans[0], norm[chans[0].name], opacity=0.9),
            pkg.Layer(chans[1], norm[chans[1].name], opacity=0.7,
                      blend_mode=pkg.BlendMode.ADDITIVE),
            pkg.Layer(chans[2], norm[chans[2].name], opacity=0.5, zero_transparent=False),
        ]

    composite_t = jax_pkg.create_overlay(norm_t[bg], layers(jax_pkg, fluor_t, norm_t))
    composite_o = port.create_overlay(norm_o[bg], layers(port, fluor_o, norm_o), **CPU)
    _close(composite_o, composite_t, rtol=0, atol=1e-6, what="create_overlay")


# -- plate_pipeline.py ----------------------------------------------------------------


def test_plate_pipeline(tmp_path):
    from arcadia_microscopy_tools_tpu.io.nikon import load_nd2 as jax_load_nd2
    from arcadia_microscopy_tools_tpu.parallel.plate import PlateRunConfig as JaxConfig
    from arcadia_microscopy_tools_tpu.parallel.plate import PlateRunner as JaxRunner
    from arcadia_microscopy_tools_tpu_torch.channels import CY5, DAPI, FITC, TRITC
    from arcadia_microscopy_tools_tpu_torch.core.microplate import Well
    from arcadia_microscopy_tools_tpu_torch.io.nikon import load_nd2

    sys.path.insert(0, str(REPO / "tests"))
    from nd2_builder import write_nd2

    rng = np.random.default_rng(0)
    well_ids = ["A01", "A02"]
    for well_id in well_ids:
        base = rng.normal(150, 15, (4, 256, 256)).clip(0, None)
        yy, xx = np.mgrid[0:48, 0:48]
        blob = 2800 * np.exp(-((yy - 24) ** 2 + (xx - 24) ** 2) / 40.0)
        for _ in range(12):
            cy, cx = rng.integers(24, 232), rng.integers(24, 232)
            base[0, cy - 24 : cy + 24, cx - 24 : cx + 24] += blob
            for ch in range(1, 4):
                base[ch, cy - 24 : cy + 24, cx - 24 : cx + 24] += blob * rng.uniform(0.2, 1)
        write_nd2(tmp_path / f"{well_id}.nd2", base.astype(np.uint16),
                  channel_names=["DAPI", "FITC", "TRITC", "CY5"])

    def source(well_id):
        return load_nd2(tmp_path / f"{well_id}.nd2")[0]

    def jax_source(well_id):
        return jax_load_nd2(tmp_path / f"{well_id}.nd2")[0]

    layout = port.MicroplateLayout([Well(id=w) for w in well_ids])
    channels = [DAPI, FITC, TRITC, CY5]
    kw = dict(max_cells=256, min_size=20, batch_size=2)
    runner = port.PlateRunner(port.PlateRunConfig(**kw), checkpoint_dir=tmp_path / "port", **CPU)
    results = runner.run(layout, source, channels=channels)
    # the JAX runner shards a batch over the test session's 8 virtual
    # devices, so its batch holds 8 wells; the batch size changes no table
    want = JaxRunner(JaxConfig(**{**kw, "batch_size": 8})).run(layout, jax_source,
                                                               channels=channels)
    assert results.failed_wells == want.failed_wells == []
    for well_id in well_ids:
        got_t, want_t = results.tables[well_id], want.tables[well_id]
        assert list(got_t.columns) == list(want_t.columns)
        assert len(got_t) == len(want_t) > 5
        for col in got_t.columns:
            if col in ("label", "area") or col.startswith("bbox"):
                np.testing.assert_array_equal(got_t[col], want_t[col], err_msg=col)
            elif col not in ("orientation", "well_id"):
                _close(got_t[col], want_t[col], atol=1e-4, what=col)
    summary = results.summary()
    assert list(summary["num_cells"]) == [len(want.tables[w]) for w in well_ids]
    assert len(results.to_dataframe()) == sum(len(t) for t in want.tables.values())

    resumed = port.PlateRunner(port.PlateRunConfig(**kw), checkpoint_dir=tmp_path / "port",
                               **CPU).run(layout, source, channels=channels)
    # every well came from the checkpoint: nothing staged, copied, launched or read back
    assert all(resumed.timings[k] == 0 for k in ("stage_s", "h2d_s", "launch_s", "readback_s"))
    assert all(len(resumed.tables[w]) == len(results.tables[w]) for w in well_ids)
