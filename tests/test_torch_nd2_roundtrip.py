"""ND2 writer/reader round-trip: synthesized containers close the reader's
coverage gap the same way lif_builder does for the Leica path."""

import numpy as np
import pytest

from nd2_builder import write_nd2

from arcadia_microscopy_tools_tpu_torch import MicroscopyImage
from arcadia_microscopy_tools_tpu_torch.io.nd2 import ND2File


@pytest.fixture
def rng():
    return np.random.default_rng(7)


class TestMultichannel:
    def test_pixels_roundtrip_exact(self, rng, tmp_path):
        img = (rng.random((4, 96, 64)) * 60000).astype(np.uint16)
        path = write_nd2(tmp_path / "mc.nd2", img, channel_names=["DAPI", "FITC", "TRITC", "CY5"])
        loaded = MicroscopyImage.from_nd2_path(path)
        assert loaded.sizes == {"C": 4, "Y": 96, "X": 64}
        np.testing.assert_array_equal(np.asarray(loaded.intensities), img)

    def test_channels_resolved_by_name(self, rng, tmp_path):
        img = (rng.random((2, 32, 32)) * 100).astype(np.uint16)
        path = write_nd2(tmp_path / "mc.nd2", img, channel_names=["DAPI", "GFP"])
        loaded = MicroscopyImage.from_nd2_path(path)
        # GFP resolves through the Nikon alias to FITC
        assert [c.name for c in loaded.channels] == ["DAPI", "FITC"]

    def test_metadata_fields(self, rng, tmp_path):
        img = (rng.random((1, 32, 32)) * 100).astype(np.uint16)
        path = write_nd2(
            tmp_path / "m.nd2",
            img,
            channel_names=["DAPI"],
            calibration_um=0.5,
            magnification=40.0,
            numerical_aperture=1.15,
            objective="Apo LWD 40x WI",
        )
        cm = MicroscopyImage.from_nd2_path(path).metadata.instrument.channel_metadata_list[0]
        assert cm.resolution.xy_step_um == 0.5
        assert cm.optics.magnification == 40
        assert cm.optics.numerical_aperture == 1.15
        assert cm.optics.objective == "Apo LWD 40x WI"
        assert cm.acquisition.exposure_time_s == 0.1
        assert cm.acquisition.binning == "1x1"

    def test_reader_surface(self, rng, tmp_path):
        img = (rng.random((2, 48, 48)) * 100).astype(np.uint16)
        path = write_nd2(tmp_path / "s.nd2", img, channel_names=["DAPI", "FITC"])
        with ND2File(path) as f:
            assert f.sizes == {"C": 2, "Y": 48, "X": 48}
            assert f.metadata.contents.channelCount == 2
            assert "date" in f.text_info and "capturing" in f.text_info


class TestTimelapse:
    def test_time_axis_and_events(self, rng, tmp_path):
        stack = (rng.random((6, 32, 32)) * 100).astype(np.uint16)
        path = write_nd2(
            tmp_path / "t.nd2", stack, channel_names=["FITC"], time_loop=True,
            t_interval_ms=250.0,
        )
        loaded = MicroscopyImage.from_nd2_path(path)
        assert loaded.sizes == {"T": 6, "Y": 32, "X": 32}
        assert loaded.dimensions.is_timelapse
        cm = loaded.metadata.instrument.channel_metadata_list[0]
        assert cm.resolution.t_size_px == 6
        np.testing.assert_allclose(
            cm.measured.t_values_ms, np.arange(6) * 250.0
        )
        np.testing.assert_array_equal(np.asarray(loaded.intensities), stack)

    def test_multichannel_timelapse(self, rng, tmp_path):
        stack = (rng.random((3, 2, 32, 32)) * 100).astype(np.uint16)
        path = write_nd2(
            tmp_path / "tc.nd2", stack, channel_names=["DAPI", "FITC"], time_loop=True
        )
        loaded = MicroscopyImage.from_nd2_path(path)
        assert loaded.sizes == {"T": 3, "C": 2, "Y": 32, "X": 32}
        np.testing.assert_array_equal(np.asarray(loaded.intensities), stack)


class TestMontage:
    def test_stage_positions_mean_centered(self, rng, tmp_path):
        tiles = (rng.random((4, 2, 24, 24)) * 500).astype(np.uint16)
        positions = [(100.0, 200.0), (612.0, 200.0), (100.0, 712.0), (612.0, 712.0)]
        path = write_nd2(
            tmp_path / "m.nd2",
            tiles,
            channel_names=["DAPI", "FITC"],
            xy_positions=positions,
        )
        loaded = MicroscopyImage.from_nd2_path(path)
        assert loaded.sizes == {"P": 4, "C": 2, "Y": 24, "X": 24}
        assert loaded.dimensions.is_montage
        np.testing.assert_array_equal(np.asarray(loaded.intensities), tiles)

        cm = loaded.metadata.instrument.channel_metadata_list[0]
        xs = np.asarray(cm.measured.x_values_um)
        ys = np.asarray(cm.measured.y_values_um)
        # mean-centered: the montage midpoint is the origin
        np.testing.assert_allclose(xs.mean(), 0.0, atol=1e-9)
        np.testing.assert_allclose(ys.mean(), 0.0, atol=1e-9)
        np.testing.assert_allclose(xs, [-256.0, 256.0, -256.0, 256.0])
        np.testing.assert_allclose(ys, [-256.0, -256.0, 256.0, 256.0])

    def test_reader_synthesizes_coordinate_columns(self, rng, tmp_path):
        tiles = (rng.random((2, 1, 16, 16)) * 500).astype(np.uint16)
        path = write_nd2(
            tmp_path / "m2.nd2", tiles, channel_names=["DAPI"],
            xy_positions=[(0.0, 0.0), (512.0, 0.0)],
        )
        with ND2File(path) as f:
            events = f.events()
            assert [e["X Coord [µm]"] for e in events] == [0.0, 512.0]
            assert [e["Y Coord [µm]"] for e in events] == [0.0, 0.0]


class TestSpectral:
    def test_wavelength_axis_roundtrip(self, rng, tmp_path):
        wavelengths = [500.0, 510.0, 520.0, 530.0, 540.0]
        stack = (rng.random((5, 1, 16, 16)) * 900).astype(np.uint16)
        path = write_nd2(
            tmp_path / "w.nd2", stack, channel_names=["FITC"],
            wavelengths_nm=wavelengths,
        )
        loaded = MicroscopyImage.from_nd2_path(path)
        assert loaded.sizes == {"W": 5, "Y": 16, "X": 16}
        assert loaded.dimensions.is_spectral
        np.testing.assert_array_equal(
            np.asarray(loaded.intensities), stack[:, 0]
        )

        cm = loaded.metadata.instrument.channel_metadata_list[0]
        np.testing.assert_allclose(cm.measured.w_values_nm, wavelengths)
        assert cm.resolution.w_size_px == 5
        assert cm.resolution.w_step_nm == 10.0

    def test_nested_time_and_spectral(self, rng, tmp_path):
        wavelengths = [600.0, 620.0]
        stack = (rng.random((3, 2, 1, 16, 16)) * 900).astype(np.uint16)  # (T, W, C, Y, X)
        path = write_nd2(
            tmp_path / "tw.nd2", stack, channel_names=["TRITC"],
            time_loop=True, wavelengths_nm=wavelengths,
        )
        loaded = MicroscopyImage.from_nd2_path(path)
        assert loaded.sizes == {"T": 3, "W": 2, "Y": 16, "X": 16}
        assert loaded.dimensions.is_spectral and loaded.dimensions.is_timelapse
        cm = loaded.metadata.instrument.channel_metadata_list[0]
        # wavelength cycles fastest (inner loop)
        np.testing.assert_allclose(
            cm.measured.w_values_nm, [600.0, 620.0] * 3
        )


class TestRGB:
    def test_rgb_samples_axis(self, rng, tmp_path):
        frame = (rng.random((1, 3, 20, 20)) * 800).astype(np.uint16)  # (C, S, Y, X)
        path = write_nd2(
            tmp_path / "rgb.nd2", frame, channel_names=["BRIGHTFIELD"], rgb_samples=3
        )
        loaded = MicroscopyImage.from_nd2_path(path)
        assert loaded.sizes == {"S": 3, "Y": 20, "X": 20}
        assert loaded.dimensions.is_rgb
        np.testing.assert_array_equal(np.asarray(loaded.intensities), frame[0])

    def test_multichannel_rgb(self, rng, tmp_path):
        frame = (rng.random((2, 3, 20, 20)) * 800).astype(np.uint16)  # (C, S, Y, X)
        path = write_nd2(
            tmp_path / "rgb2.nd2", frame, channel_names=["DAPI", "FITC"], rgb_samples=3
        )
        with ND2File(path) as f:
            assert f.sizes == {"C": 2, "S": 3, "Y": 20, "X": 20}
            arr = f.asarray()
        np.testing.assert_array_equal(arr, frame)

    def test_nested_montage_and_time(self, rng, tmp_path):
        positions = [(0.0, 0.0), (256.0, 0.0)]
        stack = (rng.random((2, 3, 1, 16, 16)) * 700).astype(np.uint16)  # (P, T, C, Y, X)
        path = write_nd2(
            tmp_path / "pt.nd2", stack, channel_names=["DAPI"],
            xy_positions=positions, time_loop=True,
        )
        loaded = MicroscopyImage.from_nd2_path(path)
        assert loaded.sizes == {"P": 2, "T": 3, "Y": 16, "X": 16}
        assert loaded.dimensions.is_montage and loaded.dimensions.is_timelapse
        cm = loaded.metadata.instrument.channel_metadata_list[0]
        # stage position constant within each tile's time series (outer loop)
        xs = np.asarray(cm.measured.x_values_um)
        np.testing.assert_allclose(xs, [-128.0] * 3 + [128.0] * 3)
        np.testing.assert_array_equal(np.asarray(loaded.intensities), stack[:, :, 0])


class TestCorruptFiles:
    def test_not_an_nd2(self, tmp_path):
        from arcadia_microscopy_tools_tpu_torch.io.nd2 import ND2ParseError

        p = tmp_path / "bogus.nd2"
        p.write_bytes(b"this is not a microscopy file" * 10)
        with pytest.raises(ND2ParseError):
            ND2File(p)

    def test_truncated_container(self, rng, tmp_path):
        from arcadia_microscopy_tools_tpu_torch.io.nd2 import ND2ParseError

        frame = (rng.random((1, 32, 32)) * 100).astype(np.uint16)
        p = write_nd2(tmp_path / "whole.nd2", frame, channel_names=["DAPI"])
        data = p.read_bytes()
        trunc = tmp_path / "trunc.nd2"
        trunc.write_bytes(data[: len(data) // 2])
        with pytest.raises((ND2ParseError, ValueError, KeyError, Exception)):
            with ND2File(trunc) as f:
                f.asarray()

    def test_plate_runner_isolates_corrupt_well(self, rng, tmp_path):
        """A corrupt file fails its well with a warning; the run continues."""
        import warnings as _w

        from arcadia_microscopy_tools_tpu_torch.core.microplate import MicroplateLayout, Well
        from arcadia_microscopy_tools_tpu_torch.exceptions import SegmentationWarning
        from arcadia_microscopy_tools_tpu_torch.io.nikon import load_nd2
        from arcadia_microscopy_tools_tpu_torch.parallel.plate import (
            PlateRunConfig,
            PlateRunner,
        )

        good = (rng.random((1, 64, 64)) * 3000).astype(np.uint16)
        good[0, 20:40, 20:40] = 60000
        write_nd2(tmp_path / "A01.nd2", good, channel_names=["DAPI"])
        (tmp_path / "A02.nd2").write_bytes(b"garbage")

        def source(well_id):
            pixels, _ = load_nd2(tmp_path / f"{well_id}.nd2")
            return pixels

        layout = MicroplateLayout([Well(id="A01"), Well(id="A02")])
        runner = PlateRunner(PlateRunConfig(max_cells=16, min_size=5), device="cpu")
        with _w.catch_warnings():
            _w.simplefilter("always")
            with pytest.warns(SegmentationWarning, match="A02"):
                results = runner.run(layout, source)
        assert results.failed_wells == ["A02"]
        assert results.tables["A01"] is not None and len(results.tables["A01"]) >= 1

    def test_aborted_acquisition_shrinks_outer_loop(self, rng, tmp_path):
        """A timelapse set up for T=6 but aborted after 4 frames: the reader
        reconciles the loop shape with the frames actually written instead of
        failing to reshape."""
        import struct as _struct

        from nd2_builder import ND2Builder

        frames = (rng.random((4, 16, 16)) * 500).astype(np.uint16)
        b = ND2Builder()
        b.add_variant("ImageAttributesLV!", {"SLxImageAttributes": {
            "uiWidth": 16, "uiHeight": 16, "uiComp": 1,
            "uiBpcInMemory": 16, "uiBpcSignificant": 16,
            "uiWidthBytes": 32, "uiSequenceCount": 4,
        }})
        b.add_variant("ImageTextInfoLV!", {"SLxImageTextInfo": {
            "TextInfoItem_9": "1/15/2024 10:30:00 AM",
            "TextInfoItem_6": "Sample 1:\n  Exposure: 100 ms\n  Binning: 1x1",
        }})
        # the experiment still claims the NOMINAL count of 6
        b.add_variant("ImageMetadataLV!", {"SLxExperiment": {
            "eType": 1, "uLoopPars": {"uiCount": 6, "dPeriod": 100.0},
        }})
        b.add_variant("ImageMetadataSeqLV|0!", {"SLxPictureMetadata": {
            "dCalibration": 0.325, "dAspect": 1.0,
            "sPicturePlanes": {"uiCount": 1, "sPlaneNew": {"a0": {
                "sDescription": "DAPI", "uiColor": 0xFF0000}}},
        }})
        for t in range(4):
            payload = _struct.pack("<d", t * 100.0) + frames[t].tobytes()
            b.add(f"ImageDataSeq|{t}!", payload)
        path = tmp_path / "aborted.nd2"
        b.write(path)

        with ND2File(path) as f:
            assert f.sizes == {"T": 4, "Y": 16, "X": 16}
            arr = f.asarray()
        np.testing.assert_array_equal(arr, frames)
