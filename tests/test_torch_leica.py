"""PyTorch port: the twins of tests/test_leica.py, run against the port's own
LIF reader and Leica parser (`arcadia_microscopy_tools_tpu_torch.io.lif`,
`.io.leica`, `.leica`, `MicroscopyImage.from_lif_path`) on containers
synthesized by tests/lif_builder.py. Parity with the JAX package on the
same containers is in test_torch_lif_parity.py."""

from datetime import datetime

import numpy as np
import pytest

from arcadia_microscopy_tools_tpu_torch import MicroscopyImage
from arcadia_microscopy_tools_tpu_torch.channels import FITC, SRS
from arcadia_microscopy_tools_tpu_torch.exceptions import MetadataWarning
from arcadia_microscopy_tools_tpu_torch.leica import (
    CRS_STOKES_WAVELENGTH_NM,
    calculate_antistokes_wavelength,
    calculate_raman_shift,
    list_image_names,
    load_lif_image,
)
from lif_builder import LifBuilder, simple_confocal_lif


class TestCrsPhysics:
    def test_raman_shift_scalar(self):
        # 797 nm pump with 1031.7 nm Stokes -> ~2852 cm^-1 (CH2 stretch)
        shift = calculate_raman_shift(797.0)
        assert shift == pytest.approx((1 / 797 - 1 / 1031.7) * 1e7)
        assert 2800 < shift < 2900

    def test_raman_shift_array(self):
        pumps = np.array([780.0, 797.0, 850.0])
        shifts = calculate_raman_shift(pumps)
        assert shifts.shape == (3,)
        assert np.all(np.diff(shifts) < 0)  # longer pump -> smaller shift

    def test_antistokes_wavelength(self):
        wl = calculate_antistokes_wavelength(797.0)
        assert wl == pytest.approx(1 / (2 / 797 - 1 / 1031.7))
        assert wl < 797  # anti-Stokes is blue-shifted

    def test_custom_stokes(self):
        assert calculate_raman_shift(800.0, 800.0) == 0.0


class TestLifReader:
    def test_list_image_names(self, tmp_path):
        p = tmp_path / "a.lif"
        simple_confocal_lif(p, name="MySeries")
        assert list_image_names(p) == ["MySeries"]

    def test_load_image_roundtrip(self, tmp_path):
        p = tmp_path / "a.lif"
        data = simple_confocal_lif(p, name="S1", shape=(64, 48))
        intensities, meta = load_lif_image(p, "S1")
        assert intensities.shape == (64, 48)
        np.testing.assert_array_equal(intensities, data[0])
        assert meta.sizes == {"Y": 64, "X": 48}

    def test_missing_image_raises(self, tmp_path):
        p = tmp_path / "a.lif"
        simple_confocal_lif(p, name="S1")
        with pytest.raises(ValueError, match="not found"):
            load_lif_image(p, "Nope")

    def test_multichannel_plane_sequential_layout(self, tmp_path):
        rng = np.random.default_rng(1)
        data = (rng.random((2, 32, 40)) * 1000).astype(np.uint16)
        b = LifBuilder()
        b.add_image(
            "MC",
            data,
            dims=[(1, 40, 40 * 0.3e-6, "m"), (2, 32, 32 * 0.3e-6, "m")],
            channel_properties=[
                {"DetectorName": "HyD S 1", "BeamRoute": "10;0"},
                {"DetectorName": "HyD S 2", "BeamRoute": "10;1"},
            ],
        )
        p = tmp_path / "mc.lif"
        b.write(p)
        intensities, meta = load_lif_image(p, "MC")
        assert meta.sizes == {"C": 2, "Y": 32, "X": 40}
        np.testing.assert_array_equal(intensities, data)


class TestChannelInference:
    def test_single_wll_laser_from_wavelength(self, tmp_path):
        p = tmp_path / "a.lif"
        simple_confocal_lif(p, name="S1")
        _, meta = load_lif_image(p, "S1")
        ch = meta.channel_metadata_list[0].channel
        assert ch.name == "WLL"
        assert ch.excitation_nm == 488

    def test_explicit_channels_override(self, tmp_path):
        p = tmp_path / "a.lif"
        simple_confocal_lif(p, name="S1")
        _, meta = load_lif_image(p, "S1", channels=[FITC])
        assert meta.channel_metadata_list[0].channel == FITC

    def test_wrong_channel_count_raises(self, tmp_path):
        p = tmp_path / "a.lif"
        simple_confocal_lif(p, name="S1")
        with pytest.raises(ValueError, match="Expected 1 channels"):
            load_lif_image(p, "S1", channels=[FITC, SRS])

    def test_nir_wavelength_fallback_warns(self, tmp_path):
        rng = np.random.default_rng(0)
        data = (rng.random((1, 16, 16)) * 100).astype(np.uint16)
        b = LifBuilder()
        b.add_image(
            "NIR",
            data,
            dims=[(1, 16, 16 * 0.3e-6, "m"), (2, 16, 16 * 0.3e-6, "m")],
            lasers=[
                {"LightSourceType": "1", "LightSourceName": "UV Light",
                 "WavelengthDouble": "1040", "PowerState": "On"},
            ],
        )
        p = tmp_path / "nir.lif"
        b.write(p)
        with pytest.warns(MetadataWarning, match="outside accepted range"):
            _, meta = load_lif_image(p, "NIR")
        ch = meta.channel_metadata_list[0].channel
        assert ch.color == "#8B0000"
        assert ch.name == "DIODE"

    def test_wavelength_in_meters_converted(self, tmp_path):
        rng = np.random.default_rng(0)
        data = (rng.random((1, 16, 16)) * 100).astype(np.uint16)
        b = LifBuilder()
        b.add_image(
            "M",
            data,
            dims=[(1, 16, 16 * 0.3e-6, "m"), (2, 16, 16 * 0.3e-6, "m")],
            lasers=[
                {"LightSourceType": "4", "LightSourceName": "SuperContVisible Light",
                 "WavelengthDouble": "4.88e-07", "PowerState": "On"},
            ],
        )
        p = tmp_path / "m.lif"
        b.write(p)
        _, meta = load_lif_image(p, "M")
        assert meta.channel_metadata_list[0].channel.excitation_nm == 488

    def _crs_file(self, tmp_path, detector, beam_route, n_extra_lasers=True):
        rng = np.random.default_rng(0)
        data = (rng.random((1, 16, 16)) * 100).astype(np.uint16)
        b = LifBuilder()
        lasers = [
            {"LightSourceType": "6", "LightSourceName": "CARS Light (Attenuator)",
             "WavelengthDouble": "797", "PowerState": "On"},
        ]
        if n_extra_lasers:
            lasers.append(
                {"LightSourceType": "4", "LightSourceName": "SuperContVisible Light",
                 "WavelengthDouble": "488", "PowerState": "On"}
            )
        b.add_image(
            "CRS",
            data,
            dims=[(1, 16, 16 * 0.3e-6, "m"), (2, 16, 16 * 0.3e-6, "m")],
            channel_properties=[{"DetectorName": detector, "BeamRoute": beam_route}],
            lasers=lasers,
        )
        p = tmp_path / "crs.lif"
        b.write(p)
        return p

    def test_srs_detector_with_computed_wavelengths(self, tmp_path):
        p = self._crs_file(tmp_path, "F-SRS", "10;0")
        _, meta = load_lif_image(p, "CRS")
        ch = meta.channel_metadata_list[0].channel
        assert ch.name == "SRS"
        assert ch.excitation_nm == 797.0
        assert ch.emission_nm == 797.0  # SRS: loss-based, emission == excitation
        assert ch.color == SRS.color

    def test_eshg_emission_half_excitation(self, tmp_path):
        p = self._crs_file(tmp_path, "HyD NDD 2", "20;2")
        _, meta = load_lif_image(p, "CRS")
        ch = meta.channel_metadata_list[0].channel
        assert ch.name == "E-SHG"
        assert ch.emission_nm == pytest.approx(797.0 / 2, abs=0.1)

    def test_ecars_antistokes_emission(self, tmp_path):
        p = self._crs_file(tmp_path, "HyD NDD 1", "20;21")
        _, meta = load_lif_image(p, "CRS")
        ch = meta.channel_metadata_list[0].channel
        assert ch.name == "E-CARS"
        expected = float(calculate_antistokes_wavelength(797.0, CRS_STOKES_WAVELENGTH_NM))
        assert ch.emission_nm == pytest.approx(expected, abs=0.1)

    def test_brightfield_ambiguity_warns(self, tmp_path):
        p = self._crs_file(tmp_path, "Trans PMT 3", "10;2")
        with pytest.warns(MetadataWarning, match="also used for F-SHG"):
            _, meta = load_lif_image(p, "CRS")
        assert meta.channel_metadata_list[0].channel.name == "BRIGHTFIELD"

    def test_unknown_detector_raises(self, tmp_path):
        p = self._crs_file(tmp_path, "Mystery PMT", "0;0")
        with pytest.raises(ValueError, match="Could not determine channel"):
            load_lif_image(p, "CRS")

    def test_no_active_laser_raises(self, tmp_path):
        rng = np.random.default_rng(0)
        data = (rng.random((1, 16, 16)) * 100).astype(np.uint16)
        b = LifBuilder()
        b.add_image(
            "OFF",
            data,
            dims=[(1, 16, 16 * 0.3e-6, "m"), (2, 16, 16 * 0.3e-6, "m")],
            lasers=[
                {"LightSourceType": "4", "LightSourceName": "SuperContVisible Light",
                 "WavelengthDouble": "488", "PowerState": "Off"},
            ],
        )
        p = tmp_path / "off.lif"
        b.write(p)
        with pytest.raises(ValueError, match="No active laser"):
            load_lif_image(p, "OFF")


class TestDimensionsAndMeasured:
    def test_zstack(self, tmp_path):
        rng = np.random.default_rng(0)
        data = (rng.random((1, 5, 32, 32)) * 100).astype(np.uint16)
        b = LifBuilder()
        b.add_image(
            "ZS",
            data,
            dims=[
                (1, 32, 32 * 0.3e-6, "m"),
                (2, 32, 32 * 0.3e-6, "m"),
                (3, 5, 10e-6, "m"),
            ],
        )
        p = tmp_path / "z.lif"
        b.write(p)
        intensities, meta = load_lif_image(p, "ZS")
        assert meta.sizes == {"Z": 5, "Y": 32, "X": 32}
        cm = meta.channel_metadata_list[0]
        assert cm.dimensions.is_zstack
        assert cm.resolution.z_size_px == 5
        assert cm.resolution.z_step_um == pytest.approx(2.0)
        z = cm.measured.z_values_um
        assert z is not None and len(z) == 5
        np.testing.assert_allclose(np.diff(z), 2.0)

    def test_timelapse(self, tmp_path):
        rng = np.random.default_rng(0)
        data = (rng.random((1, 4, 16, 16)) * 100).astype(np.uint16)
        b = LifBuilder()
        b.add_image(
            "TL",
            data,
            dims=[
                (1, 16, 16 * 0.3e-6, "m"),
                (2, 16, 16 * 0.3e-6, "m"),
                (4, 4, 2.0, "s"),
            ],
        )
        p = tmp_path / "t.lif"
        b.write(p)
        _, meta = load_lif_image(p, "TL")
        cm = meta.channel_metadata_list[0]
        assert cm.dimensions.is_timelapse
        assert cm.resolution.t_size_px == 4
        assert cm.resolution.t_step_ms == pytest.approx(500.0)
        t = cm.measured.t_values_ms
        assert t is not None and len(t) == 4

    def test_montage_tile_positions_mean_centered(self, tmp_path):
        rng = np.random.default_rng(0)
        data = (rng.random((1, 4, 16, 16)) * 100).astype(np.uint16)
        tiles = [
            {"FieldX": "0", "FieldY": "0",
             "PosX": "0.001000", "PosY": "0.002000", "PosZ": "0.0001"},
            {"FieldX": "1", "FieldY": "0",
             "PosX": "0.001100", "PosY": "0.002000", "PosZ": "0.0001"},
            {"FieldX": "0", "FieldY": "1",
             "PosX": "0.001000", "PosY": "0.002100", "PosZ": "0.0001"},
            {"FieldX": "1", "FieldY": "1",
             "PosX": "0.001100", "PosY": "0.002100", "PosZ": "0.0001"},
        ]
        b = LifBuilder()
        b.add_image(
            "TS",
            data,
            dims=[
                (1, 16, 16 * 0.3e-6, "m"),
                (2, 16, 16 * 0.3e-6, "m"),
                (10, 4, 4.0, "m"),
            ],
            tile_scan=tiles,
        )
        p = tmp_path / "mont.lif"
        b.write(p)
        _, meta = load_lif_image(p, "TS")
        cm = meta.channel_metadata_list[0]
        assert cm.dimensions.is_montage
        x = cm.measured.x_values_um
        assert x is not None
        assert x.mean() == pytest.approx(0.0, abs=1e-9)  # mean-centered
        assert x.max() - x.min() == pytest.approx(100.0)  # 100 um pitch

    def test_lambda_scan_laser_values(self, tmp_path):
        rng = np.random.default_rng(0)
        data = (rng.random((1, 3, 16, 16)) * 100).astype(np.uint16)
        lvs = [
            {"Step": "0", "Wavelength": "780", "Power": "1", "FixedLinePower": "0",
             "Temperature": "20", "Humidity": "30"},
            {"Step": "1", "Wavelength": "800", "Power": "1", "FixedLinePower": "0",
             "Temperature": "20", "Humidity": "30"},
            {"Step": "2", "Wavelength": "820", "Power": "1", "FixedLinePower": "0",
             "Temperature": "20", "Humidity": "30"},
        ]
        b = LifBuilder()
        b.add_image(
            "LS",
            data,
            dims=[
                (1, 16, 16 * 0.3e-6, "m"),
                (2, 16, 16 * 0.3e-6, "m"),
                (9, 3, 40e-9, "m"),
            ],
            laser_values=lvs,
        )
        p = tmp_path / "ls.lif"
        b.write(p)
        _, meta = load_lif_image(p, "LS")
        cm = meta.channel_metadata_list[0]
        assert cm.dimensions.is_spectral
        np.testing.assert_allclose(cm.measured.w_values_nm, [780, 800, 820])

    def test_navigator_lambda_scan_reconstruction(self, tmp_path):
        """Merged Navigator image: wavelengths reconstructed from the
        LambdaDefinition instead of LaserValues."""
        rng = np.random.default_rng(0)
        data = (rng.random((1, 3, 16, 16)) * 100).astype(np.uint16)
        b = LifBuilder()
        b.add_image(
            "Scan_Merged",
            data,
            dims=[
                (1, 16, 16 * 0.3e-6, "m"),
                (2, 16, 16 * 0.3e-6, "m"),
                (9, 3, 40e-9, "m"),
            ],
            lambda_definition={
                "LambdaExcitationBeginDouble": "780",
                "LambdaExcitationEndDouble": "820",
                "LambdaExcitationStepCount": "3",
            },
        )
        p = tmp_path / "nav.lif"
        b.write(p)
        _, meta = load_lif_image(p, "Scan_Merged")
        cm = meta.channel_metadata_list[0]
        np.testing.assert_allclose(cm.measured.w_values_nm, [780, 800, 820])


class TestAcquisitionAndTimestamp:
    def test_exposure_formula(self, tmp_path):
        rng = np.random.default_rng(0)
        data = (rng.random((1, 32, 32)) * 100).astype(np.uint16)
        b = LifBuilder()
        b.add_image(
            "EXP",
            data,
            dims=[(1, 32, 32 * 0.3e-6, "m"), (2, 32, 32 * 0.3e-6, "m")],
            confocal={
                "PixelDwellTime": "2e-06",
                "LineAverage": "2",
                "FrameAccumulation": "3",
            },
        )
        p = tmp_path / "e.lif"
        b.write(p)
        _, meta = load_lif_image(p, "EXP")
        acq = meta.channel_metadata_list[0].acquisition
        assert acq.pixel_dwell_time_us == pytest.approx(2.0)
        assert acq.exposure_time_s == pytest.approx(2e-6 * 32 * 32 * 2 * 3)
        assert acq.line_averaging == 2
        assert acq.frame_accumulation == 3

    def test_timestamp_parsed(self, tmp_path):
        p = tmp_path / "a.lif"
        simple_confocal_lif(p, name="S1")
        _, meta = load_lif_image(p, "S1")
        ts = meta.channel_metadata_list[0].timestamp
        assert ts.year == 2025 and ts.month == 6

    def test_missing_timestamp_apollo_placeholder(self, tmp_path):
        rng = np.random.default_rng(0)
        data = (rng.random((1, 16, 16)) * 100).astype(np.uint16)
        b = LifBuilder()
        b.add_image(
            "NOTS",
            data,
            dims=[(1, 16, 16 * 0.3e-6, "m"), (2, 16, 16 * 0.3e-6, "m")],
            timestamp=None,
        )
        p = tmp_path / "nots.lif"
        b.write(p)
        with pytest.warns(MetadataWarning, match="placeholder timestamp"):
            _, meta = load_lif_image(p, "NOTS")
        assert meta.channel_metadata_list[0].timestamp == datetime(1969, 7, 20, 20, 17)

    def test_xy_step_mismatch_warns(self, tmp_path):
        rng = np.random.default_rng(0)
        data = (rng.random((1, 32, 32)) * 100).astype(np.uint16)
        b = LifBuilder()
        b.add_image(
            "XY",
            data,
            dims=[(1, 32, 32 * 0.3e-6, "m"), (2, 32, 32 * 0.4e-6, "m")],
        )
        p = tmp_path / "xy.lif"
        b.write(p)
        with pytest.warns(MetadataWarning, match="differ by more"):
            _, meta = load_lif_image(p, "XY")
        res = meta.channel_metadata_list[0].resolution
        assert res.xy_step_um == pytest.approx((0.3 + 0.4) / 2)

    def test_microscope_config(self, tmp_path):
        p = tmp_path / "a.lif"
        simple_confocal_lif(p, name="S1")
        _, meta = load_lif_image(p, "S1")
        optics = meta.channel_metadata_list[0].optics
        assert optics.magnification == 20
        assert optics.numerical_aperture == pytest.approx(0.75)
        assert optics.objective == "HC PL APO 20x/0.75"


class TestFromLifPath:
    def test_microscopy_image_from_lif(self, tmp_path):
        p = tmp_path / "a.lif"
        data = simple_confocal_lif(p, name="S1", shape=(32, 32))
        image = MicroscopyImage.from_lif_path(p, "S1")
        assert image.shape == (32, 32)
        np.testing.assert_array_equal(image.intensities, data[0])
        assert image.channels[0].name == "WLL"


class TestCorruptLif:
    def test_not_a_lif(self, tmp_path):
        from arcadia_microscopy_tools_tpu_torch.io.lif import LifFile, LifParseError

        p = tmp_path / "bogus.lif"
        p.write_bytes(b"definitely not a lif container" * 8)
        with pytest.raises(LifParseError):
            LifFile(p)

    def test_truncated_lif(self, tmp_path):
        from lif_builder import simple_confocal_lif

        from arcadia_microscopy_tools_tpu_torch.io.lif import LifFile, LifParseError

        whole = tmp_path / "whole.lif"
        simple_confocal_lif(whole)
        data = whole.read_bytes()
        trunc = tmp_path / "trunc.lif"
        trunc.write_bytes(data[: max(16, len(data) // 3)])
        with pytest.raises((LifParseError, ValueError, Exception)):
            f = LifFile(trunc)
            for img in f.images:
                img.asarray()


class TestContainerCache:
    """Plate workflows read many wells from one container: the parsed
    LifFile must be shared across load_lif_image calls and invalidated when
    the file on disk changes."""

    def test_cache_hit_and_invalidation(self, tmp_path):
        import os

        from lif_builder import simple_confocal_lif

        from arcadia_microscopy_tools_tpu_torch.io import lif

        p = tmp_path / "plate.lif"
        simple_confocal_lif(p)
        lif.clear_container_cache()
        a = lif.open_cached(p)
        b = lif.open_cached(p)
        assert a is b  # same parsed instance, no re-parse

        # touching the file (new mtime) must re-parse
        st = p.stat()
        os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
        c = lif.open_cached(p)
        assert c is not a
        lif.clear_container_cache()

    def test_load_lif_image_uses_cache(self, tmp_path):
        from lif_builder import simple_confocal_lif

        from arcadia_microscopy_tools_tpu_torch.io import lif
        from arcadia_microscopy_tools_tpu_torch.io.leica import load_lif_image

        p = tmp_path / "c.lif"
        simple_confocal_lif(p)
        name = "Series001"
        lif.clear_container_cache()
        parses = 0
        orig = lif.LifFile._parse_container

        def counting(data):
            nonlocal parses
            parses += 1
            return orig(data)

        lif.LifFile._parse_container = staticmethod(counting)
        try:
            px1, _ = load_lif_image(p, name)
            px2, _ = load_lif_image(p, name)
        finally:
            lif.LifFile._parse_container = staticmethod(orig)
            lif.clear_container_cache()
        assert parses == 1
        np.testing.assert_array_equal(px1, px2)
