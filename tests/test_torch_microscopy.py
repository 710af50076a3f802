"""PyTorch port, twin of test_microscopy.py: the port's copy of the
from-scratch ND2 reader + Nikon parser must reproduce the
NIS-Elements-transcribed metadata byte-for-byte (reference
test_microscopy.py:9-46 with the same fixtures)."""

from typing import Any

import numpy as np
import pytest

from arcadia_microscopy_tools_tpu_torch import MicroscopyImage
from arcadia_microscopy_tools_tpu_torch.channels import CHANNELS, FITC
from arcadia_microscopy_tools_tpu_torch.metadata_structures import DimensionFlags


def assert_metadata_equal(image: MicroscopyImage, expected_image_metadata: dict[str, Any]):
    for channel_str, known_channel_metadata in expected_image_metadata.items():
        channel = CHANNELS[channel_str]
        channel_index = image.channels.index(channel)
        channel_metadata = image.metadata.instrument.channel_metadata_list[channel_index]

        for section_name, section_values in known_channel_metadata.items():
            section_obj = getattr(channel_metadata, section_name)

            for parameter_name, known_value in section_values.items():
                parsed_value = getattr(section_obj, parameter_name)
                if isinstance(parsed_value, str):
                    assert parsed_value == known_value, (channel_str, parameter_name)
                elif parsed_value is None:
                    continue
                else:
                    assert np.allclose(parsed_value, known_value), (
                        channel_str,
                        parameter_name,
                        parsed_value,
                        known_value,
                    )


def test_parse_multichannel_metadata(valid_multichannel_nd2_path, known_metadata):
    image = MicroscopyImage.from_nd2_path(valid_multichannel_nd2_path)
    known_image_metadata = known_metadata["example-multichannel.nd2"]
    assert_metadata_equal(image, known_image_metadata)


def test_parse_timelapse_metadata(valid_timelapse_nd2_path, known_metadata):
    known_channels = [FITC]
    image = MicroscopyImage.from_nd2_path(valid_timelapse_nd2_path, channels=known_channels)
    known_image_metadata = known_metadata["example-timelapse.nd2"]
    assert_metadata_equal(image, known_image_metadata)


def test_parse_zstack_metadata(valid_zstack_nd2_path, known_metadata):
    image = MicroscopyImage.from_nd2_path(valid_zstack_nd2_path)
    known_image_metadata = known_metadata["example-zstack.nd2"]
    assert_metadata_equal(image, known_image_metadata)


class TestMultichannelImage:
    def test_channels_resolved(self, valid_multichannel_nd2_path):
        image = MicroscopyImage.from_nd2_path(valid_multichannel_nd2_path)
        names = [ch.name for ch in image.channels]
        assert names == ["BRIGHTFIELD", "DAPI", "FITC", "TRITC"]
        assert image.num_channels == 4
        assert image.channel_axis == 0
        assert image.shape == (4, 256, 256)
        assert image.sizes == {"C": 4, "Y": 256, "X": 256}

    def test_dimensions_flags(self, valid_multichannel_nd2_path):
        image = MicroscopyImage.from_nd2_path(valid_multichannel_nd2_path)
        assert image.dimensions.is_multichannel
        assert not image.dimensions.is_timelapse
        assert not image.dimensions.is_zstack

    def test_get_channel_intensities(self, valid_multichannel_nd2_path):
        image = MicroscopyImage.from_nd2_path(valid_multichannel_nd2_path)
        dapi = image.get_channel_intensities("DAPI")
        assert dapi.shape == (256, 256)
        np.testing.assert_array_equal(dapi, image.intensities[1])
        # Channel object form
        from arcadia_microscopy_tools_tpu_torch.channels import DAPI

        np.testing.assert_array_equal(image.get_channel_intensities(DAPI), dapi)

    def test_unknown_channel_raises(self, valid_multichannel_nd2_path):
        image = MicroscopyImage.from_nd2_path(valid_multichannel_nd2_path)
        with pytest.raises(ValueError, match="not found in image"):
            image.get_channel_intensities("CY5")

    def test_timestamp(self, valid_multichannel_nd2_path):
        image = MicroscopyImage.from_nd2_path(valid_multichannel_nd2_path)
        ts = image.metadata.instrument.channel_metadata_list[0].timestamp
        assert ts.year == 2025 and ts.month == 4 and ts.day == 17

    def test_channel_override_wrong_length_raises(self, valid_multichannel_nd2_path):
        with pytest.raises(ValueError, match="Expected 4 channels"):
            MicroscopyImage.from_nd2_path(valid_multichannel_nd2_path, channels=[FITC])


class TestTimelapseImage:
    def test_sizes_and_flags(self, valid_timelapse_nd2_path):
        image = MicroscopyImage.from_nd2_path(valid_timelapse_nd2_path, channels=[FITC])
        assert image.sizes == {"T": 53, "Y": 64, "X": 64}
        assert image.dimensions.is_timelapse
        assert not image.dimensions.is_multichannel

    def test_measured_time_values(self, valid_timelapse_nd2_path):
        image = MicroscopyImage.from_nd2_path(valid_timelapse_nd2_path, channels=[FITC])
        measured = image.metadata.instrument.channel_metadata_list[0].measured
        t = measured.t_values_ms
        assert t is not None and len(t) == 53
        assert t[0] == 0.0
        assert np.all(np.diff(t) > 0)
        # nominal 500 ms period
        assert abs(np.median(np.diff(t)) - 500) < 20

    def test_auto_channel_resolves_gfp_alias(self, valid_timelapse_nd2_path):
        image = MicroscopyImage.from_nd2_path(valid_timelapse_nd2_path)
        assert image.channels[0].name == "FITC"  # "GFP 488 nm" -> FITC alias


class TestZstackImage:
    def test_sizes_and_flags(self, valid_zstack_nd2_path):
        image = MicroscopyImage.from_nd2_path(valid_zstack_nd2_path)
        assert image.sizes == {"Z": 11, "Y": 128, "X": 128}
        assert image.dimensions.is_zstack

    def test_measured_z_values_centered(self, valid_zstack_nd2_path):
        image = MicroscopyImage.from_nd2_path(valid_zstack_nd2_path)
        measured = image.metadata.instrument.channel_metadata_list[0].measured
        z = measured.z_values_um
        assert z is not None and len(z) == 11
        # centered on the home plane: middle plane is ~0
        assert abs(z[5]) < 1e-9
        # 6 um steps
        assert np.allclose(np.diff(z), 6.0, atol=0.2)


class TestMicroscopyImageValidation:
    def test_shape_mismatch_raises(self, valid_multichannel_nd2_path):
        from arcadia_microscopy_tools_tpu_torch.microscopy import Metadata

        image = MicroscopyImage.from_nd2_path(valid_multichannel_nd2_path)
        with pytest.raises(ValueError, match="does not match"):
            MicroscopyImage(image.intensities[:2], Metadata(image.metadata.instrument))

    def test_non_uint16_warns(self, valid_multichannel_nd2_path):
        from arcadia_microscopy_tools_tpu_torch.exceptions import MetadataWarning
        from arcadia_microscopy_tools_tpu_torch.microscopy import Metadata

        image = MicroscopyImage.from_nd2_path(valid_multichannel_nd2_path)
        with pytest.warns(MetadataWarning, match="Expected uint16"):
            MicroscopyImage(
                image.intensities.astype(np.float32), Metadata(image.metadata.instrument)
            )

    def test_instrument_metadata_requires_xy(self):
        from arcadia_microscopy_tools_tpu_torch.microscopy import InstrumentMetadata

        with pytest.raises(ValueError, match="must contain 'X'"):
            InstrumentMetadata({"Y": 4}, [])

    def test_channel_count_mismatch(self):
        from arcadia_microscopy_tools_tpu_torch.microscopy import InstrumentMetadata

        with pytest.raises(ValueError, match="does not match"):
            InstrumentMetadata({"C": 2, "Y": 4, "X": 4}, [])

    def test_dimension_flags_or_combination(self, valid_multichannel_nd2_path):
        image = MicroscopyImage.from_nd2_path(valid_multichannel_nd2_path)
        flags = image.metadata.instrument.dimensions
        assert flags & DimensionFlags.MULTICHANNEL

    def test_apply_pipeline_on_channel(self, valid_multichannel_nd2_path):
        from arcadia_microscopy_tools_tpu_torch import ImageOperation, Pipeline
        from arcadia_microscopy_tools_tpu_torch.operations import rescale_by_percentile

        image = MicroscopyImage.from_nd2_path(valid_multichannel_nd2_path)
        pipe = Pipeline([ImageOperation(rescale_by_percentile, (1, 99))], device="cpu")
        out = image.apply_pipeline(pipe, "DAPI")
        assert out.shape == (256, 256)
        assert 0 <= out.min() and out.max() <= 1


class TestDimensionFieldHelpers:
    """User-extension parity with the reference's field-metadata validation
    mechanism (reference metadata_structures.py:14-31): dataclasses built
    from `dimension_field` validate through `DimensionValidatorMixin`."""

    def test_dimension_field_validation(self):
        from dataclasses import dataclass

        from arcadia_microscopy_tools_tpu_torch.metadata_structures import (
            DimensionFlags,
            DimensionValidatorMixin,
            dimension_field,
        )

        @dataclass
        class CustomRecord(DimensionValidatorMixin):
            z_planes: int | None = dimension_field(DimensionFlags.Z_STACK)
            t_frames: int | None = dimension_field(
                DimensionFlags.TIMELAPSE, default=1
            )

        rec = CustomRecord()
        rec.validate(DimensionFlags.SPATIAL_2D)
        rec.validate(DimensionFlags.TIMELAPSE)  # has a default, passes
        with pytest.raises(ValueError, match="z_planes is required for Z_STACK"):
            rec.validate(DimensionFlags.Z_STACK)
        CustomRecord(z_planes=5).validate(
            DimensionFlags.Z_STACK | DimensionFlags.TIMELAPSE
        )

    def test_model_logger_exists(self):
        import logging

        import arcadia_microscopy_tools_tpu_torch.model as model_module

        assert isinstance(model_module.logger, logging.Logger)


class TestNewGoldenFixtures:
    """The round-5 real fixtures (reference tests/data: example-pbmc.nd2,
    example-cerevisiae.nd2) exercise the from-scratch ND2 reader on files it
    was never tuned on; no NIS-Elements transcription exists for them, so
    these tests pin decode shape, channel inference, and intensity sanity."""

    def test_pbmc_decodes(self, test_data_directory):
        image = MicroscopyImage.from_nd2_path(
            test_data_directory / "example-pbmc.nd2"
        )
        assert [c.name for c in image.channels] == [
            "BRIGHTFIELD", "DAPI", "FITC", "TRITC",
        ]
        assert image.shape == (4, 256, 256)
        assert image.dimensions.is_multichannel
        dapi = np.asarray(image.get_channel_intensities("DAPI"))
        assert dapi.dtype == np.uint16
        # stained nuclei over a dim background: the decoded range is pinned.
        # (The reference's `dapi.max() > 4 * dapi.min()` wraps in uint16,
        # 4 * 18367 = 73468 -> 7932, and would fail in exact arithmetic: the
        # range spans 3.2x.)
        assert (int(dapi.min()), int(dapi.max())) == (18367, 59176)

    def test_cerevisiae_decodes(self, test_data_directory):
        image = MicroscopyImage.from_nd2_path(
            test_data_directory / "example-cerevisiae.nd2"
        )
        assert [c.name for c in image.channels] == ["DIC", "FITC"]
        assert image.shape == (2, 256, 256)
        fitc = np.asarray(image.get_channel_intensities("FITC"))
        assert fitc.dtype == np.uint16 and fitc.max() > 1000
