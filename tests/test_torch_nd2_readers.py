"""PyTorch port: its ND2 reader against the JAX package's on the five real
fixtures, and the device side of its `MicroscopyImage` (from ND2 and LIF).

Both readers must give the same pixels (dtype and shape too) and the same
metadata tree, field by field, through `load_nd2` and
`MicroscopyImage.from_nd2_path`.
"""

from __future__ import annotations

import dataclasses
import enum
from pathlib import Path

import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu import MicroscopyImage as JaxImage
from arcadia_microscopy_tools_tpu.io.nikon import load_nd2 as jax_load_nd2
from arcadia_microscopy_tools_tpu_torch import MicroscopyImage
from arcadia_microscopy_tools_tpu_torch.io import load_nd2

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
FIXTURES = [
    "example-multichannel",
    "example-timelapse",
    "example-zstack",
    "example-pbmc",
    "example-cerevisiae",
]


def _assert_same_tree(a, b, path="metadata"):
    """Field-by-field equality of two metadata trees whose classes live in
    different packages: same class names, equal leaves (arrays exactly)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same_tree(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, enum.Enum):
        assert (type(a).__name__, a.value) == (type(b).__name__, b.value), path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}[{k}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
        assert a.dtype == b.dtype, path
    else:
        assert a == b or (a != a and b != b), (path, a, b)  # NaN equals NaN here


@pytest.mark.parametrize("name", FIXTURES)
def test_both_readers_give_the_same_pixels_and_metadata(name):
    path = DATA / f"{name}.nd2"
    pixels, instrument = load_nd2(path)
    ref_pixels, ref_instrument = jax_load_nd2(path)
    assert pixels.dtype == ref_pixels.dtype == np.uint16
    np.testing.assert_array_equal(pixels, ref_pixels)
    _assert_same_tree(instrument, ref_instrument)

    image, ref = MicroscopyImage.from_nd2_path(path), JaxImage.from_nd2_path(path)
    assert image.sizes == ref.sizes
    assert [c.name for c in image.channels] == [c.name for c in ref.channels]
    _assert_same_tree(image.metadata, ref.metadata)
    for channel in image.channels:
        np.testing.assert_array_equal(
            image.get_channel_intensities(channel), np.asarray(ref.get_channel_intensities(channel.name))
        )


class TestDeviceIntensities:
    def test_cpu_copy_is_cached_and_sliced(self):
        image = MicroscopyImage.from_nd2_path(DATA / "example-multichannel.nd2")
        t = image.device_intensities("cpu")
        assert isinstance(t, torch.Tensor) and t.dtype == torch.uint16
        assert image.device_intensities("cpu") is t
        dapi = image.get_channel_intensities("DAPI", device="cpu")
        assert dapi.data_ptr() != 0 and dapi.shape == (256, 256)
        np.testing.assert_array_equal(dapi.numpy(), image.get_channel_intensities("DAPI"))

    def test_default_device_is_the_card_or_raises(self):
        image = MicroscopyImage.from_nd2_path(DATA / "example-cerevisiae.nd2")
        if torch.cuda.is_available():
            assert image.device_intensities().device.type == "cuda"
            assert image.get_channel_intensities("FITC", device=True).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                image.device_intensities()
            with pytest.raises(RuntimeError, match="device='cpu'"):
                image.get_channel_intensities("FITC", device=True)

    def test_tensor_intensities_are_accepted(self):
        """A torch uint16 tensor is a valid intensity array (no dtype
        warning), and the image prints."""
        import warnings

        image = MicroscopyImage.from_nd2_path(DATA / "example-cerevisiae.nd2")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            t_image = MicroscopyImage(torch.from_numpy(image.intensities), image.metadata)
        assert "dtype=torch.uint16" in repr(t_image)

    def test_from_lif_path_loads_a_built_container(self, tmp_path):
        """The name is kept from when `from_lif_path` raised; it now loads a
        container that tests/lif_builder.py wrote, and its cached CPU copy
        slices like an ND2 image's."""
        from lif_builder import simple_confocal_lif

        path = tmp_path / "one.lif"
        data = simple_confocal_lif(path, name="S1", shape=(40, 56))
        image = MicroscopyImage.from_lif_path(path, "S1", sample_metadata={"well": "A01"})
        assert image.sizes == {"Y": 40, "X": 56} and image.metadata.sample == {"well": "A01"}
        np.testing.assert_array_equal(image.intensities, data[0])
        t = image.device_intensities("cpu")
        assert t.dtype == torch.uint16 and image.device_intensities("cpu") is t
        wll = image.get_channel_intensities("WLL", device="cpu")
        np.testing.assert_array_equal(wll.numpy(), data[0])
