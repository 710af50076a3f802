"""PyTorch port: its Leica LIF ingest against the JAX package's on the same
containers.

Every container of tests/test_leica.py (and a few more axis layouts) is
written with tests/lif_builder.py and read by both packages'
`load_lif_image`. They must give the same pixels (dtype and shape too), the
same metadata tree field by field, the same warnings (category name and
message) and the same errors (type name and message). `list_image_names`,
`MicroscopyImage.from_lif_path` and the Raman helpers are held the same way.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest

from arcadia_microscopy_tools_tpu import MicroscopyImage as JaxImage
from arcadia_microscopy_tools_tpu import leica as jax_leica
from arcadia_microscopy_tools_tpu.channels import FITC as JAX_FITC
from arcadia_microscopy_tools_tpu.channels import SRS as JAX_SRS
from arcadia_microscopy_tools_tpu_torch import MicroscopyImage, leica
from arcadia_microscopy_tools_tpu_torch.channels import FITC, SRS
from lif_builder import LifBuilder, simple_confocal_lif
from test_torch_nd2_readers import _assert_same_tree

XY = [(1, 16, 16 * 0.3e-6, "m"), (2, 16, 16 * 0.3e-6, "m")]
WLL_ON = {"LightSourceType": "4", "LightSourceName": "SuperContVisible Light",
          "WavelengthDouble": "488", "PowerState": "On"}
CRS_ON = {"LightSourceType": "6", "LightSourceName": "CARS Light (Attenuator)",
          "WavelengthDouble": "797", "PowerState": "On"}


def _data(*shape, seed=0):
    return (np.random.default_rng(seed).random(shape) * 1000).astype(np.uint16)


def _one(path, name, data, dims=XY, **kwargs):
    b = LifBuilder()
    b.add_image(name, data, dims=dims, **kwargs)
    b.write(path)
    return path


def _detector(detector, route, lasers=(CRS_ON, WLL_ON)):
    return lambda p: _one(p, "S", _data(1, 16, 16), lasers=list(lasers),
                          channel_properties=[{"DetectorName": detector, "BeamRoute": route}])


TILES = [{"FieldX": str(i % 2), "FieldY": str(i // 2), "PosX": f"{0.001 + 1e-4 * (i % 2):.6f}",
          "PosY": f"{0.002 + 1e-4 * (i // 2):.6f}", "PosZ": f"{1e-4 + 1e-6 * i:.6f}"}
         for i in range(4)]
STEPS = [{"Step": str(i), "Wavelength": str(780 + 20 * i)} for i in range(3)]

# name -> (writer(path) -> path, image name, channels (None: inferred) or
# "fitc" / "fitc+srs" for an explicit list)
CASES = {
    "confocal": (lambda p: (simple_confocal_lif(p, name="S"), p)[1], "S", None),
    "confocal 64x48": (lambda p: (simple_confocal_lif(p, name="S", shape=(64, 48)), p)[1], "S",
                       None),
    "two channels, plane-sequential": (lambda p: _one(
        p, "S", _data(2, 32, 40), dims=[(1, 40, 40 * 0.3e-6, "m"), (2, 32, 32 * 0.3e-6, "m")],
        channel_properties=[{"DetectorName": "HyD S 1", "BeamRoute": "10;0"},
                            {"DetectorName": "HyD S 2", "BeamRoute": "10;1"}]), "S", None),
    "405 diode alone": (lambda p: _one(p, "S", _data(1, 16, 16), lasers=[
        {**WLL_ON, "PowerState": "Off"},
        {"LightSourceType": "1", "LightSourceName": "UV Light", "WavelengthDouble": "405",
         "PowerState": "On"}]), "S", None),
    "NIR fallback": (lambda p: _one(p, "S", _data(1, 16, 16), lasers=[
        {"LightSourceType": "1", "LightSourceName": "UV Light", "WavelengthDouble": "1040",
         "PowerState": "On"}]), "S", None),
    "wavelength in meters": (lambda p: _one(p, "S", _data(1, 16, 16), lasers=[
        {**WLL_ON, "WavelengthDouble": "4.88e-07"}]), "S", None),
    "SRS": (_detector("F-SRS", "10;0"), "S", None),
    "E-SHG": (_detector("HyD NDD 2", "20;2"), "S", None),
    "E-CARS": (_detector("HyD NDD 1", "20;21"), "S", None),
    "F-CARS": (_detector("Trans PMT 2", "10;3"), "S", None),
    "brightfield ambiguity": (_detector("Trans PMT 3", "10;2"), "S", None),
    "unknown detector": (_detector("Mystery PMT", "0;0"), "S", None),
    "fluorescence detector beside CRS": (_detector("HyD S 1", "10;0"), "S", None),
    "CRS alone on a fluorescence detector": (_detector("HyD S 1", "10;0", (CRS_ON,)), "S", None),
    "no active laser": (lambda p: _one(p, "S", _data(1, 16, 16), lasers=[
        {**WLL_ON, "PowerState": "Off"}]), "S", None),
    "explicit channels": (lambda p: (simple_confocal_lif(p, name="S"), p)[1], "S", "fitc"),
    "wrong channel count": (lambda p: (simple_confocal_lif(p, name="S"), p)[1], "S", "fitc+srs"),
    "missing image": (lambda p: (simple_confocal_lif(p, name="S"), p)[1], "Nope", None),
    "Z": (lambda p: _one(p, "S", _data(1, 5, 32, 32), dims=[
        (1, 32, 32 * 0.3e-6, "m"), (2, 32, 32 * 0.3e-6, "m"), (3, 5, 10e-6, "m")]), "S", None),
    "T": (lambda p: _one(p, "S", _data(1, 4, 16, 16), dims=[*XY, (4, 4, 2.0, "s")]), "S", None),
    "two channels, T": (lambda p: _one(p, "S", _data(2, 3, 16, 16), dims=[*XY, (4, 3, 1.5, "s")]),
                        "S", None),
    "Z and T": (lambda p: _one(p, "S", _data(1, 2, 3, 16, 16), dims=[
        *XY, (3, 3, 6e-6, "m"), (4, 2, 1.0, "s")]), "S", None),
    "montage": (lambda p: _one(p, "S", _data(1, 4, 16, 16), dims=[*XY, (10, 4, 4.0, "m")],
                               tile_scan=TILES), "S", None),
    "montage with Z": (lambda p: _one(p, "S", _data(1, 2, 4, 16, 16), dims=[
        *XY, (3, 2, 4e-6, "m"), (10, 4, 4.0, "m")], tile_scan=TILES), "S", None),
    "lambda scan, laser values": (lambda p: _one(p, "S", _data(1, 3, 16, 16), dims=[
        *XY, (9, 3, 40e-9, "m")], laser_values=STEPS), "S", None),
    "lambda scan, Navigator": (lambda p: _one(p, "Scan_Merged", _data(1, 3, 16, 16), dims=[
        *XY, (9, 3, 40e-9, "m")], lambda_definition={
        "LambdaExcitationBeginDouble": "780", "LambdaExcitationEndDouble": "820",
        "LambdaExcitationStepCount": "3"}), "Scan_Merged", None),
    "exposure": (lambda p: _one(p, "S", _data(1, 32, 32), dims=[
        (1, 32, 32 * 0.3e-6, "m"), (2, 32, 32 * 0.3e-6, "m")], confocal={
        "PixelDwellTime": "2e-06", "LineAverage": "2", "FrameAccumulation": "3",
        "Line_Accumulation": "2", "FrameAverage": "4", "Zoom": "2.5", "ScanSpeed": "600"}),
        "S", None),
    "no timestamp": (lambda p: _one(p, "S", _data(1, 16, 16), timestamp=None), "S", None),
    "XY mismatch": (lambda p: _one(p, "S", _data(1, 32, 32), dims=[
        (1, 32, 32 * 0.3e-6, "m"), (2, 32, 32 * 0.4e-6, "m")]), "S", None),
    "microscope config": (lambda p: _one(p, "S", _data(1, 16, 16), confocal={
        "Magnification": "63", "NumericalAperture": "1.4",
        "ObjectiveName": " HC PL APO 63x/1.40 OIL "}), "S", None),
}


def _load(load, path, name, channels):
    """(result, (error type name, message) or None, [(warning category name,
    message)]) of one `load_lif_image` call."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            result, error = load(path, name, channels), None
        except Exception as e:  # the error itself is what is compared
            result, error = None, (type(e).__name__, str(e))
    return result, error, [(w.category.__name__, str(w.message)) for w in caught]


@pytest.mark.parametrize("case", list(CASES))
def test_load_lif_image_matches_jax(case, tmp_path):
    write, name, explicit = CASES[case]
    path = write(tmp_path / "case.lif")
    channels = {None: (None, None), "fitc": ([FITC], [JAX_FITC]),
                "fitc+srs": ([FITC, SRS], [JAX_FITC, JAX_SRS])}[explicit]
    got, got_err, got_warn = _load(leica.load_lif_image, path, name, channels[0])
    want, want_err, want_warn = _load(jax_leica.load_lif_image, path, name, channels[1])
    assert got_err == want_err
    assert got_warn == want_warn
    if want is None:
        return
    (pixels, meta), (ref_pixels, ref_meta) = got, want
    assert pixels.dtype == ref_pixels.dtype and pixels.shape == ref_pixels.shape
    np.testing.assert_array_equal(pixels, ref_pixels)
    assert pixels.flags.writeable and pixels.flags.c_contiguous
    _assert_same_tree(meta, ref_meta)


def test_list_image_names_matches_jax(tmp_path):
    b = LifBuilder()
    for k, name in enumerate(["A01", "Series 2", "A01"]):
        b.add_image(name, _data(1, 8, 8, seed=k), dims=[(1, 8, 8e-6, "m"), (2, 8, 8e-6, "m")])
    path = tmp_path / "plate.lif"
    b.write(path)
    assert leica.list_image_names(path) == jax_leica.list_image_names(path) == [
        "A01", "Series 2", "A01"]


@pytest.mark.parametrize("case", ["two channels, T", "Z", "brightfield ambiguity"])
def test_from_lif_path_matches_jax(case, tmp_path):
    write, name, _ = CASES[case]
    path = write(tmp_path / "case.lif")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        image = MicroscopyImage.from_lif_path(path, name, sample_metadata={"plate": 1})
        ref = JaxImage.from_lif_path(path, name, sample_metadata={"plate": 1})
    np.testing.assert_array_equal(image.intensities, ref.intensities)
    _assert_same_tree(image.metadata, ref.metadata)
    assert image.sizes == ref.sizes and repr(image.metadata) == repr(ref.metadata)
    on_cpu = image.device_intensities("cpu")
    np.testing.assert_array_equal(on_cpu.numpy(), ref.intensities)
    for channel in image.channels:
        np.testing.assert_array_equal(
            image.get_channel_intensities(channel.name, device="cpu").numpy(),
            np.asarray(ref.get_channel_intensities(channel.name)),
        )


@pytest.mark.parametrize("stokes", [1031.7, 1040.0])
def test_raman_helpers_match_jax(stokes):
    pumps = np.linspace(760.0, 880.0, 13)
    for fn in ("calculate_raman_shift", "calculate_antistokes_wavelength"):
        got, want = getattr(leica, fn), getattr(jax_leica, fn)
        np.testing.assert_array_equal(got(pumps, stokes), want(pumps, stokes))
        assert got(797.0) == want(797.0)
    assert leica.CRS_STOKES_WAVELENGTH_NM == jax_leica.CRS_STOKES_WAVELENGTH_NM


def _hand_built(path, width, height, resolution, channel_incs, x_inc, y_inc, payload):
    """A one-image container with the given byte geometry, framed by the
    hand-built blocks of test_lif_adversarial.py."""
    from test_lif_adversarial import _header_block, _memory_block

    channels = "".join(
        f'<ChannelDescription DataType="0" ChannelTag="0" Resolution="{resolution}" Min="0" '
        f'Max="65535" Unit="" LUTName="Gray" BytesInc="{inc}" BitInc="0"/>' for inc in channel_incs
    )
    xml = (
        '<LMSDataContainerHeader Version="2"><Element Name="project.lif"><Children>'
        '<Element Name="S"><Data><Image><ImageDescription>'
        f"<Channels>{channels}</Channels><Dimensions>"
        f'<DimensionDescription DimID="1" NumberOfElements="{width}" Origin="0" '
        f'Length="{width * 3e-7}" Unit="m" BitInc="0" BytesInc="{x_inc}"/>'
        f'<DimensionDescription DimID="2" NumberOfElements="{height}" Origin="0" '
        f'Length="{height * 3e-7}" Unit="m" BitInc="0" BytesInc="{y_inc}"/>'
        "</Dimensions></ImageDescription>"
        f'<Memory Size="{len(payload)}" MemoryBlockID="MemBlock_0"/>'
        '<TimeStampList NumberOfTimeStamps="1">1d1a2b3c4d5e6f0</TimeStampList>'
        "</Image></Data></Element></Children></Element></LMSDataContainerHeader>"
    )
    path.write_bytes(_header_block(xml) + _memory_block("MemBlock_0", payload))
    return path


# (resolution, channel BytesInc, X BytesInc, Y BytesInc, payload bytes) for a
# 6 x 5 image: the port's one strided view of the image's dtype against the
# reference's byte route, at item-size multiples and off them
GEOMETRIES = {
    "16-bit, odd first offset": (16, [1], 2, 12, 61),
    "16-bit, odd row stride": (16, [0], 2, 13, 66),
    "16-bit, two interleaved channels": (16, [0, 2], 4, 24, 120),
    "16-bit, second channel listed first: both raise": (16, [60, 0], 2, 12, 120),
    "16-bit, block one byte short: both raise": (16, [0], 2, 12, 59),
    "8-bit": (8, [0], 1, 6, 30),
    "8-bit, padded rows, odd offset": (8, [3], 1, 7, 40),
}


def _decode(lif_file, path):
    """(array, None) or (None, (error type name, message))."""
    try:
        return lif_file(path).images["S"].asarray(), None
    except Exception as e:  # the error itself is what is compared
        return None, (type(e).__name__, str(e))


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_decode_routes_match_jax(geometry, tmp_path):
    """The port's `LifImage.asarray` gives the reference's array, dtype and
    layout included, or raises its error, at every geometry."""
    from arcadia_microscopy_tools_tpu.io.lif import LifFile as JaxLifFile
    from arcadia_microscopy_tools_tpu_torch.io.lif import LifFile

    resolution, incs, x_inc, y_inc, size = GEOMETRIES[geometry]
    payload = np.random.default_rng(9).integers(0, 256, size, dtype=np.uint8).tobytes()
    path = _hand_built(tmp_path / "g.lif", 6, 5, resolution, incs, x_inc, y_inc, payload)
    (got, got_err), (want, want_err) = _decode(LifFile, path), _decode(JaxLifFile, path)
    assert got_err == want_err
    assert (want is None) == geometry.endswith("both raise")
    if want is None:
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.flags.c_contiguous and got.flags.writeable and got.flags.owndata


def test_open_cached_is_shared_across_threads(tmp_path):
    """Sixteen threads, more than the cores, load wells of one container at
    once with a short switch interval: one parse, and every thread gets its
    well's pixels."""
    import sys
    import threading

    from arcadia_microscopy_tools_tpu_torch.io import lif

    b = LifBuilder()
    planes = [_data(2, 24, 24, seed=k) for k in range(4)]
    for k, data in enumerate(planes):
        b.add_image(f"W{k}", data, dims=[(1, 24, 24e-6, "m"), (2, 24, 24e-6, "m")])
    path = tmp_path / "plate.lif"
    b.write(path)
    lif.clear_container_cache()
    parses, results, errors = [], {}, []
    orig = lif.LifFile._parse_container

    def counting(data):
        parses.append(1)
        return orig(data)

    def worker(k):
        try:
            for _ in range(5):
                pixels, _ = leica.load_lif_image(path, f"W{k % 4}")
                results.setdefault(k, []).append(pixels)
        except Exception as e:  # reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    lif.LifFile._parse_container = staticmethod(counting)
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        lif.LifFile._parse_container = staticmethod(orig)
        lif.clear_container_cache()
    assert not errors and len(parses) == 1
    for k, got in results.items():
        assert len(got) == 5
        for pixels in got:
            np.testing.assert_array_equal(pixels, planes[k % 4])
