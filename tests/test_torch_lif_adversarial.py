"""PyTorch port: the twins of tests/test_lif_adversarial.py, run against the
port's own LIF reader (`arcadia_microscopy_tools_tpu_torch.io.lif`).

The containers are built byte by byte by the helpers of
test_lif_adversarial.py (no LifBuilder), and the builder's framing is
audited by its independent decoder `walk_blocks`; see that module's
docstring for the three ways it breaks the writer/reader circularity.
"""

import numpy as np
import pytest

from lif_builder import LifBuilder, simple_confocal_lif
from arcadia_microscopy_tools_tpu_torch.io.lif import LifFile, LifParseError
from test_lif_adversarial import (
    _header_block,
    _image_xml,
    _lasx_container_xml,
    _memory_block,
    _pixels,
    walk_blocks,
)


class TestHandConstructedContainers:
    def test_v2_lasx_nesting_roundtrip(self, tmp_path):
        """A hand-built v2 container with the real project-element nesting
        decodes to the exact pixels written."""
        w, h = 32, 24
        px = _pixels(w, h)
        xml = _lasx_container_xml(_image_xml("Series004", w, h, "MemBlock_21"))
        blob = _header_block(xml) + _memory_block("MemBlock_21", px.tobytes())
        path = tmp_path / "hand_v2.lif"
        path.write_bytes(blob)

        f = LifFile(path)
        img = f.images["Series004"]
        assert img.sizes == {"Y": h, "X": w}
        np.testing.assert_array_equal(img.asarray(), px[0])
        assert img.path == "project.lif/Series004"

    def test_v1_u32_memsize(self, tmp_path):
        """LIF v1 stores the memory size as u32 (no u64): the reader must
        key the field width off the XML Version attribute."""
        w, h = 16, 8
        px = _pixels(w, h)
        xml = _lasx_container_xml(
            _image_xml("Old", w, h, "MemBlock_0"), version=1
        )
        blob = _header_block(xml) + _memory_block("MemBlock_0", px.tobytes(), version=1)
        path = tmp_path / "hand_v1.lif"
        path.write_bytes(blob)

        img = LifFile(path).images["Old"]
        np.testing.assert_array_equal(img.asarray(), px[0])

    def test_v1_framing_is_not_v2_compatible(self, tmp_path):
        """Sanity check on the spec understanding itself: a v1-framed block
        labeled Version=2 must NOT decode cleanly (the 4-byte size-field
        difference misaligns everything after it). Guards against reader
        and builder agreeing on a wrong, version-independent framing."""
        w, h = 16, 8
        px = _pixels(w, h)
        xml = _lasx_container_xml(_image_xml("Bad", w, h, "MemBlock_0"), version=2)
        blob = _header_block(xml) + _memory_block("MemBlock_0", px.tobytes(), version=1)
        path = tmp_path / "mixed.lif"
        path.write_bytes(blob)
        with pytest.raises(LifParseError):
            LifFile(path).images["Bad"].asarray()

    def test_empty_memory_block(self, tmp_path):
        """A zero-size memory block parses (LAS X writes them for aborted
        series); using it for pixels fails loudly."""
        w, h = 16, 8
        xml = _lasx_container_xml(_image_xml("Aborted", w, h, "MemBlock_0"))
        blob = _header_block(xml) + _memory_block("MemBlock_0", b"")
        path = tmp_path / "empty_block.lif"
        path.write_bytes(blob)

        f = LifFile(path)  # container parses
        with pytest.raises(LifParseError, match="holds 0 bytes"):
            f.images["Aborted"].asarray()

    def test_duplicate_element_names(self, tmp_path):
        """LAS X allows duplicate series names; lookup returns the first,
        iteration preserves both, and unique paths disambiguate."""
        w, h = 8, 8
        a = _pixels(w, h, seed=1)
        b = _pixels(w, h, seed=2)
        xml = _lasx_container_xml(
            _image_xml("Series001", w, h, "MemBlock_0")
            + _image_xml("Series001", w, h, "MemBlock_1")
        )
        blob = (
            _header_block(xml)
            + _memory_block("MemBlock_0", a.tobytes())
            + _memory_block("MemBlock_1", b.tobytes())
        )
        path = tmp_path / "dup.lif"
        path.write_bytes(blob)

        f = LifFile(path)
        assert len(f.images) == 2
        np.testing.assert_array_equal(f.images["Series001"].asarray(), a[0])
        np.testing.assert_array_equal(f.images[1].asarray(), b[0])

    def test_missing_timestamplist(self, tmp_path):
        """No TimeStampList element at all -> empty timestamps (the Leica
        interpreter falls back to its placeholder, reference
        leica.py:634-645)."""
        w, h = 8, 8
        px = _pixels(w, h)
        xml = _lasx_container_xml(
            _image_xml("NoTime", w, h, "MemBlock_0", timestamps=None)
        )
        blob = _header_block(xml) + _memory_block("MemBlock_0", px.tobytes())
        path = tmp_path / "no_time.lif"
        path.write_bytes(blob)

        img = LifFile(path).images["NoTime"]
        assert img.timestamps == []
        np.testing.assert_array_equal(img.asarray(), px[0])

    def test_timestamp_child_element_format(self, tmp_path):
        """Older LAS X writes <TimeStamp HighInteger= LowInteger=> children
        instead of hex text; both forms must decode to the same instant."""
        w, h = 8, 8
        px = _pixels(w, h)
        ticks = 0x01D1A2B3C4D5E6F0
        extra = (
            '<TimeStampList NumberOfTimeStamps="1">'
            f'<TimeStamp HighInteger="{ticks >> 32}" LowInteger="{ticks & 0xFFFFFFFF}"/>'
            "</TimeStampList>"
        )
        xml = _lasx_container_xml(
            _image_xml("Legacy", w, h, "MemBlock_0", timestamps=None, extra=extra)
        )
        blob = _header_block(xml) + _memory_block("MemBlock_0", px.tobytes())
        path = tmp_path / "legacy_ts.lif"
        path.write_bytes(blob)
        legacy = LifFile(path).images["Legacy"].timestamps

        xml2 = _lasx_container_xml(
            _image_xml("Modern", w, h, "MemBlock_0", timestamps=format(ticks, "x"))
        )
        path2 = tmp_path / "modern_ts.lif"
        path2.write_bytes(_header_block(xml2) + _memory_block("MemBlock_0", px.tobytes()))
        modern = LifFile(path2).images["Modern"].timestamps

        assert len(legacy) == len(modern) == 1
        assert legacy[0] == modern[0]

    def test_trailing_garbage_smaller_than_block_header(self, tmp_path):
        """Up to 12 trailing bytes cannot start a block; they are ignored
        (LAS X pads some containers)."""
        w, h = 8, 8
        px = _pixels(w, h)
        xml = _lasx_container_xml(_image_xml("S", w, h, "MemBlock_0"))
        blob = _header_block(xml) + _memory_block("MemBlock_0", px.tobytes())
        path = tmp_path / "padded.lif"
        path.write_bytes(blob + b"\x00" * 12)
        np.testing.assert_array_equal(LifFile(path).images["S"].asarray(), px[0])


class TestTruncationBoundaries:
    """Cutting the container at every structural boundary must raise
    LifParseError - never a leaked struct.error/IndexError, and never
    silently-shortened pixels."""

    @pytest.fixture
    def container(self, tmp_path):
        w, h = 32, 16
        px = _pixels(w, h)
        xml = _lasx_container_xml(_image_xml("S", w, h, "MemBlock_0"))
        blob = _header_block(xml) + _memory_block("MemBlock_0", px.tobytes())
        header_len = len(_header_block(xml))
        return blob, header_len, tmp_path

    def _expect_parse_error(self, tmp_path, blob):
        path = tmp_path / "cut.lif"
        path.write_bytes(blob)
        with pytest.raises(LifParseError):
            f = LifFile(path)
            # even if the container walk survives, pixel decode must fail
            # rather than return short data
            f.images[0].asarray()

    def test_cut_inside_header_magic(self, container):
        blob, _, tmp_path = container
        self._expect_parse_error(tmp_path, blob[:3])

    def test_cut_inside_xml(self, container):
        blob, header_len, tmp_path = container
        self._expect_parse_error(tmp_path, blob[: header_len // 2])

    def test_cut_inside_block_header(self, container):
        blob, header_len, tmp_path = container
        # 6 bytes into the memory-block header (mid size field)
        self._expect_parse_error(tmp_path, blob[: header_len + 6])

    def test_cut_inside_block_id(self, container):
        blob, header_len, tmp_path = container
        # magic(4)+len(4)+2a(1)+u64(8)+2a(1)+nchars(4)+4 bytes of the id
        self._expect_parse_error(tmp_path, blob[: header_len + 22 + 4])

    def test_cut_inside_pixels(self, container):
        blob, _, tmp_path = container
        self._expect_parse_error(tmp_path, blob[:-100])

    def test_not_a_lif(self, tmp_path):
        path = tmp_path / "x.lif"
        path.write_bytes(b"MM\x00*definitely a tiff")
        with pytest.raises(LifParseError, match="bad magic"):
            LifFile(path)


class TestBuilderFramingAudit:
    def test_builder_output_passes_independent_decoder(self, tmp_path):
        path = tmp_path / "built.lif"
        data = simple_confocal_lif(path)
        raw = path.read_bytes()
        xml, blocks = walk_blocks(raw, version=2)
        assert "<LMSDataContainerHeader" in xml
        assert [b[0] for b in blocks] == ["MemBlock_0"]
        assert blocks[0][1] == np.ascontiguousarray(data.astype("<u2")).tobytes()

    def test_builder_multi_image_framing(self, tmp_path):
        b = LifBuilder()
        rng = np.random.default_rng(3)
        imgs = []
        for i in range(3):
            px = (rng.random((2, 8, 16)) * 1000).astype(np.uint16)
            imgs.append(px)
            b.add_image(
                f"S{i}",
                px,
                dims=[(1, 16, 16 * 2.84e-7, "m"), (2, 8, 8 * 2.84e-7, "m")],
            )
        path = tmp_path / "multi.lif"
        b.write(path)
        xml, blocks = walk_blocks(path.read_bytes(), version=2)
        assert [bid for bid, _ in blocks] == ["MemBlock_0", "MemBlock_1", "MemBlock_2"]
        for (bid, payload), px in zip(blocks, imgs):
            assert payload == np.ascontiguousarray(px.astype("<u2")).tobytes()
        # and the reader agrees with the independent decoder's payloads
        f = LifFile(path)
        for i, px in enumerate(imgs):
            np.testing.assert_array_equal(f.images[f"S{i}"].asarray(), px)
