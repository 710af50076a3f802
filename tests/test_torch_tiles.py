"""TileSource / stitch tests."""

import numpy as np
import torch

from arcadia_microscopy_tools_tpu_torch.io.tiles import (
    TileSource,
    TileSpec,
    stitch_labels,
    tile_image,
)


class TestTileImage:
    def test_exact_tiling(self, rng):
        img = (rng.random((2, 128, 128)) * 100).astype(np.uint16)
        spec = TileSpec(tile=64, halo=0, batch=4)
        tiles, origins = tile_image(img, spec)
        assert tiles.shape == (4, 2, 64, 64)
        assert origins == [(0, 0), (0, 64), (64, 0), (64, 64)]
        np.testing.assert_array_equal(tiles[0], img[:, :64, :64])
        np.testing.assert_array_equal(tiles[3], img[:, 64:, 64:])

    def test_halo_overlap(self, rng):
        img = (rng.random((1, 64, 64)) * 100).astype(np.uint16)
        spec = TileSpec(tile=32, halo=8, batch=4)
        tiles, origins = tile_image(img, spec)
        assert tiles.shape[-2:] == (48, 48)
        # interior halo carries true neighbor data
        np.testing.assert_array_equal(tiles[0][:, 8:40, 8:40], img[:, :32, :32])
        np.testing.assert_array_equal(tiles[1][:, 8:40, :8], img[:, :32, 24:32])

    def test_2d_input_promoted(self, rng):
        img = (rng.random((64, 64)) * 100).astype(np.uint16)
        tiles, _ = tile_image(img, TileSpec(tile=64))
        assert tiles.shape == (1, 1, 64, 64)


class TestStitch:
    def test_roundtrip_labels_unique(self, rng):
        spec = TileSpec(tile=32, halo=0)
        full_shape = (64, 64)
        # two tiles each containing one object labeled 1
        tiles = np.zeros((4, 32, 32), dtype=np.int64)
        tiles[0, 5:10, 5:10] = 1
        tiles[3, 2:6, 2:6] = 1
        origins = [(0, 0), (0, 32), (32, 0), (32, 32)]
        full = stitch_labels(tiles, origins, full_shape, spec)
        assert full.max() == 2  # globally unique labels
        assert (full[5:10, 5:10] > 0).all()
        assert (full[34:38, 34:38] > 0).all()

    def test_cross_seam_components_merge(self):
        """A cell straddling a tile boundary is ONE cell after stitching
        (round-1 verdict: the old stitcher split it in two)."""
        from arcadia_microscopy_tools_tpu_torch.io.tiles import tile_image
        from arcadia_microscopy_tools_tpu_torch.ops.labeling import label

        spec = TileSpec(tile=32, halo=0)
        mask = np.zeros((64, 64), dtype=bool)
        mask[28:38, 10:20] = True  # crosses the y=32 seam
        mask[10:20, 28:38] = True  # crosses the x=32 seam
        mask[40:46, 40:46] = True  # interior to one tile
        mask[30:34, 30:34] = True  # crosses BOTH seams at the corner

        tiles, origins = tile_image(mask[None].astype(np.uint16), spec)
        tile_labels = np.stack(
            [label(torch.from_numpy(t[0] > 0)).numpy() for t in tiles]
        )
        full = stitch_labels(tile_labels, origins, mask.shape, spec)

        direct = label(torch.from_numpy(mask)).numpy()
        assert full.max() == direct.max()  # same number of components
        # identical partition: each stitched label maps 1:1 onto a direct label
        pairs = {(int(a), int(b)) for a, b in zip(full[mask], direct[mask])}
        assert len(pairs) == direct.max()
        np.testing.assert_array_equal(full > 0, direct > 0)

    def test_stitch_diagonal_adjacency_across_seam(self):
        """8-connectivity holds across seams (diagonal-only contact)."""
        spec = TileSpec(tile=16, halo=0)
        mask = np.zeros((32, 16), dtype=bool)
        mask[14:16, 4:8] = True  # ends at row 15, cols 4-7
        mask[16:18, 8:12] = True  # starts at row 16, cols 8-11 (diag touch)
        from arcadia_microscopy_tools_tpu_torch.io.tiles import tile_image
        from arcadia_microscopy_tools_tpu_torch.ops.labeling import label

        tiles, origins = tile_image(mask[None].astype(np.uint16), spec)
        tile_labels = np.stack([label(torch.from_numpy(t[0] > 0)).numpy() for t in tiles])
        full = stitch_labels(tile_labels, origins, mask.shape, spec)
        assert full.max() == 1

    def test_halo_cropped(self):
        spec = TileSpec(tile=32, halo=4)
        tiles = np.zeros((1, 40, 40), dtype=np.int64)
        tiles[0, 4:36, 4:36] = 1
        full = stitch_labels(tiles, [(0, 0)], (32, 32), spec)
        assert full.shape == (32, 32)
        assert (full == 1).all()


class TestTileSource:
    def test_batches_fixed_shape(self, rng):
        spec = TileSpec(tile=64, halo=0, batch=3)
        src = TileSource(spec)
        items = [(f"w{i}", (rng.random((1, 64, 64)) * 10).astype(np.uint16)) for i in range(5)]
        batches = list(src.batches(iter(items)))
        assert len(batches) == 2
        keys0, arr0 = batches[0]
        assert arr0.shape == (3, 1, 64, 64)
        assert len(keys0) == 3
        keys1, arr1 = batches[1]
        assert arr1.shape == (3, 1, 64, 64)  # padded
        assert len(keys1) == 2  # only real keys reported

    def test_large_image_split(self, rng):
        spec = TileSpec(tile=64, halo=0, batch=4)
        src = TileSource(spec)
        img = (rng.random((1, 128, 128)) * 10).astype(np.uint16)
        batches = list(src.batches(iter([("well", img)])))
        assert len(batches) == 1
        keys, arr = batches[0]
        assert arr.shape == (4, 1, 64, 64)
        assert [k[1] for k in keys] == [(0, 0), (0, 64), (64, 0), (64, 64)]
