"""PyTorch port: Cellpose's tiling and taper blend for Cellpose-SAM
(`models/sam_tiles.py`) against a numpy transcription of Cellpose's
`make_tiles`, `average_tiles` and `_taper_mask` (cellpose/transforms.py),
at 2048, 300 and 200 pixels (200 < 256: the axis is zero-padded to the
tile first, centred, as the segmentation entry does before `make_tiles`).

The tiles are copies, so they must be equal. The blend is float32 on both
sides but sums in another order (Cellpose adds each tile's float64
product into float32 and divides by float64 weights; the port multiplies,
adds and divides in float32), so it agrees to a few float32 ulps: rtol 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu_torch.models import sam_tiles

torch.set_num_threads(1)

BSIZE = 256


# --- Cellpose's three functions, transcribed (no augment) --------------------

def cp_make_tiles(imgi, bsize=224, tile_overlap=0.1):
    nchan, ly, lx = imgi.shape
    tile_overlap = min(0.5, max(0.05, tile_overlap))
    bsize_y, bsize_x = np.int32(min(bsize, ly)), np.int32(min(bsize, lx))
    ny = 1 if ly <= bsize else int(np.ceil((1.0 + 2 * tile_overlap) * ly / bsize))
    nx = 1 if lx <= bsize else int(np.ceil((1.0 + 2 * tile_overlap) * lx / bsize))
    ystart = np.linspace(0, ly - bsize_y, ny).astype(int)
    xstart = np.linspace(0, lx - bsize_x, nx).astype(int)
    ysub, xsub = [], []
    img = np.zeros((len(ystart), len(xstart), nchan, bsize_y, bsize_x), np.float32)
    for j in range(len(ystart)):
        for i in range(len(xstart)):
            ysub.append([ystart[j], ystart[j] + bsize_y])
            xsub.append([xstart[i], xstart[i] + bsize_x])
            img[j, i] = imgi[:, ysub[-1][0] : ysub[-1][1], xsub[-1][0] : xsub[-1][1]]
    return img, ysub, xsub, ly, lx


def cp_taper_mask(ly=224, lx=224, sig=7.5):
    bsize = max(224, max(ly, lx))
    xm = np.arange(bsize)
    xm = np.abs(xm - xm.mean())
    mask = 1 / (1 + np.exp((xm - (bsize / 2 - 20)) / sig))
    mask = mask * mask[:, np.newaxis]
    return mask[bsize // 2 - ly // 2 : bsize // 2 + ly // 2 + ly % 2,
                bsize // 2 - lx // 2 : bsize // 2 + lx // 2 + lx % 2]


def cp_average_tiles(y, ysub, xsub, ly, lx):
    navg = np.zeros((ly, lx))
    yf = np.zeros((y.shape[1], ly, lx), np.float32)
    mask = cp_taper_mask(ly=y.shape[-2], lx=y.shape[-1])
    for j in range(len(ysub)):
        yf[:, ysub[j][0] : ysub[j][1], xsub[j][0] : xsub[j][1]] += y[j] * mask
        navg[ysub[j][0] : ysub[j][1], xsub[j][0] : xsub[j][1]] += mask
    yf /= navg
    return yf


def _padded(img: np.ndarray) -> tuple[np.ndarray, tuple[int, int]]:
    _, h, w = img.shape
    top, left = max(0, BSIZE - h) // 2, max(0, BSIZE - w) // 2
    pad = ((0, 0), (top, max(0, BSIZE - h) - top), (left, max(0, BSIZE - w) - left))
    return np.pad(img, pad), (top, left)


SIZES = [(2048, 2048), (300, 300), (200, 200), (300, 2048), (200, 300)]


@pytest.mark.parametrize("h, w", SIZES)
def test_tiles_equal_cellpose(h, w):
    img = np.random.default_rng(h * w).random((3, h, w)).astype(np.float32)
    cp_img, offsets = _padded(img)
    want, ysub, xsub, _, _ = cp_make_tiles(cp_img, BSIZE)
    padded, got_offsets = sam_tiles.pad_to_tile(torch.from_numpy(img)[None], BSIZE)
    got = sam_tiles.make_tiles(padded, BSIZE).numpy()
    assert got_offsets == offsets
    assert got.shape == (want.shape[0] * want.shape[1], 3, BSIZE, BSIZE)
    assert np.array_equal(got, want.reshape(got.shape))
    assert sam_tiles.tile_count(h, w, BSIZE) == len(ysub)
    if (h, w) == (2048, 2048):
        assert len(ysub) == 100 and sam_tiles.tile_starts(2048, BSIZE)[:3] == (0, 199, 398)


@pytest.mark.parametrize("h, w", SIZES)
def test_blend_equals_cellpose(h, w):
    rng = np.random.default_rng(h + w)
    ly, lx = max(h, BSIZE), max(w, BSIZE)
    n = sam_tiles.tile_count(h, w, BSIZE)
    y = rng.normal(size=(n, 3, BSIZE, BSIZE)).astype(np.float32)
    _, ysub, xsub, _, _ = cp_make_tiles(np.zeros((1, ly, lx), np.float32), BSIZE)
    want = cp_average_tiles(y, ysub, xsub, ly, lx)
    got = sam_tiles.average_tiles(torch.from_numpy(y), 1, ly, lx)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the crop back to the image takes the window the pad put it in
    _, offsets = _padded(np.zeros((1, h, w), np.float32))
    cropped = sam_tiles.crop_padding(torch.from_numpy(got)[None], offsets, (h, w))[0].numpy()
    top, left = offsets
    assert np.array_equal(cropped, got[:, top : top + h, left : left + w])


def test_blend_of_two_images_is_each_alone():
    rng = np.random.default_rng(3)
    n = sam_tiles.tile_count(300, 300, BSIZE)
    y = torch.from_numpy(rng.normal(size=(2 * n, 3, BSIZE, BSIZE)).astype(np.float32))
    both = sam_tiles.average_tiles(y, 2, 300, 300)
    for i in range(2):
        assert torch.equal(both[i], sam_tiles.average_tiles(y[i * n : (i + 1) * n], 1, 300, 300)[0])


@pytest.mark.parametrize("ly, lx", [(256, 256), (64, 64), (300, 200)])
def test_taper_mask_is_cellpose(ly, lx):
    assert np.array_equal(sam_tiles.taper_mask(ly, lx), cp_taper_mask(ly, lx))


def test_constant_tiles_blend_to_the_constant():
    """Weights are normalised: tiles that all say c blend to c everywhere."""
    n = sam_tiles.tile_count(2048, 2048, BSIZE)
    y = torch.full((n, 3, BSIZE, BSIZE), 2.5)
    out = sam_tiles.average_tiles(y, 1, 2048, 2048)
    torch.testing.assert_close(out, torch.full_like(out, 2.5), rtol=1e-6, atol=1e-6)


def test_short_axis_without_padding_raises():
    with pytest.raises(ValueError, match="shorter than"):
        sam_tiles.tile_starts(200, BSIZE)
