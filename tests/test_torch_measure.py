"""PyTorch port: foreground compaction and per-cell measurement against
the JAX package."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from arcadia_microscopy_tools_tpu.ops import compaction as jax_compaction
from arcadia_microscopy_tools_tpu.ops import labeling as jax_labeling
from arcadia_microscopy_tools_tpu.ops import regionprops as jax_regionprops
from arcadia_microscopy_tools_tpu_torch.ops import compaction, regionprops

# the suite runs in several worker processes at once; one torch thread per
# process keeps them from oversubscribing the host's cores
torch.set_num_threads(1)

SHAPE = (192, 320)

# The reference accumulates its segment sums through bf16 hi/lo splits in
# float32; the port sums in float64. Float columns agree to rtol 1e-5 plus
# atol 1e-4 (coordinates and intensities are O(1e2-1e4)).
RTOL, ATOL = 1e-5, 1e-4

INTEGER_PROPS = [
    "label", "valid", "area",
    "bbox_min_row", "bbox_min_col", "bbox_max_row", "bbox_max_col",
]
FLOAT_PROPS = [
    "centroid_y", "centroid_x", "perimeter", "eccentricity",
    "axis_major_length", "axis_minor_length", "extent",
]


def _mask(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    noise = ndi.gaussian_filter(rng.random(SHAPE), 3)
    return noise > np.quantile(noise, 0.75)


@pytest.fixture(scope="module")
def case():
    """Two images: JAX roots, JAX compaction, and 3 intensity channels."""
    rng = np.random.default_rng(5)
    masks = [_mask(s) for s in (1, 2)]
    roots = [jax_labeling.component_roots(jnp.asarray(m))[0] for m in masks]
    stacks = rng.integers(0, 4000, (2, 3) + SHAPE).astype(np.uint16)
    return masks, roots, stacks


@pytest.mark.parametrize("cap", [4096, 16384])
def test_compact_by_root_is_bit_identical(case, cap):
    """cap 4096 overflows (fewer slots than foreground pixels)."""
    _, roots, _ = case
    stacked = torch.from_numpy(np.stack([np.asarray(r) for r in roots]))
    ours = compaction.compact_by_root(stacked, cap)
    for k, r in enumerate(roots):
        ref = jax_compaction.compact_by_root(r, cap)
        for field in ref._fields:
            np.testing.assert_array_equal(
                getattr(ours, field)[k].numpy(), np.asarray(getattr(ref, field)), err_msg=field
            )
    assert bool(ours.overflow.any()) == (cap == 4096)


def _measure_both(case, max_cells, cap=16384):
    """JAX and port measurements, both fed the JAX compaction and roots."""
    _, roots, stacks = case
    comps = [jax_compaction.compact_by_root(r, cap) for r in roots]
    refs = [
        jax_regionprops.measure_compacted(
            c.seg, c.idx, r, jnp.asarray(stacks[k]), max_cells, SHAPE[1]
        )
        for k, (c, r) in enumerate(zip(comps, roots))
    ]

    def stacked(arrays):
        return torch.from_numpy(np.stack([np.asarray(a) for a in arrays]))

    ours = regionprops.measure_compacted(
        stacked([c.seg for c in comps]),
        stacked([c.idx for c in comps]),
        stacked(roots),
        torch.from_numpy(stacks),
        max_cells,
        SHAPE[1],
    )
    return refs, ours


def _exact_moment_ties(roots: np.ndarray, max_cells: int) -> np.ndarray:
    """Per cell slot, in scan order: whether the exact central moments tie
    (mu20 == mu02, in integer arithmetic)."""
    n = roots.size
    tie = np.zeros(max_cells, bool)
    # the last slot may merge several components: left out
    for slot, r in enumerate(np.unique(roots[roots < n])[: max_cells - 1]):
        ys, xs = np.nonzero(roots == r)
        ys, xs, m = ys.astype(np.int64), xs.astype(np.int64), len(ys)
        tie[slot] = m * (ys * ys).sum() - ys.sum() ** 2 == m * (xs * xs).sum() - xs.sum() ** 2
    return tie


@pytest.mark.parametrize("max_cells", [256, 40])
def test_measure_compacted_matches_jax(case, max_cells):
    """Fed the reference's seg, idx and roots. max_cells=40 is below the
    component count, so the last slot merges the rest as in the reference."""
    _, roots, _ = case
    refs, (props, intensity) = _measure_both(case, max_cells)
    for k, (ref_props, ref_int) in enumerate(refs):
        for name in INTEGER_PROPS:
            np.testing.assert_array_equal(
                props[name][k].numpy(), np.asarray(ref_props[name]), err_msg=name
            )
        for name in FLOAT_PROPS:
            np.testing.assert_allclose(
                props[name][k].numpy(), np.asarray(ref_props[name]),
                rtol=RTOL, atol=ATOL, err_msg=name,
            )
        # orientation is an axis angle (+-pi/2 are one axis) and is
        # ill-conditioned for near-round cells: held modulo pi on cells with
        # eccentricity above 0.3. On cells whose exact moments tie
        # (mu20 == mu02) skimage's formula jumps between +pi/4 and -pi/4
        # with the last bit of rounding (ROADMAP queue 3): there both sides
        # must give +-pi/4.
        ours_o = props["orientation"][k].numpy()
        ref_o = np.asarray(ref_props["orientation"])
        tie = _exact_moment_ties(np.asarray(roots[k]), max_cells)
        np.testing.assert_allclose(np.abs(ours_o[tie]), np.pi / 4, rtol=0, atol=1e-4)
        np.testing.assert_allclose(np.abs(ref_o[tie]), np.pi / 4, rtol=0, atol=1e-4)
        d = np.abs(ours_o - ref_o)
        d = np.minimum(d, np.pi - d)
        held = (np.asarray(ref_props["eccentricity"]) > 0.3) & ~tie
        assert (d[held] <= 1e-4).all()
        for ci, stats in ref_int.items():
            for stat, ref in stats.items():
                np.testing.assert_allclose(
                    intensity[ci][stat][k].numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL,
                    err_msg=f"{ci}/{stat}",
                )


def test_output_names_and_dtypes(case):
    _, (props, intensity) = _measure_both(case, 64)
    expected = {
        name: str(dtype.dtype) if hasattr(dtype, "dtype") else np.dtype(dtype).name
        for name, dtype in jax_regionprops.PROPERTY_DTYPES.items()
    }
    for name, dtype in expected.items():
        assert str(props[name].dtype) == f"torch.{dtype}", name
    assert props["valid"].dtype == torch.bool
    stats = {"intensity_mean", "intensity_max", "intensity_min", "intensity_std"}
    assert set(intensity[0]) == stats
    assert all(v.dtype == torch.float32 for v in intensity[2].values())


def test_unbatched_inputs(case):
    _, roots, stacks = case
    r = torch.from_numpy(np.array(roots[0]))
    comp = compaction.compact_by_root(r, 16384)
    props, intensity = regionprops.measure_compacted(
        comp.seg, comp.idx, r, torch.from_numpy(stacks[0]), 64, SHAPE[1]
    )
    assert props["area"].shape == (64,) and intensity[1]["intensity_mean"].shape == (64,)
