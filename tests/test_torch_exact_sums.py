"""PyTorch port: exact, order-free per-cell sums, and the package exports.

Integer quantities (areas, coordinate moments, uint16 channel values and
their squares, perimeter class counts) are summed in int64, so any order of
the pixels, and any split of them into partial sums, gives the same bits;
the centred moments and variances derive from those sums. On the card, two
runs of the measurement give the same bits (marked gpu, skipped here).
"""

from __future__ import annotations

import threading
from fractions import Fraction

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

import arcadia_microscopy_tools_tpu.models as jax_models
import arcadia_microscopy_tools_tpu.parallel as jax_parallel
import arcadia_microscopy_tools_tpu_torch.models as port_models
import arcadia_microscopy_tools_tpu_torch.parallel as port_parallel
from arcadia_microscopy_tools_tpu_torch.ops import compaction, labeling, regionprops
from arcadia_microscopy_tools_tpu_torch.ops.segment_reduce import segment_sums
from arcadia_microscopy_tools_tpu_torch.testing import synthetic_wells

torch.set_num_threads(1)


def _case(seed: int = 3):
    rng = np.random.default_rng(seed)
    noise = ndi.gaussian_filter(rng.random((2, 96, 160)), (0, 3, 3))
    mask = torch.from_numpy(noise > np.quantile(noise, 0.7))
    roots, _ = labeling.component_roots(mask)
    comp = compaction.compact_by_root(roots, 96 * 160)
    stack = torch.from_numpy(rng.integers(0, 65536, (2, 3, 96, 160)).astype(np.uint16))
    return comp, roots, stack


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def test_integer_segment_sums_are_exact_past_float64():
    """Sums above 2^53 stay exact (float64 would round them)."""
    n = 1 << 13
    vals = torch.full((1, 1, n), (1 << 41) + 1, dtype=torch.int64)
    ids = torch.zeros((1, n), dtype=torch.int64)
    got = segment_sums(vals, ids, 1)
    assert got.dtype == torch.int64
    assert int(got[0, 0, 0]) == n * ((1 << 41) + 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_sums_ignore_the_order_of_the_pixels(seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(0, 65536, (2, 4, 5000)) ** 2)
    ids = torch.from_numpy(rng.integers(0, 40, (2, 5000)))
    perm = torch.from_numpy(rng.permutation(5000))
    assert torch.equal(segment_sums(q, ids, 40), segment_sums(q[..., perm], ids[:, perm], 40))


def test_split_partial_sums_add_up_to_the_whole():
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.integers(0, 1 << 32, (1, 3, 6000)))
    ids = torch.from_numpy(rng.integers(0, 17, (1, 6000)))
    whole = segment_sums(q, ids, 17)
    parts = segment_sums(q[..., :2500], ids[:, :2500], 17) + segment_sums(q[..., 2500:], ids[:, 2500:], 17)
    assert torch.equal(whole, parts)


def test_measure_compacted_ignores_the_order_within_segments():
    """Shuffling each segment's slots leaves every column's bits unchanged
    (the bbox rows come from segment extremes, the rest from exact sums)."""
    comp, roots, stack = _case()
    want = regionprops.measure_compacted(comp.seg, comp.idx, roots, stack, 64, 160)
    rng = np.random.default_rng(0)
    seg, idx = comp.seg.clone(), comp.idx.clone()
    for b in range(seg.shape[0]):
        for s in torch.unique(seg[b]).tolist():
            if s == 0:
                continue
            where = torch.nonzero(seg[b] == s)[:, 0]
            idx[b, where] = idx[b, where[torch.from_numpy(rng.permutation(len(where)))]]
    got = regionprops.measure_compacted(seg, idx, roots, stack, 64, 160)
    assert _equal(got[0], want[0]) and _equal(got[1], want[1])


def test_measure_segments_partials_over_two_slabs_equal_the_whole():
    """The per-slot partial results of two row slabs, combined by `reduce`,
    give the whole image's bits; with 8 slots the last one merges many
    components (its bbox_max_row reads the last of them)."""
    comp, roots, stack = _case()
    b, n = comp.seg.shape[0], 96 * 160
    seg = torch.zeros((b, n), dtype=torch.int64)
    seg.scatter_(1, comp.idx.long(), comp.seg.long())
    seg = seg.clamp_max(8)
    rl = torch.where(roots < n, roots + 1, 0)
    pclass = regionprops.perimeter_classes(rl).reshape(b, n)
    ys = torch.arange(96).repeat_interleave(160).expand(b, n)
    xs = torch.arange(160).repeat(96).expand(b, n)
    chans = stack.reshape(b, 3, n).long()
    root = roots.reshape(b, n).long()
    args = (seg, seg > 0, ys, xs, pclass, chans)
    whole = regionprops.measure_segments(*args, 8, root=root)
    assert int(comp.num_components.min()) > 8

    halves = [slice(0, 40 * 160), slice(40 * 160, n)]
    ops = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}
    slots: list = [None, None]
    barrier = threading.Barrier(2, timeout=60)
    results: list = [None, None]

    def slab(k):
        def reduce(t, op):  # the two slabs exchange their partials
            slots[k] = t
            barrier.wait()
            both = ops[op](slots[0], slots[1])
            barrier.wait()
            return both

        part = [a[..., halves[k]] for a in args]
        results[k] = regionprops.measure_segments(*part, 8, root=root[:, halves[k]], reduce=reduce)

    threads = [threading.Thread(target=slab, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    for got in results:
        assert _equal(got[0], whole[0]) and _equal(got[1], whole[1])


def test_centred_sums_equal_exact_rational_arithmetic():
    rng = np.random.default_rng(4)
    for n_px in (1, 2, 7, 300, 40000):
        a = rng.integers(0, 65536, n_px)
        bvals = rng.integers(0, 2048, n_px)
        n, sa, sb, sab = (torch.tensor([[v]], dtype=torch.int64) for v in
                          (n_px, int(a.sum()), int(bvals.sum()), int((a * bvals).sum())))
        got = float(regionprops._centred_sum(n, sa, sb, sab))
        ma, mb = Fraction(int(a.sum()), n_px), Fraction(int(bvals.sum()), n_px)
        want = sum((Fraction(int(x)) - ma) * (Fraction(int(y)) - mb) for x, y in zip(a, bvals))
        assert abs(got - float(want)) <= 1e-9 * max(1.0, abs(float(want)))


def test_exports_follow_the_jax_package():
    """`parallel` exports the JAX package's 11 names; `models` its names but
    the functional U-Net trio, which maps to the `UNet` module."""
    assert sorted(port_parallel.__all__) == sorted(jax_parallel.__all__)
    assert len(port_parallel.__all__) == 11
    functional = {"apply_unet", "init_unet", "count_params"}
    assert set(port_models.__all__) == (set(jax_models.__all__) - functional) | {"UNet"}
    for name in ("apply_unet", "init_unet", "count_params"):
        assert name in port_models.__doc__
    for module in (port_models, port_parallel):
        assert all(hasattr(module, name) for name in module.__all__)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_measurement_twice_on_the_card_gives_the_same_bits(cuda_device):
    """One 2048^2 4-channel well: measure_compacted (uint16 and float32
    channels), measure_labels and measure_intensity_stack, each twice."""
    from arcadia_microscopy_tools_tpu_torch.ops.fused import fused_classical_mask

    well = torch.from_numpy(synthetic_wells(1, 4, 2048, 2048, 300, seed=0)).to(cuda_device)
    mask = fused_classical_mask(well[:, 0])
    roots, _ = labeling.component_roots(mask)
    comp = compaction.compact_by_root(roots, 2048 * 2048 // 16)
    lbl = labeling.label(mask[0])
    cells = int(lbl.max())
    runs = [
        lambda: regionprops.measure_compacted(comp.seg, comp.idx, roots, well, 1024, 2048),
        lambda: regionprops.measure_compacted(comp.seg, comp.idx, roots, well.float(), 1024, 2048),
        lambda: regionprops.measure_labels(lbl, cells),
        lambda: regionprops.measure_intensity_stack(lbl, well[0], cells),
    ]
    for fn in runs:
        first, second = fn(), fn()
        if isinstance(first, tuple):
            assert _equal(first[0], second[0]) and _equal(first[1], second[1])
        else:
            assert _equal(first, second)
