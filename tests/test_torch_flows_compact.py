"""PyTorch port: mask reconstruction in the compact domain against the JAX
package.

Each stage of the compact route - the active-pixel list and its capacity
flag, the doubling inside the list, the sink clustering, the compact tail
with and without the QC and the border filter, and the whole
`compute_masks_sparse_compact` - is fed the same numpy inputs (made from
seeds) as the JAX function and must give the same integers, bit for bit.
The sub-pixel `follow_flows` copies `map_coordinates`' arithmetic; XLA may
contract its products and sums into fused multiply-adds, so its positions
are held within 1e-3 pixel after 60 steps, and the masks built from one set
of positions must be equal. Every size is at most 2^20 pixels, below the
reference's 2^25-pixel limit (its two-stage segment key overflows int32
above that).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu.models import flows as jflows
from arcadia_microscopy_tools_tpu.models.synthetic import synthesize_cells
from arcadia_microscopy_tools_tpu.ops.labeling import clear_border as jclear_border
from arcadia_microscopy_tools_tpu_torch.models import flows

# one torch thread per test worker process (the suite runs several at once)
torch.set_num_threads(1)

CAP = 8192


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _net_out_from_labels(lbl: np.ndarray, noise: float = 0.0, seed: int = 0) -> np.ndarray:
    """(H, W, 3) network-style output from the label image's own flows (the
    JAX `masks_to_flows`), optionally with Gaussian noise: dY, dX scaled by
    5 and cell-probability logits +-4."""
    f, fg = jflows.masks_to_flows(jnp.asarray(lbl), 64)
    f = np.asarray(f)
    prob = np.where(np.asarray(fg), 4.0, -4.0)
    if noise:
        rng = np.random.default_rng(seed)
        f = f + rng.normal(0, noise, f.shape).astype(np.float32)
        prob = prob + rng.normal(0, 1, prob.shape)
    return np.concatenate([5.0 * f, prob[..., None]], -1).astype(np.float32)


def _cells(seed: int, size: int = 96, n_cells: int = 6) -> np.ndarray:
    return synthesize_cells(np.random.default_rng(seed), (size, size), n_cells=n_cells)[1]


def _scene(seeds, size=96, n_cells=6, noise=0.3) -> np.ndarray:
    """(B, H, W, 3) noisy network outputs of synthetic cells, pixel 0
    inactive (see test_reference_pixel_zero_with_padding_slots)."""
    out = np.stack([_net_out_from_labels(_cells(s, size, n_cells), noise, 100 + s) for s in seeds])
    out[:, 0, 0, 2] = -4.0
    return out


def _flows_active(out: np.ndarray):
    return out[..., :2] * np.float32(0.2), out[..., 2] > 0


def _border_cells(size: int, centers, radius2: int) -> np.ndarray:
    lbl = np.zeros((size, size), np.int32)
    yy, xx = np.mgrid[0:size, 0:size]
    for k, (cy, cx) in enumerate(centers, start=1):
        m = (yy - cy) ** 2 + (xx - cx) ** 2 < radius2
        lbl[m & (lbl == 0)] = k
    return lbl


def _assert_compact_equal(got: flows.CompactMasks, k: int, want) -> None:
    for name in ("labels", "lab_c", "idx", "valid", "ok"):
        np.testing.assert_array_equal(
            getattr(got, name)[k].numpy(), np.asarray(getattr(want, name)), err_msg=name
        )


class TestCompaction:
    @pytest.mark.parametrize("cap", [64, 3000, CAP, 96 * 96 + 100])
    def test_list_landings_and_ok_equal_jax(self, cap):
        """Caps below the count (ok False), at a fraction of the image, and
        above the image (padding slots)."""
        out = _scene([0, 1])
        fl, act = _flows_active(out)
        idx, valid, landing, ok = flows._follow_sparse_core(_t(fl), _t(act), 200, cap)
        for k in range(2):
            w = jflows._follow_sparse_core(jnp.asarray(fl[k]), jnp.asarray(act[k]), 200, cap)
            np.testing.assert_array_equal(idx[k].numpy(), np.asarray(w[0]))
            np.testing.assert_array_equal(valid[k].numpy(), np.asarray(w[1]))
            assert bool(ok[k]) == bool(w[3])
            if bool(w[3]):  # the landings of an overflowing list are discarded
                np.testing.assert_array_equal(landing[k].numpy(), np.asarray(w[2]))

    @pytest.mark.parametrize("stride, want_ok", [(16, False), (1, True), (3, True)])
    def test_segment_budget_at_two_to_the_twenty(self, stride, want_ok):
        """At 2^20 pixels the reference compacts by 8-pixel segments and
        keeps at most cap // 4 of them: 2000 active pixels, each in a
        segment of its own (stride 16), fit a cap of 4096 but not its 1024
        segments, so ok is False in both packages; packed pixels pass and
        give the same list."""
        size, cap = 1024, 4096
        act = np.zeros(size * size, bool)
        act[np.arange(2000) * stride + 5] = True
        act = act.reshape(size, size)
        fl = np.zeros((size, size, 2), np.float32)
        idx, valid, _, ok = flows._follow_sparse_core(_t(fl[None]), _t(act[None]), 200, cap)
        w = jflows._follow_sparse_core(jnp.asarray(fl), jnp.asarray(act), 200, cap)
        assert bool(ok[0]) == bool(w[3]) == want_ok
        assert int(act.sum()) <= cap
        if want_ok:
            np.testing.assert_array_equal(idx[0].numpy(), np.asarray(w[0]))
            np.testing.assert_array_equal(valid[0].numpy(), np.asarray(w[1]))

    def test_reference_pixel_zero_with_padding_slots(self):
        """A reference fault: its padding slots (index n) scatter into pixel 0
        (`.at[idx_safe].set` with idx_safe = 0), so when pixel 0 is active,
        not a sink, and the list has padding, pixels flowing through it stop
        at 0. The port follows the dense route there."""
        fl = np.zeros((1, 4, 4, 2), np.float32)
        act = np.zeros((1, 4, 4), bool)
        act[0, 0, 0] = act[0, 0, 1] = act[0, 1, 0] = True
        fl[0, 0, 0] = (0, 1)  # 0 -> 1, a sink
        fl[0, 1, 0] = (-1, 0)  # 4 -> 0
        dense = flows.follow_flows_indices(_t(fl), _t(act))
        sparse, ok = flows.follow_flows_indices_sparse(_t(fl), _t(act), cap=8)
        assert bool(ok[0])
        np.testing.assert_array_equal(sparse.numpy(), dense.numpy())
        want_dense = np.asarray(jflows.follow_flows_indices(jnp.asarray(fl[0]), jnp.asarray(act[0])))
        np.testing.assert_array_equal(dense[0].numpy(), want_dense)
        ref_sparse, _ = jflows.follow_flows_indices_sparse(
            jnp.asarray(fl[0]), jnp.asarray(act[0]), cap=8
        )
        assert np.asarray(ref_sparse)[1, 0] == 0 and dense[0, 1, 0] == 1


class TestSparseFlowIntegration:
    """Twins of the JAX package's tests/test_models.py TestSparseFlowIntegration,
    each also held against the JAX function."""

    def test_sparse_equals_dense_landing(self):
        out = _scene([2, 3], noise=0.0)
        fl, act = _flows_active(out)
        dense = flows.follow_flows_indices(_t(fl), _t(act), niter=200)
        sparse, ok = flows.follow_flows_indices_sparse(_t(fl), _t(act), niter=200, cap=CAP)
        assert ok.all()
        np.testing.assert_array_equal(dense.numpy(), sparse.numpy())
        for k in range(2):
            want, _ = jflows.follow_flows_indices_sparse(
                jnp.asarray(fl[k]), jnp.asarray(act[k]), niter=200, cap=CAP
            )
            np.testing.assert_array_equal(sparse[k].numpy(), np.asarray(want))

    def test_overflow_flag(self):
        fl, act = _flows_active(_scene([2]))
        _, ok = flows.follow_flows_indices_sparse(_t(fl), _t(act), niter=200, cap=64)
        assert not ok.any()

    @pytest.mark.parametrize("flow_threshold", [0.0, 0.4])
    def test_compute_masks_sparse_equals_dense(self, flow_threshold):
        """With the QC, one cell's flows reversed so that its flow error trips
        it; the compact renumbering must equal the dense relabel."""
        lbl = _cells(4)
        out = _net_out_from_labels(lbl)
        out[..., :2] = np.where((lbl == 2)[..., None], -out[..., :2], out[..., :2])
        dense = flows.compute_masks(_t(out[None]), flow_threshold=flow_threshold)
        sparse, ok = flows.compute_masks_sparse(_t(out[None]), CAP, flow_threshold=flow_threshold)
        assert ok.all()
        np.testing.assert_array_equal(dense.numpy(), sparse.numpy())
        want, _ = jflows.compute_masks_sparse(jnp.asarray(out), CAP, flow_threshold=flow_threshold)
        np.testing.assert_array_equal(sparse[0].numpy(), np.asarray(want))
        if flow_threshold == 0:
            assert int(dense.max()) == lbl.max()
        else:
            assert 0 < int(dense.max()) < lbl.max()

    def test_compute_masks_sparse_equals_dense_border_cells(self):
        """Sinks on every border and corner: the cluster order key clamps at
        row and column 0."""
        lbl = _border_cells(80, [(0, 0), (0, 40), (0, 79), (40, 0), (79, 20), (79, 79), (38, 41)], 81)
        out = _net_out_from_labels(lbl)
        dense = flows.compute_masks(_t(out[None]), flow_threshold=0.0)
        sparse, ok = flows.compute_masks_sparse(_t(out[None]), CAP, flow_threshold=0.0)
        assert ok.all()
        np.testing.assert_array_equal(dense.numpy(), sparse.numpy())
        want, _ = jflows.compute_masks_sparse(jnp.asarray(out), CAP, flow_threshold=0.0)
        np.testing.assert_array_equal(sparse[0].numpy(), np.asarray(want))

    def test_compute_masks_sparse_min_size_filter_matches(self):
        lbl = _cells(5, n_cells=8)
        out = _net_out_from_labels(lbl)
        min_size = int(np.median(np.bincount(lbl.ravel())[1:]))
        dense = flows.compute_masks(_t(out[None]), flow_threshold=0.0, min_size=min_size)
        sparse, ok = flows.compute_masks_sparse(
            _t(out[None]), CAP, flow_threshold=0.0, min_size=min_size
        )
        assert ok.all()
        np.testing.assert_array_equal(dense.numpy(), sparse.numpy())
        assert 0 < int(dense.max()) < lbl.max()
        want, _ = jflows.compute_masks_sparse(
            jnp.asarray(out), CAP, flow_threshold=0.0, min_size=min_size
        )
        np.testing.assert_array_equal(sparse[0].numpy(), np.asarray(want))

    def test_compute_masks_sparse_sink_overflow_flag(self):
        lbl = _cells(6, n_cells=8)
        fl, act = _flows_active(_net_out_from_labels(lbl)[None])
        idx, valid, landing, ok = flows._follow_sparse_core(_t(fl), _t(act), 200, CAP)
        assert ok.all()
        _, _, overflow = flows._finish_masks_compact(
            idx, valid, landing, _t(fl), 96, 96, 0.0, 64, 0, sink_cap=2
        )
        w = jflows._follow_sparse_core(jnp.asarray(fl[0]), jnp.asarray(act[0]), 200, CAP)
        _, _, want = jflows._finish_masks_compact(*w[:3], jnp.asarray(fl[0]), 96, 96, 0.0, 64, 0,
                                                  sink_cap=2)
        assert bool(overflow[0]) and bool(want)

    def test_compute_masks_sparse_compact_clear_border(self):
        """The border filter equals `clear_border` of the plain labels (cells
        dropped, numbers kept), and lab_c agrees with the image."""
        lbl = _border_cells(96, [(0, 30), (50, 0), (95, 60), (30, 95), (40, 45), (70, 30)], 100)
        out = _net_out_from_labels(lbl)
        plain, ok = flows.compute_masks_sparse(_t(out[None]), CAP, flow_threshold=0.0)
        assert ok.all()
        cm = flows.compute_masks_sparse_compact(
            _t(out[None]), CAP, flow_threshold=0.0, clear_border_labels=True
        )
        assert cm.ok.all()
        got = cm.labels[0].numpy()
        np.testing.assert_array_equal(np.asarray(jclear_border(jnp.asarray(plain[0].numpy()))), got)
        assert 0 < got.max() < int(plain.max())
        idx, valid, lab_c = cm.idx[0].numpy(), cm.valid[0].numpy(), cm.lab_c[0].numpy()
        np.testing.assert_array_equal(got.ravel()[idx[valid]], lab_c[valid])


class TestCompactStagesBitExact:
    def test_cluster_landings(self):
        """Fed the reference's list and landings: labels per listed pixel."""
        out = _scene([7, 8], n_cells=8)
        fl, act = _flows_active(out)
        for k in range(2):
            idx, valid, landing, _ = jflows._follow_sparse_core(
                jnp.asarray(fl[k]), jnp.asarray(act[k]), 200, CAP
            )
            want, want_ovf = jflows._cluster_landings_compact(idx, valid, landing, 96, 96, 3, 1024)
            got, ovf = flows._cluster_landings_compact(
                _t(np.asarray(idx, np.int64)[None]), _t(np.asarray(valid)[None]),
                _t(np.asarray(landing, np.int64)[None]), 96, 96, 3, 1024,
            )
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
            assert bool(ovf[0]) == bool(want_ovf)

    def test_union_find_on_a_long_chain_of_sinks(self):
        """Sinks 3 pixels apart along a snake: one cluster whose union-find
        needs many rounds (more than one host check), numbered as the
        reference numbers it, beside separate clusters."""
        h = w = 64
        sinks = [(r, c) for r in range(2, 62, 12) for c in range(2, 62, 3)]
        sinks += [(r, 62 if (r // 12) % 2 == 0 else 2) for r in range(5, 62, 3) if (r - 2) % 12]
        sinks += [(60, 60), (61, 40)]
        pos = sorted({y * w + x for y, x in sinks})
        # three arrivals per sink, padded list of 4096 slots
        landing = np.repeat(np.array(pos, np.int64), 3)
        idx = np.sort(np.random.default_rng(0).choice(h * w, len(landing), replace=False))
        cap = 4096
        pad = cap - len(idx)
        idx_p = np.concatenate([idx, np.full(pad, h * w)])
        valid = idx_p < h * w
        land_p = np.concatenate([landing, np.zeros(pad, np.int64)])
        want, _ = jflows._cluster_landings_compact(
            jnp.asarray(idx_p, jnp.int32), jnp.asarray(valid), jnp.asarray(land_p, jnp.int32),
            h, w, 3, 1024,
        )
        got, _ = flows._cluster_landings_compact(
            _t(idx_p[None]), _t(valid[None]), _t(land_p[None]), h, w, 3, 1024
        )
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
        assert 1 < int(got.max()) < 10

    @pytest.mark.parametrize(
        "kwargs",
        [
            dict(flow_threshold=0.0, min_size=0),
            dict(flow_threshold=0.4, min_size=15),
            dict(flow_threshold=0.4, min_size=15, clear_border_labels=True),
            dict(flow_threshold=0.0, min_size=15, clear_border_labels=True, max_cells=4),
        ],
    )
    def test_finish_masks_compact(self, kwargs):
        """Fed the reference's list and landings; `max_cells` 4 makes labels
        above it share the QC's last segment."""
        out = _scene([9, 10], n_cells=8, noise=0.4)
        fl, act = _flows_active(out)
        kwargs = {"max_cells": 64, **kwargs}
        for k in range(2):
            core = jflows._follow_sparse_core(jnp.asarray(fl[k]), jnp.asarray(act[k]), 200, CAP)
            want = jflows._finish_masks_compact(
                *core[:3], jnp.asarray(fl[k]), 96, 96, kwargs["flow_threshold"],
                kwargs["max_cells"], kwargs["min_size"],
                clear_border_labels=kwargs.get("clear_border_labels", False), allow_pallas=False,
            )
            idx, valid, landing = (_t(np.asarray(a).astype(np.int64 if a.dtype != bool else bool)[None])
                                   for a in core[:3])
            got = flows._finish_masks_compact(
                idx, valid, landing, _t(fl[k : k + 1]), 96, 96, kwargs["flow_threshold"],
                kwargs["max_cells"], kwargs["min_size"],
                clear_border_labels=kwargs.get("clear_border_labels", False),
            )
            for g, w_, name in zip(got, want, ("labels", "lab_c", "overflow")):
                np.testing.assert_array_equal(g[0].numpy(), np.asarray(w_), err_msg=name)

    def test_flow_error_compact(self):
        """Per-label errors on the listed pixels: float64 sums against the
        reference's float32 sums, within 1e-4 relative (as the dense QC)."""
        out = _scene([11], n_cells=8, noise=0.5)
        fl, act = _flows_active(out)
        idx, valid, landing, _ = flows._follow_sparse_core(_t(fl), _t(act), 200, CAP)
        labels, lab_c, _ = flows._finish_masks_compact(idx, valid, landing, _t(fl), 96, 96, 0.0,
                                                       64, 15)
        got = flows._flow_error_compact(idx, valid, lab_c, labels, _t(fl), 32)
        want = jflows._flow_error_compact(
            jnp.asarray(idx[0].numpy(), jnp.int32), jnp.asarray(valid[0].numpy()),
            jnp.asarray(lab_c[0].numpy()), jnp.asarray(labels[0].numpy()), jnp.asarray(fl[0]), 32,
        )
        assert int(labels.max()) > 2
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-4, atol=1e-7)

    @pytest.mark.parametrize(
        "kwargs",
        [
            dict(flow_threshold=0.0),
            dict(flow_threshold=0.4),
            dict(flow_threshold=0.4, clear_border_labels=True),
            dict(flow_threshold=0.0, min_size=40),
            dict(flow_threshold=0.4, cellprob_threshold=1.0, niter=50),
        ],
    )
    def test_compute_masks_sparse_compact(self, kwargs):
        out = _scene([12, 13, 14])
        got = flows.compute_masks_sparse_compact(_t(out), CAP, max_cells=64, **kwargs)
        for k in range(3):
            want = jflows.compute_masks_sparse_compact(jnp.asarray(out[k]), CAP, max_cells=64,
                                                       **kwargs)
            _assert_compact_equal(got, k, want)
        assert int(got.labels.max()) > 0

    def test_sink_overflow_clears_ok(self):
        out = _scene([15])
        got = flows.compute_masks_sparse_compact(_t(out), CAP, max_cells=1)
        want = jflows.compute_masks_sparse_compact(jnp.asarray(out[0]), CAP, max_cells=1)
        assert bool(want.ok) == bool(got.ok[0])


class TestComputeMasksSparseCap:
    def test_sparse_cap_equals_dense_for_a_mixed_batch(self):
        """The image whose foreground fits the cap takes the compact
        integration, the other the dense one; both equal the JAX
        `compute_masks(..., sparse_cap=...)`."""
        out = _scene([16, 17], n_cells=8)
        counts = (out[..., 2] > 0).sum((1, 2))
        cap = int(counts.min())
        assert counts.max() > cap
        got = flows.compute_masks(_t(out), max_cells=64, sparse_cap=cap)
        np.testing.assert_array_equal(got.numpy(), flows.compute_masks(_t(out), max_cells=64).numpy())
        for k in range(2):
            want = jflows.compute_masks(jnp.asarray(out[k]), max_cells=64, sparse_cap=cap)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))


class TestSubpixelFlows:
    def test_follow_flows_converges_to_center(self):
        h = w = 32
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        fl = np.stack([np.clip(15.5 - yy, -1, 1), np.clip(15.5 - xx, -1, 1)], -1)
        final = flows.follow_flows(_t(fl[None]), torch.ones(1, h, w, dtype=torch.bool), niter=60)
        np.testing.assert_allclose(final[0, ..., 0].numpy(), 15.5, atol=0.6)
        np.testing.assert_allclose(final[0, ..., 1].numpy(), 15.5, atol=0.6)

    def test_follow_flows_and_masks_from_flows_match_jax(self):
        out = _scene([18, 19], size=64, n_cells=5)
        fl, act = _flows_active(out)
        got = flows.follow_flows(_t(fl), _t(act), niter=60)
        for k in range(2):
            want = np.asarray(jflows.follow_flows(jnp.asarray(fl[k]), jnp.asarray(act[k]), niter=60))
            np.testing.assert_allclose(got[k].numpy(), want, rtol=0, atol=1e-3)
            assert (got[k].numpy()[~act[k]] == np.stack(np.mgrid[0:64, 0:64], -1)[~act[k]]).all()
            masks = flows.masks_from_flows(_t(want[None]), _t(act[k : k + 1]))
            want_m = jflows.masks_from_flows(jnp.asarray(want), jnp.asarray(act[k]))
            np.testing.assert_array_equal(masks[0].numpy(), np.asarray(want_m))
            assert int(masks.max()) > 0
