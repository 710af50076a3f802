"""PyTorch port: `PlateRunner.run` stages each batch of wells into a ring of
reused host buffers on its prefetch workers (page-locked on a CUDA card) and
uploads it from there. The tables must not change: not when batches outnumber
the ring's slots, not with more prefetch workers than slots, not where a batch
falls back to stacking on the main thread (mixed shapes, capacity retries),
and not when a well fails to load.

This file imports neither JAX nor the JAX package; its one gpu-marked test
runs on the card and skips without one."""

from __future__ import annotations

import dataclasses
import sys
import threading

import pandas as pd
import pytest
import torch

from arcadia_microscopy_tools_tpu_torch import MicroplateLayout, SegmentationWarning
from arcadia_microscopy_tools_tpu_torch.core.microplate import Well
from arcadia_microscopy_tools_tpu_torch.parallel import plate
from arcadia_microscopy_tools_tpu_torch.testing import synthetic_wells

# one torch thread per test worker process (the suite runs several at once)
torch.set_num_threads(1)

CONFIG = plate.PlateRunConfig(max_cells=64, min_size=15, batch_size=2)
IDS = [f"A{i:02d}" for i in range(1, 10)]  # 5 batches of 2: more than the ring's slots


@pytest.fixture(scope="module")
def wells():
    """Nine distinct wells, so a slot refilled too early shows in a table."""
    return dict(zip(IDS, synthetic_wells(len(IDS), 2, 96, 96, 6, seed=11)))


def _layout(ids):
    return MicroplateLayout([Well(id=w) for w in ids])


def _assert_same_tables(ours, ref):
    assert ours.keys() == ref.keys()
    for well_id, table in ref.items():
        if table is None:
            assert ours[well_id] is None, well_id
        else:
            pd.testing.assert_frame_equal(ours[well_id], table, check_exact=True)


@pytest.mark.parametrize(
    "prefetch, method, max_inflight",
    [(2, "classical", 4), (2, "unet", 4), (None, "classical", 4), (None, "unet", 4),
     (2, "classical", 1)],
    ids=["2-classical", "2-unet", "None-classical", "None-unet", "2-classical-inflight1"],
)
def test_staged_tables_equal_the_serial_run(wells, method, prefetch, max_inflight):
    """Every batch comes from a slot its worker filled, and the tables equal
    a run whose main thread loads and stages each batch in turn; with
    `max_inflight=1` each batch is drained as soon as the next is
    dispatched."""
    config = dataclasses.replace(CONFIG, method=method, niter=20)
    serial = plate.PlateRunner(config, device="cpu").run(_layout(IDS), wells, prefetch=0)
    results = plate.PlateRunner(config, device="cpu").run(_layout(IDS), wells,
                                                          prefetch=prefetch,
                                                          max_inflight=max_inflight)
    assert results.failed_wells == []
    _assert_same_tables(results.tables, serial.tables)
    for res in (serial, results):
        assert res.timings["batches"] == res.timings["pinned_batches"] == 5
        assert res.timings["fill_s"] > 0


def test_more_prefetch_than_slots_completes(wells):
    """16 prefetch workers on 9 one-well batches, with the interpreter
    switching threads every microsecond: the run ends, and every batch took
    its slot in turn."""
    config = dataclasses.replace(CONFIG, batch_size=1)
    runner = plate.PlateRunner(config, device="cpu")
    out = {}
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        worker = threading.Thread(
            target=lambda: out.setdefault("res", runner.run(_layout(IDS), wells, prefetch=16)),
            daemon=True)
        worker.start()
        worker.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not worker.is_alive(), "the run did not finish: a worker never got its slot"
    res = out["res"]
    assert res.failed_wells == []
    assert res.timings["batches"] == res.timings["pinned_batches"] == len(IDS)
    serial = plate.PlateRunner(config, device="cpu").run(_layout(IDS), wells, prefetch=0)
    _assert_same_tables(res.tables, serial.tables)


def test_mixed_shapes_fall_back_to_stacking(wells):
    """A batch of two shapes is dispatched per shape from stacked copies; the
    tables equal those of the same wells staged in slots."""
    small = {w: img[:, :80] for w, img in wells.items()}
    source = {"A01": wells["A01"], "A02": small["A02"], "A03": wells["A03"],
              "A04": wells["A04"]}
    results = plate.PlateRunner(CONFIG, device="cpu").run(_layout(list(source)), source)
    # batch 0 splits into two stacked dispatches; batch 1 takes its slot
    assert results.timings["batches"] == 3 and results.timings["pinned_batches"] == 1
    whole = plate.PlateRunner(CONFIG, device="cpu").run(_layout(IDS), wells)
    alone = plate.PlateRunner(CONFIG, device="cpu").run(_layout(["A02"]), small)
    assert alone.timings["pinned_batches"] == 1
    for well_id in ("A01", "A03", "A04"):
        pd.testing.assert_frame_equal(results.tables[well_id], whole.tables[well_id],
                                      check_exact=True)
    pd.testing.assert_frame_equal(results.tables["A02"], alone.tables["A02"], check_exact=True)


def test_capacity_retry_falls_back_to_stacking(wells):
    """A well over its capacities is re-dispatched at 4x from a stacked copy
    and gives the table of a run with room to spare."""
    tight = dataclasses.replace(CONFIG, max_cells=2)
    results = plate.PlateRunner(tight, device="cpu").run(_layout(["A01"]), wells)
    assert results.failed_wells == [] and results.timings["capacity_retries"] >= 1
    assert results.timings["pinned_batches"] == 1 < results.timings["batches"]
    reference = plate.PlateRunner(CONFIG, device="cpu").run(_layout(["A01"]), wells)
    pd.testing.assert_frame_equal(results.tables["A01"], reference.tables["A01"],
                                  check_exact=True)


def test_load_failure_stays_isolated(wells):
    """A well that fails to load leaves its batchmate staged alone in the
    slot, and every other table unchanged."""

    def source(well_id):
        if well_id == "A04":
            raise OSError("corrupt file")
        return wells[well_id]

    with pytest.warns(SegmentationWarning, match="corrupt file"):
        results = plate.PlateRunner(CONFIG, device="cpu").run(_layout(IDS), source, prefetch=4)
    assert results.failed_wells == ["A04"]
    assert results.timings["batches"] == results.timings["pinned_batches"] == 5
    serial = plate.PlateRunner(CONFIG, device="cpu").run(_layout(IDS), wells, prefetch=0)
    _assert_same_tables({w: t for w, t in results.tables.items() if w != "A04"},
                        {w: t for w, t in serial.tables.items() if w != "A04"})


def test_second_run_reuses_the_ring(wells):
    """The ring outlives a run: a second run of the same shape stages into the
    same buffers, and only a new shape replaces it."""
    runner = plate.PlateRunner(CONFIG, device="cpu")
    runner.run(_layout(IDS), wells)
    ring = runner._staging
    assert len(ring.slots) == plate.STAGING_SLOTS
    assert ring.shape == (2, 2, 96, 96)
    pointers = [s.data_ptr() for s in ring.slots]
    runner.run(_layout(IDS[:4]), wells)
    assert runner._staging is ring and [s.data_ptr() for s in ring.slots] == pointers
    small = {w: img[:, :80] for w, img in wells.items()}
    runner.run(_layout(IDS[:2]), small)
    assert runner._staging is not ring and runner._staging.shape == (2, 2, 80, 96)


@pytest.mark.gpu
def test_pinned_ring_on_the_card(wells):
    """On a CUDA card the slots are page-locked, the ring holds at most
    `STAGING_SLOTS` batches, and a 3-batch plate gives the serial run's
    tables bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ids = IDS[:6]
    serial = plate.PlateRunner(CONFIG, device="cuda").run(_layout(ids), wells, prefetch=0)
    runner = plate.PlateRunner(CONFIG, device="cuda")
    results = runner.run(_layout(ids), wells)
    assert results.failed_wells == []
    assert results.timings["batches"] == results.timings["pinned_batches"] == 3
    _assert_same_tables(results.tables, serial.tables)
    ring = runner._staging
    assert all(s.is_pinned() for s in ring.slots)
    assert len(ring.slots) <= plate.STAGING_SLOTS
    assert all(s.shape[0] == CONFIG.batch_size for s in ring.slots)
