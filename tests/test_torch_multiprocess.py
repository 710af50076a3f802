"""PyTorch port: multi-process plate execution (parallel/multiprocess.py).

The twin of tests/test_multiprocess.py: two spawned processes form a gloo
group through `initialize_distributed` and run `run_plate_multiprocess` on
12 wells with device="cpu" (tests/torch_mesh_ranks.py): a batch of 8 and a
tail of 4, one well that fails to decode, and wells with more cells than
`max_cells`, which escalate. Each rank must return the single process's
tables bit for bit. The JAX package's runner holds the tables within
test_torch_plate's tolerances. JAX marks its own two-process test slow; this
one runs in a few seconds.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu.core.microplate import MicroplateLayout as JaxLayout
from arcadia_microscopy_tools_tpu.core.microplate import Well as JaxWell
from arcadia_microscopy_tools_tpu.parallel import plate as jax_plate
from arcadia_microscopy_tools_tpu_torch.core.microplate import MicroplateLayout, Well
from arcadia_microscopy_tools_tpu_torch.parallel import plate
from arcadia_microscopy_tools_tpu_torch.parallel.multiprocess import (
    initialize_distributed,
    run_plate_multiprocess,
)
from test_torch_measure import ATOL, RTOL
from test_torch_parallel import blob_wells
from torch_mesh_ranks import MULTIPROCESS_CONFIG, run_ranks

torch.set_num_threads(1)

CELLS = [4, 5, 6, 7, 8, 5, 6, 9, 4, 7, 6, 5]  # max_cells 6: wells of 7-9 cells escalate
BAD = "C06"
IDS = [f"C{k + 1:02d}" for k in range(len(CELLS))]


@pytest.fixture(scope="module")
def wells():
    # a seed on whose wells the two packages' masks agree pixel for pixel
    # (the reference's float32 DoG and Otsu move a boundary pixel on some
    # wells; see test_torch_filters_fused), so JAX's tables can be held here
    return blob_wells(len(CELLS), 64, 64, CELLS, seed=1)


@pytest.fixture(scope="module")
def ranks(wells, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multiprocess")
    np.savez(tmp / "inputs.npz", wells=wells, bad=np.array(BAD))
    return run_ranks("multiprocess_plate", 2, tmp)


def _source(wells):
    def source(well_id):
        if well_id == BAD:
            raise OSError("corrupt file")
        return wells[IDS.index(well_id)]

    return source


@pytest.fixture(scope="module")
def single(wells):
    with pytest.warns(plate.SegmentationWarning, match="corrupt file"):
        return plate.PlateRunner(plate.PlateRunConfig(**MULTIPROCESS_CONFIG), device="cpu").run(
            MicroplateLayout([Well(id=i) for i in IDS]), _source(wells))


def test_two_process_plate_bit_identical(ranks, single):
    """Every rank returns the single process's tables bit for bit."""
    for r in ranks:
        assert set(r["tables"]) == set(single.tables)
        for w, table in single.tables.items():
            if table is None:
                assert r["tables"][w] is None
            else:
                assert r["tables"][w].equals(table), w


def test_a_failed_well_stays_isolated(ranks, single):
    assert single.failed_wells == [BAD]
    for r in ranks:
        assert r["failed"] == [BAD]
    # the rank that decoded it warned
    warned = [any("corrupt file" in m for m in r["warnings"]) for r in ranks]
    assert warned.count(True) == 1


def test_dense_wells_escalate(ranks, single):
    dense = [w for w, n in zip(IDS, CELLS) if n > MULTIPROCESS_CONFIG["max_cells"] and w != BAD]
    assert dense
    assert single.timings["capacity_retries"] == len(dense)
    assert sum(r["timings"]["capacity_retries"] for r in ranks) == 2 * len(dense)
    for r in ranks:
        for w in dense:
            assert len(r["tables"][w]) == CELLS[IDS.index(w)], w


def test_each_rank_decodes_its_block_of_each_batch(ranks):
    """Batches of 8 and a tail of 4: rank 0 decodes wells 1-4 and 9-10,
    rank 1 wells 5-8 and 11-12."""
    assert sorted(ranks[0]["decoded"]) == IDS[0:4] + IDS[8:10]
    assert sorted(ranks[1]["decoded"]) == IDS[4:8] + IDS[10:12]
    assert [r["timings"]["decode_wells"] for r in ranks] == [6.0, 6.0]


def test_tables_match_jax(wells, single):
    jax_config = jax_plate.PlateRunConfig(**MULTIPROCESS_CONFIG)
    with pytest.warns(Warning, match="corrupt file"):
        theirs = jax_plate.PlateRunner(jax_config).run(
            JaxLayout([JaxWell(id=i) for i in IDS]), _source(wells))
    assert theirs.failed_wells == single.failed_wells
    for w in IDS:
        if w == BAD:
            continue
        a, b = single.tables[w], theirs.tables[w]
        assert list(a.columns) == list(b.columns) and len(a) == len(b) == CELLS[IDS.index(w)]
        # orientation's moment ties are held in test_torch_plate
        for col in a.columns:
            if col != "orientation":
                np.testing.assert_allclose(a[col], b[col], rtol=RTOL, atol=ATOL, err_msg=col)


def test_initialize_rejects_reuse_once_a_group_is_up(ranks):
    for r in ranks:
        assert r["reinit"].startswith("RuntimeError") and "already" in r["reinit"]


def test_initialize_refuses_nccl_on_shared_cards():
    """NCCL needs a card per rank; the check runs before any group starts."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="card per rank"):
        initialize_distributed("localhost:1", cards + 1, 0, backend="nccl")


def test_run_plate_multiprocess_needs_a_group(wells):
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        run_plate_multiprocess(MicroplateLayout([Well(id="C01")]), {"C01": wells[0]},
                               device="cpu")
