"""PyTorch port: the plate well program and PlateRunner against the JAX
package, plus the runner's host-side contract (failure isolation, capacity
escalation, checkpoint resume, device choice)."""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from arcadia_microscopy_tools_tpu.core.microplate import MicroplateLayout as JaxLayout
from arcadia_microscopy_tools_tpu.core.microplate import Well as JaxWell
from arcadia_microscopy_tools_tpu.parallel import plate as jax_plate
from arcadia_microscopy_tools_tpu_torch import MicroplateLayout, SegmentationWarning
from arcadia_microscopy_tools_tpu_torch.core.microplate import Well
from arcadia_microscopy_tools_tpu_torch.ops.fused import fused_classical_mask
from arcadia_microscopy_tools_tpu_torch.ops.labeling import component_roots
from arcadia_microscopy_tools_tpu_torch.parallel import plate
from arcadia_microscopy_tools_tpu_torch.testing import synthetic_wells
from test_torch_measure import ATOL, RTOL, _exact_moment_ties

# the suite runs in several worker processes at once; one torch thread per
# process keeps them from oversubscribing the host's cores
torch.set_num_threads(1)

CONFIG = plate.PlateRunConfig(max_cells=64, min_size=20)
# wells whose reference float32 Otsu finds the exact bin (see
# test_torch_filters_fused), so both masks, and every integer column, agree
WELL_SEED = 3

INTEGER_COLUMNS = [
    "label", "valid", "area", "bbox_min_row", "bbox_min_col", "bbox_max_row", "bbox_max_col",
]


@pytest.fixture(scope="module")
def wells():
    return synthetic_wells(2, 2, 256, 384, 12, seed=WELL_SEED)


def _layout(ids, cls=MicroplateLayout, well=Well):
    return cls([well(id=i) for i in ids])


def _orientation_check(ours, ref, ecc, tie):
    """Orientation is an axis angle, ill-conditioned for near-round cells
    and jumping between +-pi/4 on exact moment ties (see
    test_torch_measure): held modulo pi where eccentricity > 0.3, no tie."""
    d = np.abs(ours - ref)
    d = np.minimum(d, np.pi - d)
    held = (ecc > 0.3) & ~tie
    assert (d[held] <= 1e-4).all()


def _ties(wells_np):
    """Exact moment ties per cell slot of each well, from the port's own
    labels."""
    mask = fused_classical_mask(torch.from_numpy(wells_np[:, 0]))
    roots, _ = component_roots(mask, pair_cap=CONFIG.pair_cap)
    return [_exact_moment_ties(r.numpy(), CONFIG.max_cells) for r in roots]


def _assert_programs_agree(wells, config, ties):
    """Health equal, integer columns exact, float columns within rtol 1e-5 +
    atol 1e-4, orientation as in `_orientation_check`."""
    ours_packed, ours_health = plate._build_well_program(config, 2)(torch.from_numpy(wells))
    jax_config = jax_plate.PlateRunConfig(**dataclasses.asdict(config))
    program = jax.jit(jax.vmap(jax_plate._build_well_program(jax_config, 2)))
    ref_packed, ref_health = (np.asarray(x) for x in program(jnp.asarray(wells)))

    np.testing.assert_array_equal(ours_health.numpy(), ref_health)
    ours_packed = ours_packed.numpy()
    cols = plate._PROP_COLUMNS
    for name in INTEGER_COLUMNS:
        i = cols.index(name)
        np.testing.assert_array_equal(ours_packed[..., i], ref_packed[..., i], err_msg=name)
    ori = cols.index("orientation")
    exact = {cols.index(name) for name in INTEGER_COLUMNS} | {ori}
    float_idx = [i for i in range(ref_packed.shape[-1]) if i not in exact]
    ours_f, ref_f = ours_packed[..., float_idx], ref_packed[..., float_idx]
    finite = np.isfinite(ref_f)
    np.testing.assert_array_equal(np.isfinite(ours_f), finite)
    np.testing.assert_allclose(ours_f[finite], ref_f[finite], rtol=RTOL, atol=ATOL)
    ecc = ref_packed[..., cols.index("eccentricity")]
    for k, tie in enumerate(ties):
        _orientation_check(ours_packed[k, :, ori], ref_packed[k, :, ori], ecc[k], tie)


def test_well_program_matches_jax(wells):
    """2 wells x 2 channels x 256x384 through the fused histogram branch."""
    _assert_programs_agree(wells, CONFIG, _ties(wells))


@pytest.mark.parametrize(
    "kwargs",
    [{"threshold_method": "li"}, {"opening_radius": 2}, {"threshold_method": "yen", "opening_radius": 1}],
)
def test_staged_branch_matches_jax(wells, kwargs):
    """A non-histogram threshold or a binary opening takes the staged branch
    (DoG -> percentile rescale -> uint16 quantisation -> image-level
    threshold -> opening), per well, as the reference's does."""
    config = dataclasses.replace(CONFIG, **kwargs)
    ties = []
    for img in wells[:, 0]:
        seg = plate.to_float(torch.from_numpy(img))
        roots, _ = component_roots(plate._staged_mask(seg, config), pair_cap=config.pair_cap)
        ties.append(_exact_moment_ties(roots.numpy(), config.max_cells))
    _assert_programs_agree(wells, config, ties)


@pytest.mark.parametrize("measure", [None, (1, 0)], ids=["all", "reordered"])
def test_plate_runner_tables_match_jax(wells, measure):
    """The tables of both runners agree, also where `measure_channel_indices`
    picks the channels in another order."""
    config = dataclasses.replace(CONFIG, measure_channel_indices=measure)
    ids = ["A01", "A02"]
    source = {w: wells[k] for k, w in enumerate(ids)}
    ours = plate.PlateRunner(config, device="cpu").run(_layout(ids), source)
    jax_config = jax_plate.PlateRunConfig(**dataclasses.asdict(config))
    ref = jax_plate.PlateRunner(jax_config).run(_layout(ids, JaxLayout, JaxWell), source)
    assert not ours.failed_wells and not ref.failed_wells
    ties = _ties(wells)
    for k, w in enumerate(ids):
        a, b = ours.tables[w], ref.tables[w]
        assert list(a.columns) == list(b.columns)
        assert len(a) == len(b) >= 8
        for col in a.columns:
            if col == "orientation":
                continue
            np.testing.assert_allclose(a[col], b[col], rtol=RTOL, atol=ATOL, err_msg=col)
        # table rows are the valid cells with area >= min_size, in slot order
        packed, _ = plate._build_well_program(config, 2)(torch.from_numpy(wells[k : k + 1]))
        cols = plate._PROP_COLUMNS
        keep = (packed[0, :, cols.index("valid")] > 0.5) & (packed[0, :, cols.index("area")] >= 20)
        _orientation_check(
            a["orientation"].to_numpy(), b["orientation"].to_numpy(),
            b["eccentricity"].to_numpy(), ties[k][keep.numpy()],
        )


def test_loader_failure_is_isolated(wells):
    ids = ["A01", "A02"]

    def source(well_id):
        if well_id == "A02":
            raise OSError("corrupt file")
        return wells[0]

    with pytest.warns(SegmentationWarning, match="corrupt file"):
        results = plate.PlateRunner(CONFIG, device="cpu").run(_layout(ids), source)
    assert results.failed_wells == ["A02"]
    assert results.tables["A01"] is not None and len(results.tables["A01"]) > 0


def test_dense_well_escalates_capacity(wells):
    """12 blobs per well against max_cells=4 and a tiny foreground capacity:
    the well is re-dispatched at 4x, then 16x, and measures every cell."""
    config = plate.PlateRunConfig(max_cells=4, min_size=20, fg_cap_fraction=0.0002)
    results = plate.PlateRunner(config, device="cpu").run(_layout(["A01"]), {"A01": wells[0]})
    assert not results.failed_wells
    reference = plate.PlateRunner(CONFIG, device="cpu").run(_layout(["A01"]), {"A01": wells[0]})
    pd.testing.assert_frame_equal(results.tables["A01"], reference.tables["A01"])


def test_capacity_exhausted_warns():
    """40 blobs exceed max_cells=1 even after the 4x and 16x escalations."""
    dense = synthetic_wells(1, 1, 256, 384, 40, seed=WELL_SEED)[0]
    config = plate.PlateRunConfig(max_cells=1, min_size=20)
    with pytest.warns(SegmentationWarning, match="exceed max_cells"):
        results = plate.PlateRunner(config, device="cpu").run(_layout(["A01"]), {"A01": dense})
    assert results.failed_wells == ["A01"]


def test_resumes_a_checkpoint_written_by_the_jax_runner(wells, tmp_path):
    jax_config = jax_plate.PlateRunConfig(**dataclasses.asdict(CONFIG))
    first = jax_plate.PlateRunner(jax_config, checkpoint_dir=tmp_path).run(
        _layout(["A01"], JaxLayout, JaxWell), {"A01": wells[0]}
    )
    # A01 must come from the checkpoint: the source only holds A02
    results = plate.PlateRunner(CONFIG, checkpoint_dir=tmp_path, device="cpu").run(
        _layout(["A01", "A02"]), {"A02": wells[1]}
    )
    assert not results.failed_wells
    pd.testing.assert_frame_equal(
        results.tables["A01"], pd.read_csv(tmp_path / "A01.csv"), check_dtype=False
    )
    np.testing.assert_allclose(results.tables["A01"]["area"], first.tables["A01"]["area"])
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest == {"A01": "A01.csv", "A02": "A02.csv"}


def test_config_carries_over_from_jax():
    jax_config = jax_plate.PlateRunConfig(max_cells=32, threshold_method="yen", pair_cap=99)
    assert dataclasses.asdict(plate.PlateRunConfig(**dataclasses.asdict(jax_config))) == (
        dataclasses.asdict(jax_config)
    )


def test_default_device_is_cuda_or_raises():
    if torch.cuda.is_available():
        assert plate.PlateRunner().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            plate.PlateRunner()


@pytest.mark.parametrize(
    "kwargs, error",
    [
        ({"method": "unet"}, None),
        ({"threshold_method": "bogus", "opening_radius": 2}, ValueError),
        ({"threshold_method": "Li"}, ValueError),
        ({"threshold_method": "bogus"}, ValueError),
        ({"method": "bogus"}, ValueError),
    ],
)
def test_unported_configurations_raise(kwargs, error):
    """Every method of the reference is ported: method="unet" builds a
    runner with its U-Net (error None); unknown names raise as in the
    reference (threshold names are exact there)."""
    if error is None:
        runner = plate.PlateRunner(plate.PlateRunConfig(**kwargs), device="cpu")
        assert runner.network is not None and runner.network.head.device.type == "cpu"
    else:
        with pytest.raises(error):
            plate.PlateRunner(plate.PlateRunConfig(**kwargs), device="cpu")
    for opening in (0, 2):  # every global threshold runs, with or without an opening
        for method in plate.GLOBAL_METHODS:
            plate.PlateRunner(plate.PlateRunConfig(threshold_method=method, opening_radius=opening),
                              device="cpu")
