"""PyTorch port: the plate runner's "unet" method against the JAX package.

The well program runs the trained U-Net (the JAX package's
`checkpoints/unet`, handed to both runners as one numpy parameter tree)
on synthetic wells. The two bfloat16 forwards round at different points
(the JAX plate program folds the grayscale input into its space-to-depth
stem), so the whole well is held to the tolerance recorded for the
segmentation path: labels equal on >= 99% of pixels and cell counts within
one. The measurement is held on its own, fed the JAX program's own label
image: integer columns equal, float columns within rtol 1e-5 + atol 1e-4,
orientation modulo pi where eccentricity > 0.3 and the moments do not tie.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from arcadia_microscopy_tools_tpu.core.microplate import MicroplateLayout as JaxLayout
from arcadia_microscopy_tools_tpu.core.microplate import Well as JaxWell
from arcadia_microscopy_tools_tpu.models.synthetic import synthesize_cells
from arcadia_microscopy_tools_tpu.models.weights import load_checkpoint
from arcadia_microscopy_tools_tpu.parallel import plate as jax_plate
from arcadia_microscopy_tools_tpu_torch import MicroplateLayout
from arcadia_microscopy_tools_tpu_torch.core.microplate import Well
from arcadia_microscopy_tools_tpu_torch.models.weights import DEFAULT_WEIGHTS, load_weights
from arcadia_microscopy_tools_tpu_torch.parallel import plate
from test_torch_measure import ATOL, RTOL, _exact_moment_ties
from test_torch_plate import INTEGER_COLUMNS, _orientation_check

# one torch thread per test worker process (the suite runs several at once)
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONFIG = plate.PlateRunConfig(
    method="unet", max_cells=64, min_size=15, niter=100, flow_threshold=0.4,
    remove_edge_cells=True,
)


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, load_checkpoint(REPO / "checkpoints" / "unet"))


def _well(size: int, n_cells: int, seed: int) -> np.ndarray:
    """(2, size, size) uint16: synthetic cells and the same at half scale."""
    img, _ = synthesize_cells(np.random.default_rng(seed), (size, size), n_cells=n_cells,
                              separation=0.95)
    u16 = (img * 60000).astype(np.uint16)
    return np.stack([u16, u16 // 2])


def _layout(ids, cls=MicroplateLayout, well=Well):
    return cls([well(id=i) for i in ids])


def _jax_program(params, config=CONFIG):
    jax_config = jax_plate.PlateRunConfig(**dataclasses.asdict(config))
    fn = jax_plate._build_well_program(jax_config, 2, unet_params=params, debug_labels=True)
    return jax.jit(fn)


def _table_given_labels(labels: np.ndarray, well: np.ndarray, max_cells: int) -> np.ndarray:
    """The port's packed columns measured on a given label image."""
    flat = torch.from_numpy(labels.astype(np.int32).reshape(1, -1))
    idx = torch.nonzero(flat[0] > 0)[:, 0][None]
    lab_c = flat[0, idx[0]][None]
    props, stats = plate.measure_unet_masks(
        torch.from_numpy(labels.astype(np.int32)[None]), lab_c, idx, torch.ones_like(idx, dtype=bool),
        torch.from_numpy(well[None].astype(np.float32)), max_cells,
    )
    cols = [props[name][0].float() for name in plate._PROP_COLUMNS]
    cols += [stats[k][s][0].float() for k in range(well.shape[0]) for s in plate._INTENSITY_STATS]
    return torch.stack(cols, -1).numpy()


@pytest.mark.parametrize("size, n_cells, seed", [(256, 10, 0), (100, 3, 1)])
def test_well_matches_jax(params, size, n_cells, seed):
    """A 256^2 well and a 100^2 well, whose side the program edge-pads to a
    multiple of 8 and crops back."""
    well = _well(size, n_cells, seed)
    ref_packed, ref_health, ref_labels = (np.asarray(x) for x in _jax_program(params)(jnp.asarray(well)))
    program = plate._build_well_program(CONFIG, 2, plate.unet_network(params, "cpu"), debug_labels=True)
    packed, health, labels = (x[0].numpy() for x in program(torch.from_numpy(well[None])))

    assert (labels == ref_labels).mean() >= 0.99
    assert abs(int(labels.max()) - int(ref_labels.max())) <= 1
    assert ref_labels.max() >= n_cells - 1
    assert health[1:].tolist() == ref_health[1:].tolist() == [0, 1]
    assert health[0] == labels.max()

    # the measurement, given the JAX program's labels
    ours = _table_given_labels(ref_labels, well, CONFIG.max_cells)
    cols = plate._PROP_COLUMNS
    for name in INTEGER_COLUMNS:
        i = cols.index(name)
        np.testing.assert_array_equal(ours[:, i], ref_packed[:, i], err_msg=name)
    ori = cols.index("orientation")
    exact = {cols.index(name) for name in INTEGER_COLUMNS} | {ori}
    rest = [i for i in range(ref_packed.shape[-1]) if i not in exact]
    finite = np.isfinite(ref_packed[:, rest])
    np.testing.assert_array_equal(np.isfinite(ours[:, rest]), finite)
    np.testing.assert_allclose(ours[:, rest][finite], ref_packed[:, rest][finite], rtol=RTOL, atol=ATOL)
    roots = np.where(ref_labels > 0, ref_labels - 1, ref_labels.size)
    _orientation_check(ours[:, ori], ref_packed[:, ori], ref_packed[:, cols.index("eccentricity")],
                       _exact_moment_ties(roots, CONFIG.max_cells))


def test_weights_in_every_form_give_one_network(params):
    """The JAX tree as numpy, the same tree flattened to dotted keys (the
    `.npz` checkpoint's contents), and the port's state dict load the same
    weights; None gives seeded ones."""
    with np.load(DEFAULT_WEIGHTS) as data:
        flat = {k: data[k] for k in data.files}
    nets = [plate.unet_network(p, "cpu") for p in (params, flat, load_weights())]
    for a, b in zip(nets[0].parameters(), nets[1].parameters()):
        assert torch.equal(a, b)
    for a, b in zip(nets[0].parameters(), nets[2].parameters()):
        assert torch.equal(a, b)
    seeded = plate.unet_network(None, "cpu")
    assert not torch.equal(seeded.head, nets[0].head)
    assert torch.equal(seeded.head, plate.unet_network(None, "cpu").head)


def test_runner_tables_match_jax(params):
    """PlateRunner.run on two wells: cell counts within one of the JAX
    runner's, and mean areas within 5%."""
    wells = {"A01": _well(128, 5, 2), "A02": _well(128, 6, 3)}
    ours = plate.PlateRunner(CONFIG, device="cpu", unet_params=params).run(_layout(wells), wells)
    jax_config = jax_plate.PlateRunConfig(**dataclasses.asdict(CONFIG))
    ref = jax_plate.PlateRunner(jax_config, unet_params=params).run(
        _layout(wells, JaxLayout, JaxWell), wells
    )
    assert not ours.failed_wells and not ref.failed_wells
    for w in wells:
        a, b = ours.tables[w], ref.tables[w]
        assert list(a.columns) == list(b.columns)
        assert abs(len(a) - len(b)) <= 1 and len(b) >= 3
        assert abs(a["area"].mean() / b["area"].mean() - 1) < 0.05


def test_dense_well_escalates_capacity(params):
    """10 cells against max_cells=2, QC off: the largest label exceeds the
    capacity, so the well is re-dispatched at 4x (8 cells, still short) and
    16x, and then equals a run at the full capacity."""
    well = _well(128, 10, 4)
    no_qc = dataclasses.replace(CONFIG, flow_threshold=0.0)
    results = plate.PlateRunner(
        dataclasses.replace(no_qc, max_cells=2), device="cpu", unet_params=params
    ).run(_layout(["A01"]), {"A01": well})
    assert not results.failed_wells
    assert results.timings["capacity_retries"] == 2
    reference = plate.PlateRunner(
        dataclasses.replace(no_qc, max_cells=32), device="cpu", unet_params=params
    ).run(_layout(["A01"]), {"A01": well})
    pd.testing.assert_frame_equal(results.tables["A01"], reference.tables["A01"])
    assert len(reference.tables["A01"]) > 8


def test_qc_drops_the_cells_beyond_max_cells_as_the_reference_does(params):
    """A reference caveat the port keeps: with the QC on, labels above
    `max_cells` share the QC's last segment, whose flow error then trips the
    threshold, so they are dropped and the largest label never exceeds
    `max_cells`: no escalation, 7 of 10 cells at max_cells=8, as in the JAX
    program."""
    well = _well(128, 10, 4)
    config = dataclasses.replace(CONFIG, max_cells=8)
    _, ref_health, ref_labels = _jax_program(params, config)(jnp.asarray(well))
    program = plate._build_well_program(config, 2, plate.unet_network(params, "cpu"), debug_labels=True)
    _, health, labels = program(torch.from_numpy(well[None]))
    assert health[0].tolist() == np.asarray(ref_health).tolist() == [7, 0, 1]
    assert int(labels.max()) == int(np.asarray(ref_labels).max()) == 7


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resumes_a_checkpoint_written_by_either_runner(params, tmp_path, writer):
    wells = {"A01": _well(128, 5, 5), "A02": _well(128, 5, 6)}
    if writer == "jax":
        jax_config = jax_plate.PlateRunConfig(**dataclasses.asdict(CONFIG))
        first = jax_plate.PlateRunner(jax_config, unet_params=params, checkpoint_dir=tmp_path).run(
            _layout(["A01"], JaxLayout, JaxWell), {"A01": wells["A01"]}
        )
        # A01 must come from the checkpoint: the source only holds A02
        results = plate.PlateRunner(
            CONFIG, checkpoint_dir=tmp_path, device="cpu", unet_params=params
        ).run(_layout(["A01", "A02"]), {"A02": wells["A02"]})
    else:
        first = plate.PlateRunner(
            CONFIG, checkpoint_dir=tmp_path, device="cpu", unet_params=params
        ).run(_layout(["A01"]), {"A01": wells["A01"]})
        jax_config = jax_plate.PlateRunConfig(**dataclasses.asdict(CONFIG))
        results = jax_plate.PlateRunner(jax_config, unet_params=params, checkpoint_dir=tmp_path).run(
            _layout(["A01", "A02"], JaxLayout, JaxWell), {"A02": wells["A02"]}
        )
    assert not results.failed_wells
    pd.testing.assert_frame_equal(
        results.tables["A01"], pd.read_csv(tmp_path / "A01.csv"), check_dtype=False
    )
    np.testing.assert_allclose(results.tables["A01"]["area"], first.tables["A01"]["area"])
    assert json.loads((tmp_path / "manifest.json").read_text()) == {"A01": "A01.csv", "A02": "A02.csv"}
