"""PyTorch port: device meshes, collectives and the plate runner on a mesh of
ranks - twins of tests/test_parallel.py's TestMesh, TestCollectives and its
plate-runner tests, plus the row-sharded program's own cases.

The port's ranks are spawned processes in a gloo group running with
device="cpu" (tests/torch_mesh_ranks.py; one spawn of 8 ranks and one of 2
serve every test here). The JAX package runs its sharded programs in this
process on the 8 virtual CPU devices of tests/conftest.py. Held:
- port sharded against port single-process: packed columns, health and
  tables bit for bit, for the fused classical program, the staged classical
  mask (thresholds outside the histogram frontend, an opening) and the U-Net
  on row slabs (the trained weights; the plain conv and moments versions
  give a slab the whole image's bits on the CPU, so no tolerance is needed);
  the U-Net runner on (space=2) is also held against the JAX package's
  (space=2) runner with test_torch_plate_unet.py's runner tolerance (cell
  counts within one, mean areas within 5%: the two bf16 forwards round at
  different points);
- port against JAX: health and integer columns equal, float columns within
  test_torch_plate's tolerances (rtol 1e-5, atol 1e-4), orientation modulo
  pi off moment ties. The inputs are wells on which the reference's float32
  Otsu finds the exact bin (see test_torch_filters_fused), as in
  test_torch_plate.

Every rank's well batch holds at least two wells: on the CPU, oneDNN picks
another convolution for a batch of one, which moves the DoG's last bits.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec

import reference_impl as ref
from arcadia_microscopy_tools_tpu.core.microplate import MicroplateLayout as JaxLayout
from arcadia_microscopy_tools_tpu.core.microplate import Well as JaxWell
from arcadia_microscopy_tools_tpu.models.weights import load_checkpoint
from arcadia_microscopy_tools_tpu.ops.filters import gaussian_filter as jax_gaussian_filter
from arcadia_microscopy_tools_tpu.parallel import MeshConfig as JaxMeshConfig
from arcadia_microscopy_tools_tpu.parallel import create_mesh as jax_create_mesh
from arcadia_microscopy_tools_tpu.parallel import halo_exchange as jax_halo_exchange
from arcadia_microscopy_tools_tpu.parallel import plate as jax_plate
from arcadia_microscopy_tools_tpu.parallel import sharded_otsu_threshold as jax_sharded_otsu
from arcadia_microscopy_tools_tpu.parallel.mesh import create_multihost_mesh as jax_multihost_mesh
from arcadia_microscopy_tools_tpu.parallel.mesh import plate_sharding_multihost
from arcadia_microscopy_tools_tpu_torch.core.microplate import MicroplateLayout, Well
from arcadia_microscopy_tools_tpu_torch.models import conv_cuda, gn_cuda
from arcadia_microscopy_tools_tpu_torch.models.synthetic import synthesize_cells
from arcadia_microscopy_tools_tpu_torch.models.weights import load_weights
from arcadia_microscopy_tools_tpu_torch.ops.filters import gaussian_filter
from arcadia_microscopy_tools_tpu_torch.ops.fused import fused_classical_mask
from arcadia_microscopy_tools_tpu_torch.ops.labeling import component_roots
from arcadia_microscopy_tools_tpu_torch.ops.threshold import threshold_otsu
from arcadia_microscopy_tools_tpu_torch.parallel import collectives, plate
from arcadia_microscopy_tools_tpu_torch.parallel import mesh as M
from test_torch_measure import ATOL, RTOL, _exact_moment_ties
from test_torch_plate import INTEGER_COLUMNS, _orientation_check
from torch_mesh_ranks import CONFIG, STAGED_CONFIGS, UNET_CONFIGS, run_ranks

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RUNNER_CONFIG = dict(max_cells=64, min_size=20)


def _ids(n, row="A"):
    return [f"{row}{k + 1:02d}" for k in range(n)]


def _layout(ids):
    return MicroplateLayout([Well(id=i) for i in ids])


def blob_wells(n: int, h: int, w: int, cells, seed: int, n_channels: int = 2) -> np.ndarray:
    """(n, n_channels, h, w) uint16 wells of separated Gaussian cells on
    N(150, 15) noise (tests/test_parallel.py's recipe at small sizes);
    `cells` is one count for every well or a count per well."""
    rng = np.random.default_rng(seed)
    counts = [cells] * n if isinstance(cells, int) else list(cells)
    yy, xx = np.mgrid[0:h, 0:w]
    img = rng.normal(150, 15, (n, n_channels, h, w)).clip(0, None)
    for k in range(n):
        centres: list[tuple[int, int]] = []
        while len(centres) < counts[k]:
            cy, cx = rng.integers(6, h - 6), rng.integers(6, w - 6)
            if all((cy - a) ** 2 + (cx - b) ** 2 > 14**2 for a, b in centres):
                centres.append((cy, cx))
        for cy, cx in centres:
            blob = 2500 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 20.0)
            img[k, 0] += blob
            for c in range(1, n_channels):
                img[k, c] += blob * rng.uniform(0.2, 1.0)
    return img.clip(0, 65535).astype(np.uint16)


def _crossing_wells() -> np.ndarray:
    """Four 2-channel 64 x 64 wells, each with one long cell that crosses
    every row-shard edge of a 2- and a 4-way split, beside small cells."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:64, 0:64]
    out = rng.normal(150, 15, (4, 2, 64, 64))
    for k, cx in enumerate((14, 24, 40, 46)):
        bar = 2500 * np.exp(-(((xx - cx) / 3.0) ** 2)) * ((yy > 3) & (yy < 61))
        spots = sum(2500 * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / 12.0)
                    for y, x in ((10, 54), (33, 8), (50, 57)))
        out[k, 0] += bar + spots
        out[k, 1] += 0.5 * (bar + spots)
    return out.clip(0, 65535).astype(np.uint16)


def cell_wells(n: int, rows: int, seed: int, cols: int = 128) -> np.ndarray:
    """(n, 2, rows, cols) uint16 wells of synthetic cells and the same at
    half scale (test_torch_plate_unet.py's recipe), for the U-Net."""
    wells = []
    for k in range(n):
        img, _ = synthesize_cells(np.random.default_rng(seed + k), (rows, cols), n_cells=30,
                                  separation=0.95)
        u16 = (img * 60000).astype(np.uint16)
        wells.append(np.stack([u16, u16 // 2]))
    return np.stack(wells)


def _unet_cases() -> dict[str, np.ndarray]:
    # 128 rows: two 64-row slabs; 120 rows: slabs of 64 and 56, the last one
    # taking the edge pad to 64
    return {"cells128": cell_wells(2, 128, seed=20), "cells120": cell_wells(2, 120, seed=30)}


def _world_two_cases() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(7)
    return {
        # a 64^2 well on space=2: 32-row slabs, below both the DoG's 64-row
        # halo and a 128^2 CC tile
        "blobs64": blob_wells(4, 64, 64, 6, seed=0),
        "blobs128": blob_wells(4, 128, 128, 10, seed=0),
        # 71 rows: slabs of 36 and 35
        "ragged71": blob_wells(4, 71, 64, 6, seed=1),
        "crossing": _crossing_wells(),
        # dense noise: with fg_cap_fraction 0.0002 the foreground overflows
        # the compaction's 8192 slots, which the slabs must cut alike
        "noise192": (rng.random((4, 2, 192, 160)) * 4000).astype(np.uint16),
    }


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(42)
    img = (rng.random((64, 64)) * 3000).astype(np.uint16)
    img[20:40] += 20000
    return {
        "wells64": blob_wells(16, 64, 64, 6, seed=0),
        "ragged70": blob_wells(4, 70, 64, 6, seed=0),
        "wells128": blob_wells(16, 128, 128, 10, seed=0),
        "wells256": blob_wells(4, 256, 256, 14, seed=0),
        "halo": rng.random((64, 32)).astype(np.float32),
        "otsu": img,
        "gauss": rng.random((64, 48)).astype(np.float32),
        "halo_tall": rng.random((71, 16)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def eight(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eight_ranks")
    np.savez(tmp / "inputs.npz", **inputs)
    return run_ranks("eight_ranks", 8, tmp)


@pytest.fixture(scope="module")
def two(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_ranks")
    cases = {f"case_{k}": v for k, v in _world_two_cases().items()}
    cases.update({f"unet_{k}": v for k, v in _unet_cases().items()})
    np.savez(tmp / "inputs.npz", halo_tall=inputs["halo_tall"], **cases)
    return run_ranks("two_ranks", 2, tmp)


@pytest.fixture(scope="module")
def network():
    return plate.unet_network(load_weights(), "cpu")


def _single(x: np.ndarray, config: dict, network=None):
    packed, health = plate._build_well_program(plate.PlateRunConfig(**config), x.shape[1], network)(
        torch.from_numpy(x))
    return packed.numpy(), health.numpy()


def _ties(wells: np.ndarray, max_cells: int):
    mask = fused_classical_mask(torch.from_numpy(wells[:, 0]))
    roots, _ = component_roots(mask)
    return [_exact_moment_ties(r.numpy(), max_cells) for r in roots]


def _assert_matches_jax(ours_packed, ours_health, ref_packed, ref_health, ties):
    np.testing.assert_array_equal(ours_health, ref_health)
    cols = plate._PROP_COLUMNS
    for name in INTEGER_COLUMNS:
        i = cols.index(name)
        np.testing.assert_array_equal(ours_packed[..., i], ref_packed[..., i], err_msg=name)
    ori = cols.index("orientation")
    exact = {cols.index(name) for name in INTEGER_COLUMNS} | {ori}
    floats = [i for i in range(ref_packed.shape[-1]) if i not in exact]
    a, b = ours_packed[..., floats], ref_packed[..., floats]
    finite = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), finite)
    np.testing.assert_allclose(a[finite], b[finite], rtol=RTOL, atol=ATOL)
    ecc = ref_packed[..., cols.index("eccentricity")]
    for k, tie in enumerate(ties):
        _orientation_check(ours_packed[k, :, ori], ref_packed[k, :, ori], ecc[k], tie)


def _assert_tables_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for w in want:
        assert got[w] is not None and want[w] is not None, w
        assert got[w].equals(want[w]), w


def _assert_tables_match_jax(ours: dict, theirs: dict, wells: np.ndarray, ids):
    ties = _ties(wells, RUNNER_CONFIG["max_cells"])
    for k, w in enumerate(ids):
        a, b = ours[w], theirs.tables[w]
        assert list(a.columns) == list(b.columns) and len(a) == len(b) >= 8
        for col in a.columns:
            if col != "orientation":
                np.testing.assert_allclose(a[col], b[col], rtol=RTOL, atol=ATOL, err_msg=col)
        packed, _ = _single(wells[k : k + 1], RUNNER_CONFIG)
        cols = plate._PROP_COLUMNS
        keep = (packed[0, :, cols.index("valid")] > 0.5) & (packed[0, :, cols.index("area")] >= 20)
        _orientation_check(a["orientation"].to_numpy(), b["orientation"].to_numpy(),
                           b["eccentricity"].to_numpy(), ties[k][keep])


class TestMesh:
    def test_create_mesh_without_a_process_group_is_one_by_one(self):
        mesh = M.create_mesh()
        assert mesh.shape == {M.WELL_AXIS: 1, M.SPACE_AXIS: 1}
        assert mesh.group(M.WELL_AXIS) is None and mesh.group(M.SPACE_AXIS) is None
        assert M.well_sharding(mesh, spatial=True) == M.Shard()
        with pytest.raises(ValueError, match="must divide"):
            M.create_mesh(M.MeshConfig(space_parallelism=2))

    def test_create_mesh_all_devices(self, eight):
        assert eight[0]["all"] == {M.WELL_AXIS: 8, M.SPACE_AXIS: 1}

    def test_space_parallelism(self, eight):
        assert eight[0]["space4"] == {M.WELL_AXIS: 2, M.SPACE_AXIS: 4}
        coords = [r["coords"]["wells=2,space=4"] for r in eight]
        assert coords == [{M.WELL_AXIS: k // 4, M.SPACE_AXIS: k % 4} for k in range(8)]

    def test_bad_space_parallelism(self, eight):
        assert "must divide" in eight[0]["bad space"]
        assert "only 8 available" in eight[0]["too many"]
        assert "spans every rank" in eight[0]["too few"]

    def test_multihost_mesh_axes(self, eight):
        assert eight[0]["hosts2"] == {M.HOST_AXIS: 2, M.WELL_AXIS: 4, M.SPACE_AXIS: 1}
        assert "must divide" in eight[0]["bad hosts"]

    def test_multihost_spatial_sharding_matches(self, eight, inputs):
        """(hosts=2, wells=2, space=2): bit for bit the single process, and
        the JAX package's sharded program on the same wells."""
        wells = inputs["wells64"]
        want = _single(wells, CONFIG)
        for r in eight:
            got = r["programs"][("hosts=2,wells=2,space=2", "default", "wells64")]
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        mesh = jax_multihost_mesh(2, JaxMeshConfig(space_parallelism=2))
        sh = plate_sharding_multihost(mesh, spatial=True)
        jax_config = jax_plate.PlateRunConfig(**CONFIG)
        program = jax.jit(jax.vmap(jax_plate._build_well_program(jax_config, 2, spatial=True)),
                          in_shardings=(sh,))
        ref_packed, ref_health = (np.asarray(t) for t in program(jax.device_put(jnp.asarray(wells), sh)))
        _assert_matches_jax(*got, ref_packed, ref_health, _ties(wells, CONFIG["max_cells"]))

    def test_multihost_plate_program_matches_single_axis(self, eight):
        """A (hosts, wells) mesh run equals the wells-axis run bit for bit,
        and so do the other layouts of the 8 ranks."""
        programs = eight[0]["programs"]
        want = programs[("wells=8", "default", "wells64")]
        for layout in ("hosts=2", "wells=2,space=4"):
            got = programs[(layout, "default", "wells64")]
            np.testing.assert_array_equal(got[0], want[0], err_msg=layout)
            np.testing.assert_array_equal(got[1], want[1], err_msg=layout)

    def test_ragged_last_shard_on_four_slabs(self, eight, inputs):
        """70 rows over space=4: slabs of 18, 18, 18 and 16."""
        want = _single(inputs["ragged70"], CONFIG)
        for r in eight:
            got = r["programs"][("wells=2,space=4", "default", "ragged70")]
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


class TestCollectives:
    def test_halo_exchange_matches_edge_padding(self, eight, inputs):
        """8 shards of 8 rows with a halo of 2: the same rows as the JAX
        function gives under shard_map, true neighbours inside and the edge
        row replicated outside."""
        x = inputs["halo"]
        mesh = jax_create_mesh(JaxMeshConfig(space_parallelism=8))
        fn = shard_map(lambda xl: jax_halo_exchange(xl, 2, "space"), mesh=mesh,
                       in_specs=(PartitionSpec("space", None),),
                       out_specs=PartitionSpec("space", None))
        theirs = np.asarray(jax.jit(fn)(jnp.asarray(x))).reshape(8, 12, 32)
        for r in eight:
            np.testing.assert_array_equal(r["halo"], theirs)
        shard = r["halo"][3]
        np.testing.assert_array_equal(shard[2:-2], x[24:32])
        np.testing.assert_array_equal(shard[:2], x[22:24])
        np.testing.assert_array_equal(shard[-2:], x[32:34])
        np.testing.assert_array_equal(r["halo"][0][:2], x[[0, 0]])

    def test_sharded_otsu_equals_global(self, eight, inputs):
        img = inputs["otsu"]
        mesh = jax_create_mesh(JaxMeshConfig(space_parallelism=8))
        fn = shard_map(lambda xl: jax_sharded_otsu(xl, "space"), mesh=mesh,
                       in_specs=(PartitionSpec("space", None),), out_specs=PartitionSpec())
        theirs = float(jax.jit(fn)(jnp.asarray(img)))
        single = float(threshold_otsu(torch.from_numpy(img)))
        assert [r["otsu"] for r in eight] == [single] * 8
        assert single == theirs == ref.threshold_otsu(img)

    def test_sharded_gaussian_equals_single_chip(self, eight, inputs):
        img = inputs["gauss"]
        single = gaussian_filter(torch.from_numpy(img), 2.0).numpy()
        for r in eight:
            np.testing.assert_array_equal(r["gauss"].reshape(64, 48), single)
        theirs = np.asarray(jax_gaussian_filter(jnp.asarray(img), 2.0))
        np.testing.assert_allclose(single, theirs, atol=1e-5)

    def test_halo_taller_than_the_shard(self, two, inputs):
        """A 40-row halo over slabs of 36 and 35 rows (a ragged last shard)
        takes rows from past the neighbour, and replicates the edges."""
        x = inputs["halo_tall"]
        rows = [np.arange(-40, 76).clip(0, 70), np.arange(-4, 111).clip(0, 70)]
        for r, want in zip(two, rows):
            np.testing.assert_array_equal(r["tall halo"], x[want])

    def test_make_sharded_otsu_equals_global(self, two):
        """`make_sharded_otsu` over the space axis of a (space=2) mesh, each
        rank passing its 32 of 64 rows: the whole image's threshold."""
        img = torch.from_numpy(_world_two_cases()["blobs64"][0, 0])
        single = float(threshold_otsu(img))
        assert [r["otsu"] for r in two] == [single, single]
        assert float(collectives.make_sharded_otsu(M.create_mesh())(img)) == single

    def test_single_shard_needs_no_group(self, inputs):
        x = torch.from_numpy(inputs["halo_tall"])
        padded = collectives.halo_exchange(x, 80, None)
        np.testing.assert_array_equal(padded.numpy(), x.numpy()[np.arange(-80, 151).clip(0, 70)])
        assert float(collectives.sharded_otsu_threshold(torch.from_numpy(inputs["otsu"]), None)) == (
            float(threshold_otsu(torch.from_numpy(inputs["otsu"]))))


CASES = list(_world_two_cases())


class TestRowShardedProgram:
    @pytest.mark.parametrize("case", CASES)
    @pytest.mark.parametrize("mesh", ["wells=2", "space=2"])
    @pytest.mark.parametrize("config", ["default", "over capacity"])
    def test_equals_the_single_process_bit_for_bit(self, two, mesh, case, config):
        """Packed columns and health of every well equal the single
        process's, on both ranks: halos taller than the slab, a ragged last
        slab, a cell that crosses the slab edge, a well whose foreground
        overflows the compaction, and more components than max_cells."""
        x = _world_two_cases()[case]
        configs = {"default": CONFIG,
                   "over capacity": dict(max_cells=4, min_size=4, fg_cap_fraction=0.0002)}
        want = _single(x, configs[config])
        for r in two:
            got = r["programs"][(mesh, config, case)]
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])

    def test_cases_reach_what_they_name(self):
        """The crossing cell spans every slab edge; the noise overflows the
        compaction; the over-capacity config exceeds max_cells."""
        x = _world_two_cases()
        packed, health = _single(x["crossing"], CONFIG)
        cols = plate._PROP_COLUMNS
        rows = packed[..., cols.index("bbox_max_row")] - packed[..., cols.index("bbox_min_row")]
        assert (rows.max(1) > 48).all() and (health[:, 2] == 1).all()
        _, health = _single(x["noise192"], dict(max_cells=4, min_size=4, fg_cap_fraction=0.0002))
        assert health[:, 1].all() and (health[:, 0] > 4).all()

    @pytest.mark.parametrize("case", ["blobs64", "ragged71", "crossing"])
    @pytest.mark.parametrize("config", list(STAGED_CONFIGS))
    def test_staged_mask_on_slabs_equals_the_single_process(self, two, config, case):
        """Thresholds outside the fused histogram frontend and an opening:
        the segmentation channel gathered and the staged mask run whole on
        each rank; packed columns and health bit for bit."""
        want = _single(_world_two_cases()[case], STAGED_CONFIGS[config])
        for r in two:
            got = r["programs"][("space=2", config, case)]
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])

    @pytest.mark.parametrize("case", ["cells128", "cells120"])
    @pytest.mark.parametrize("config", list(UNET_CONFIGS))
    def test_unet_on_slabs_equals_the_single_process(self, two, network, config, case):
        """The U-Net forward on row slabs (halo rows, gathered GroupNorm
        partials and deepest features) and the compact tail from the slabs'
        lists: packed columns and health bit for bit, also where the active
        pixels overflow the list and the cells max_cells."""
        want = _single(_unet_cases()[case], UNET_CONFIGS[config], network)
        for r in two:
            got = r["programs"][("space=2", config, case)]
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])

    def test_unet_cases_reach_what_they_name(self, network):
        """The default config finds cells in every well, some of them
        across the slab edge; "over capacity" overflows the active-pixel
        list and exceeds max_cells in every well."""
        cols = plate._PROP_COLUMNS
        for case, x in _unet_cases().items():
            packed, health = _single(x, UNET_CONFIGS["default"], network)
            assert (health[:, 0] >= 5).all() and not health[:, 1].any(), case
            lo = packed[..., cols.index("bbox_min_row")]
            hi = packed[..., cols.index("bbox_max_row")]
            valid = packed[..., cols.index("valid")] > 0.5
            assert (valid & (lo < 64) & (hi > 64)).any(), case
            _, health = _single(x, UNET_CONFIGS["over capacity"], network)
            assert health[:, 1].all() and (health[:, 0] > 4).all(), case

    @pytest.mark.parametrize("mesh", ["wells=2", "space=2"])
    def test_runner_tables_equal_the_single_process(self, two, mesh):
        wells = _world_two_cases()["blobs128"]
        ids = _ids(len(wells), "B")
        want = plate.PlateRunner(plate.PlateRunConfig(**RUNNER_CONFIG), device="cpu").run(
            _layout(ids), dict(zip(ids, wells))).tables
        for r in two:
            _assert_tables_equal(r[f"runner {mesh}"], want)

    @pytest.mark.parametrize("method", ["staged", "unet"])
    def test_runner_tables_on_slabs_equal_the_single_process(self, two, method):
        """PlateRunner on (space=2) with the staged classical mask (li,
        opening 2) and with the U-Net: the single process's tables bit for
        bit."""
        config, wells, params = {
            "staged": (STAGED_CONFIGS["li, opening 2"], _world_two_cases()["blobs128"], None),
            "unet": (UNET_CONFIGS["default"], _unet_cases()["cells128"], load_weights()),
        }[method]
        ids = _ids(len(wells), "C")
        want = plate.PlateRunner(plate.PlateRunConfig(**config), device="cpu",
                                 unet_params=params).run(_layout(ids), dict(zip(ids, wells))).tables
        for r in two:
            _assert_tables_equal(r[f"runner {method} space=2"], want)


class TestPlateRunner:
    def test_multihost_runner_matches_single_axis(self, eight, inputs):
        """PlateRunner on a 2-host mesh: the single process's tables bit for
        bit, on every rank; the JAX package's 2-host runner within the
        tolerances."""
        wells = inputs["wells128"]
        ids = _ids(len(wells))
        source = dict(zip(ids, wells))
        want = plate.PlateRunner(plate.PlateRunConfig(**RUNNER_CONFIG), device="cpu").run(
            _layout(ids), source).tables
        for r in eight:
            _assert_tables_equal(r["runner hosts=2"], want)
        jax_config = jax_plate.PlateRunConfig(**RUNNER_CONFIG)
        theirs = jax_plate.PlateRunner(jax_config, mesh=jax_multihost_mesh(2)).run(
            JaxLayout([JaxWell(id=i) for i in ids]), source)
        _assert_tables_match_jax(want, theirs, wells, ids)

    def test_spatial_unet_runner_matches_jax(self, two):
        """The U-Net runner on (space=2) against the JAX package's runner on
        a (space=2) mesh of the same trained weights: cell counts within
        one and mean areas within 5% (test_torch_plate_unet.py's runner
        tolerance)."""
        wells = _unet_cases()["cells128"]
        ids = _ids(len(wells), "C")
        params = jax.tree.map(np.asarray, load_checkpoint(REPO / "checkpoints" / "unet"))
        jax_config = jax_plate.PlateRunConfig(**UNET_CONFIGS["default"])
        theirs = jax_plate.PlateRunner(jax_config, JaxMeshConfig(space_parallelism=2),
                                       unet_params=params).run(
            JaxLayout([JaxWell(id=i) for i in ids]), dict(zip(ids, wells))).tables
        for r in two:
            ours = r["runner unet space=2"]
            for w in ids:
                a, b = ours[w], theirs[w]
                assert list(a.columns) == list(b.columns)
                assert abs(len(a) - len(b)) <= 1 and len(b) >= 5
                assert abs(a["area"].mean() / b["area"].mean() - 1) < 0.05

    def test_spatial_sharding_matches_single_chip(self, eight, inputs):
        """space_parallelism=4 on 8 ranks (wells=2, space=4): the single
        process's tables bit for bit; the JAX package's space=4 run within
        the tolerances."""
        wells = inputs["wells256"]
        ids = _ids(len(wells))
        source = dict(zip(ids, wells))
        want = plate.PlateRunner(plate.PlateRunConfig(**RUNNER_CONFIG), device="cpu").run(
            _layout(ids), source).tables
        for r in eight:
            _assert_tables_equal(r["runner space=4"], want)
        jax_config = jax_plate.PlateRunConfig(**RUNNER_CONFIG)
        theirs = jax_plate.PlateRunner(jax_config, JaxMeshConfig(space_parallelism=4)).run(
            JaxLayout([JaxWell(id=i) for i in ids]), source)
        _assert_tables_match_jax(want, theirs, wells, ids)

    def test_default_batch_scales_with_the_batch_ranks(self):
        runner = plate.PlateRunner(plate.PlateRunConfig(), device="cpu")
        assert runner._batch_size() == plate.DEFAULT_BATCH
        sized = plate.PlateRunner(plate.PlateRunConfig(batch_size=3), device="cpu")
        assert sized._batch_size() == 3
        shard = M.Shard(batch_index=1, batch_count=2, space_index=1, space_count=4)
        assert shard.batch_rows(5) == slice(3, 5) and shard.image_rows(70) == slice(18, 36)
        assert M.Shard(3, 4, 3, 4).image_rows(70) == slice(54, 70)
        with pytest.raises(ValueError, match="without rows"):
            M.Shard(0, 1, 0, 4).image_rows(3)


# the 16 conv calls of a U-Net forward on 64^2 images, as chip_smoke.py's
# forward_conv_shapes lists them: (name, C, Co, rows, prologue + ReLU, accum)
FORWARD_CONVS = [
    ("down0.conv2", 32, 32, 64, True, False),
    ("down1.conv1", 32, 64, 32, False, False),
    ("down1.conv2", 64, 64, 32, True, False),
    ("down2.conv1", 64, 128, 16, False, False),
    ("down2.conv2", 128, 128, 16, True, False),
    ("down3.conv1", 128, 256, 8, False, False),
    ("down3.conv2", 256, 256, 8, True, False),
    ("up0.conv1_up", 256, 128, 16, False, False),
    ("up0.conv1_skip", 128, 128, 16, False, True),
    ("up0.conv2", 128, 128, 16, True, False),
    ("up1.conv1_up", 128, 64, 32, False, False),
    ("up1.conv1_skip", 64, 64, 32, False, True),
    ("up1.conv2", 64, 64, 32, True, False),
    ("up2.conv1_up", 64, 32, 64, False, False),
    ("up2.conv1_skip", 32, 32, 64, False, True),
    ("up2.conv2", 32, 32, 64, True, False),
]


class TestRowSlabs:
    def test_row_bounds(self):
        """Slabs of ceil(H / S) rows rounded up to the alignment, the last
        one shorter."""
        assert M.row_bounds(70, 4) == (0, 18, 36, 54, 70)
        assert M.row_bounds(2048, 2, 16) == (0, 1024, 2048)
        assert M.row_bounds(120, 2, 32) == (0, 64, 120)
        assert M.row_bounds(2000, 4, 16) == (0, 512, 1024, 1536, 2000)
        assert M.row_bounds(60, 2, 32) == (0, 32, 60)
        with pytest.raises(ValueError, match="multiples of 32 rows"):
            M.row_bounds(30, 2, 32)
        with pytest.raises(ValueError, match="without rows"):
            M.row_bounds(3, 4)

    def test_unet_slab_alignment(self):
        """16 rows (the conv tiles and max-pooling), more only where the
        moments kernel's run of rows is longer (narrow wells)."""
        assert [plate.unet_row_align(w) for w in (2048, 1000, 256, 128, 100, 30)] == (
            [16, 16, 16, 32, 32, 128])
        assert [gn_cuda.lane_rows(w) for w in (2048, 1504, 4096, 8192, 104)] == [2, 2, 1, 1, 32]

    def test_a_well_too_small_for_aligned_slabs_raises(self):
        runner = plate.PlateRunner(plate.PlateRunConfig(method="unet"), device="cpu")
        runner.mesh = SimpleNamespace(shape={M.WELL_AXIS: 1, M.SPACE_AXIS: 2},
                                      coords={M.WELL_AXIS: 0, M.SPACE_AXIS: 1},
                                      group=lambda axis: None)
        rows, slab = runner._slab(120, 128)
        assert rows == slice(64, 120) and slab.row0 == 64 and slab.heights == [64, 56]
        with pytest.raises(ValueError, match="without rows"):
            runner._slab(30, 128)
        runner.config = plate.PlateRunConfig()  # the classical program's slabs stay unaligned
        assert runner._slab(30, 128)[0] == slice(15, 30)

    @pytest.mark.parametrize("name, c, co, h, pro, acc", FORWARD_CONVS,
                             ids=[c[0] for c in FORWARD_CONVS])
    def test_conv_slabs_concatenate_to_the_whole_call(self, name, c, co, h, pro, acc):
        """The plain conv (the CPU's) of two row slabs split at half the
        rows (32 full-resolution rows), each with its halo row, equals the
        whole-image call: y and the moment partials bit for bit."""
        g = torch.Generator().manual_seed(len(name) * 31 + c + co)
        x = torch.randn((2, h, h, c), generator=g).to(torch.bfloat16)
        wt = (torch.randn((3, 3, co, c), generator=g) / (3 * c**0.5)).to(torch.bfloat16)
        kw = {}
        if pro:
            kw.update(prologue=(torch.rand((2, c), generator=g) + 0.5,
                                torch.randn((2, c), generator=g) * 0.1), relu=True)
        if acc:
            kw["accum"] = torch.randn((2, h, h, co), generator=g).to(torch.bfloat16)
        whole = conv_cuda.conv3x3_fused(x, wt, emit_moments=True, partials=True, **kw)
        s = h // 2
        halves = []
        for lo, hi in ((0, s), (s, h)):
            top, bottom = int(lo > 0), int(hi < h)
            k = dict(kw, accum=kw["accum"][:, lo:hi]) if acc else kw
            halves.append(conv_cuda.conv3x3_fused(x[:, lo - top : hi + bottom], wt, top=top,
                                                  bottom=bottom, emit_moments=True, partials=True,
                                                  **k))
        assert whole[1].shape[1] == conv_cuda.moment_tiles(h, h, co)
        for i in (0, 1):
            assert torch.equal(torch.cat([halves[0][i], halves[1][i]], 1), whole[i])
        assert torch.equal(conv_cuda.sum_partials(whole[1])[0],
                           conv_cuda.conv3x3_fused(x, wt, emit_moments=True, **kw)[1][0])

    def test_halo_rows_are_image_pixels(self):
        """The prologue applies to halo rows (affine(0) is not 0): a slab
        with its halo row differs from the slab padded with zeros, and equals
        the whole image's rows."""
        g = torch.Generator().manual_seed(3)
        x = torch.randn((2, 32, 64, 32), generator=g).to(torch.bfloat16)
        wt = (torch.randn((3, 3, 32, 32), generator=g) / 16).to(torch.bfloat16)
        pro = (torch.rand((2, 32), generator=g) + 0.5, torch.full((2, 32), 0.5))
        whole = conv_cuda.conv3x3_fused(x, wt, prologue=pro, relu=True)
        top = conv_cuda.conv3x3_fused(x[:, :17], wt, prologue=pro, relu=True, bottom=1)
        alone = conv_cuda.conv3x3_fused(x[:, :16], wt, prologue=pro, relu=True)
        assert torch.equal(top, whole[:, :16])
        assert not torch.equal(alone[:, 15], whole[:, 15])
        with pytest.raises(ValueError, match="halo rows"):
            conv_cuda.conv3x3_fused(x, wt, top=2)

    @pytest.mark.parametrize("shape", [(2, 128, 128, 32), (2, 120, 104, 64), (1, 40, 1504, 32)])
    def test_lane_moment_slabs_concatenate_to_the_whole_image(self, shape):
        """Runs of whole rows: slabs split on a multiple of the run give the
        whole image's partials bit for bit; their sums equal the moments."""
        g = torch.Generator().manual_seed(shape[2])
        x = (torch.randn(shape, generator=g) * 2 + 0.5).to(torch.bfloat16)
        whole = gn_cuda.lane_moments(x, partials=True)
        assert whole.shape == (shape[0], gn_cuda.lane_chunks(shape[1], shape[2]), 2, shape[3])
        s = shape[1] // 2 // gn_cuda.lane_rows(shape[2]) * gn_cuda.lane_rows(shape[2])
        halves = [gn_cuda.lane_moments(x[:, :s], partials=True),
                  gn_cuda.lane_moments(x[:, s:], partials=True)]
        assert torch.equal(torch.cat(halves, 1), whole)
        s1, s2 = gn_cuda.lane_moments(x)
        f = x.double()
        np.testing.assert_allclose(s1.numpy(), f.sum((1, 2)).numpy(), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(s2.numpy(), (f * f).sum((1, 2)).numpy(), rtol=1e-5)


def test_jax_config_carries_over():
    jax_config = jax_plate.PlateRunConfig(max_cells=8)
    assert dataclasses.asdict(plate.PlateRunConfig(**dataclasses.asdict(jax_config))) == (
        dataclasses.asdict(jax_config))
