"""Rank processes for the PyTorch port's mesh tests (test_torch_parallel.py,
test_torch_multiprocess.py).

Each scenario runs in spawned processes that form a gloo group over a file
store and drive the port with device="cpu". This module imports neither JAX
nor the JAX package: the spawned ranks import it, and the JAX side of each
comparison stays in the pytest process. Inputs arrive as an .npz file;
every rank pickles what it saw to rank<r>.pkl for the pytest process.
"""

from __future__ import annotations

import pickle
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

CONFIG = dict(max_cells=32, min_size=4)
# the classical configurations outside the fused histogram frontend, which
# take the staged mask (gathered whole on every rank of a space group)
STAGED_CONFIGS = {
    "li, opening 2": dict(CONFIG, threshold_method="li", opening_radius=2),
    "mean": dict(CONFIG, threshold_method="mean"),
    "triangle": dict(CONFIG, threshold_method="triangle"),
}
# the U-Net plate: the trained weights; in "over capacity" about 3 of 4
# pixels pass the cell probability, more than the compact tail's 8192 slots
# (the cut falls inside the second slab), and, without the QC, the cells
# outnumber max_cells
UNET_CONFIGS = {
    "default": dict(method="unet", max_cells=64, min_size=15, niter=100, remove_edge_cells=True),
    "over capacity": dict(method="unet", max_cells=4, min_size=15, niter=100,
                          cellprob_threshold=-6.0, flow_threshold=0.0),
}
# the two-process plate: batches of 8 over two ranks (4 wells each, a tail
# of 2 each), and few enough cell slots that dense wells escalate
MULTIPROCESS_CONFIG = dict(max_cells=6, min_size=4, batch_size=8)


def run_ranks(scenario: str, world: int, tmp: Path, timeout: float = 240.0) -> list[dict]:
    """Run `scenario` on `world` spawned ranks; returns each rank's pickled
    results. Raises with the failing rank's traceback when a rank fails,
    and stops every rank before returning."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(scenario, r, world, str(tmp))) for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    try:
        while any(proc.is_alive() for proc in procs):
            if time.monotonic() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join(10)
    errors = sorted(tmp.glob("error*.txt"))
    if errors:
        raise RuntimeError(errors[0].read_text())
    codes = [proc.exitcode for proc in procs]
    if codes != [0] * world:
        raise RuntimeError(f"{scenario}: ranks exited with {codes} (timeout {timeout} s)")
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(world)]


def _rank_main(scenario: str, rank: int, world: int, tmp: str) -> None:
    import torch.distributed as dist

    from arcadia_microscopy_tools_tpu_torch.parallel.multiprocess import initialize_distributed

    torch.set_num_threads(1)
    d = Path(tmp)
    try:
        initialize_distributed(f"file://{d / 'store'}", world, rank, backend="gloo")
        data = dict(np.load(d / "inputs.npz"))
        out = SCENARIOS[scenario](data)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        (d / f"error{rank}.txt").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    (d / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def _layout(ids):
    from arcadia_microscopy_tools_tpu_torch import MicroplateLayout
    from arcadia_microscopy_tools_tpu_torch.core.microplate import Well

    return MicroplateLayout([Well(id=i) for i in ids])


def _programs(meshes: dict, cases: dict, configs: dict, unet_params=None) -> dict:
    """The sharded well program of every (mesh, config, case): packed and
    health on this rank after the all-gather."""
    from arcadia_microscopy_tools_tpu_torch.parallel import plate

    out = {}
    for mname, mesh in meshes.items():
        for cname, config in configs.items():
            runner = plate.PlateRunner(plate.PlateRunConfig(**config), mesh=mesh, device="cpu",
                                       unet_params=unet_params)
            for name, x in cases.items():
                packed, health = runner._get_compiled(x.shape[1], x.shape[-2:])(torch.from_numpy(x))
                out[(mname, cname, name)] = (packed.numpy(), health.numpy())
    return out


def _errors(fn) -> str | None:
    try:
        fn()
    except (ValueError, NotImplementedError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def eight_ranks(data: dict) -> dict:
    """8 ranks: mesh shapes and errors, the (hosts=2, wells=2, space=2) and
    (hosts=2) programs against (wells=8), the collectives on a space=8
    mesh, and the runner on (hosts=2) and (wells=2, space=4) meshes."""
    import torch.distributed as dist

    from arcadia_microscopy_tools_tpu_torch.parallel import collectives
    from arcadia_microscopy_tools_tpu_torch.parallel import mesh as M
    from arcadia_microscopy_tools_tpu_torch.parallel import plate

    out = {
        "all": M.create_mesh().shape,
        "space4": M.create_mesh(M.MeshConfig(space_parallelism=4)).shape,
        "bad space": _errors(lambda: M.create_mesh(M.MeshConfig(space_parallelism=3))),
        "hosts2": M.create_multihost_mesh(2).shape,
        "bad hosts": _errors(lambda: M.create_multihost_mesh(3)),
        "too many": _errors(lambda: M.create_mesh(M.MeshConfig(n_devices=9))),
        "too few": _errors(lambda: M.create_mesh(M.MeshConfig(n_devices=4))),
    }
    meshes = {
        "wells=8": M.create_mesh(),
        "hosts=2": M.create_multihost_mesh(2),
        "hosts=2,wells=2,space=2": M.create_multihost_mesh(2, M.MeshConfig(space_parallelism=2)),
        "wells=2,space=4": M.create_mesh(M.MeshConfig(space_parallelism=4)),
    }
    out["programs"] = _programs(meshes, {"wells64": data["wells64"]}, {"default": CONFIG})
    # 70 rows on 4 slabs: 18, 18, 18 and a ragged 16
    out["programs"].update(_programs({"wells=2,space=4": meshes["wells=2,space=4"]},
                                     {"ragged70": data["ragged70"]}, {"default": CONFIG}))
    out["coords"] = {k: m.coords for k, m in meshes.items()}

    m8 = M.create_mesh(M.MeshConfig(space_parallelism=8))
    g = m8.group(M.SPACE_AXIS)
    i = m8.coords[M.SPACE_AXIS]
    x, otsu_img, gauss_img = (torch.from_numpy(data[k]) for k in ("halo", "otsu", "gauss"))
    out["halo"] = collectives.all_gather(
        collectives.halo_exchange(x[8 * i : 8 * i + 8], 2, g), g).numpy()
    out["otsu"] = float(collectives.sharded_otsu_threshold(otsu_img[8 * i : 8 * i + 8], g))
    out["gauss"] = collectives.all_gather(
        collectives.sharded_gaussian_filter(gauss_img[8 * i : 8 * i + 8], 2.0, g), g).numpy()

    wells = data["wells128"]
    ids = [f"A{k + 1:02d}" for k in range(len(wells))]
    cfg = plate.PlateRunConfig(max_cells=64, min_size=20)
    out["runner hosts=2"] = plate.PlateRunner(cfg, mesh=meshes["hosts=2"], device="cpu").run(
        _layout(ids), dict(zip(ids, wells))).tables
    big = data["wells256"]
    ids2 = ids[: len(big)]
    out["runner space=4"] = plate.PlateRunner(cfg, M.MeshConfig(space_parallelism=4), device="cpu").run(
        _layout(ids2), dict(zip(ids2, big))).tables
    out["rank"] = dist.get_rank()
    return out


def two_ranks(data: dict) -> dict:
    """2 ranks: the program on (wells=2) and (space=2) for every case and
    config, the staged classical configurations and the U-Net on (space=2),
    a halo taller than the shard, `make_sharded_otsu`, and the runner's
    tables on both meshes and for both new branches on (space=2)."""
    from arcadia_microscopy_tools_tpu_torch.models.weights import load_weights
    from arcadia_microscopy_tools_tpu_torch.parallel import collectives
    from arcadia_microscopy_tools_tpu_torch.parallel import mesh as M
    from arcadia_microscopy_tools_tpu_torch.parallel import plate

    meshes = {"wells=2": M.create_mesh(), "space=2": M.create_mesh(M.MeshConfig(space_parallelism=2))}
    cases = {k[len("case_"):]: v for k, v in data.items() if k.startswith("case_")}
    configs = {"default": CONFIG,
               "over capacity": dict(max_cells=4, min_size=4, fg_cap_fraction=0.0002)}
    out = {"programs": _programs(meshes, cases, configs)}
    space_only = {"space=2": meshes["space=2"]}
    staged_cases = {k: cases[k] for k in ("blobs64", "ragged71", "crossing")}
    out["programs"].update(_programs(space_only, staged_cases, STAGED_CONFIGS))
    weights = load_weights()
    unet_cases = {k[len("unet_"):]: v for k, v in data.items() if k.startswith("unet_")}
    out["programs"].update(_programs(space_only, unet_cases, UNET_CONFIGS, weights))

    space = meshes["space=2"]
    g = space.group(M.SPACE_AXIS)
    i = space.coords[M.SPACE_AXIS]
    x = torch.from_numpy(data["halo_tall"])  # 71 rows: slabs of 36 and 35, a halo of 40
    out["tall halo"] = collectives.halo_exchange(x[36 * i : 36 * i + 36], 40, g).numpy()
    img = torch.from_numpy(data["case_blobs64"][0, 0])  # 64 rows: slabs of 32
    out["otsu"] = float(collectives.make_sharded_otsu(space)(img[32 * i : 32 * i + 32]))

    wells = data["case_blobs128"]
    ids = [f"B{k + 1:02d}" for k in range(len(wells))]
    cfg = plate.PlateRunConfig(max_cells=64, min_size=20)
    for name, mesh in meshes.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out[f"runner {name}"] = plate.PlateRunner(cfg, mesh=mesh, device="cpu").run(
                _layout(ids), dict(zip(ids, wells))).tables
    runners = {"staged": (STAGED_CONFIGS["li, opening 2"], wells, None),
               "unet": (UNET_CONFIGS["default"], data["unet_cells128"], weights)}
    for name, (config, ws, params) in runners.items():
        ids = [f"C{k + 1:02d}" for k in range(len(ws))]
        out[f"runner {name} space=2"] = plate.PlateRunner(
            plate.PlateRunConfig(**config), M.MeshConfig(space_parallelism=2), device="cpu",
            unet_params=params).run(_layout(ids), dict(zip(ids, ws))).tables
    return out


def multiprocess_plate(data: dict) -> dict:
    """2 ranks: `run_plate_multiprocess` on 12 wells (batches of 8 and a
    tail of 4) with one well that fails to decode and wells that need a
    capacity escalation; then `initialize_distributed` again, which must
    raise."""
    import torch.distributed as dist

    from arcadia_microscopy_tools_tpu_torch.parallel import plate
    from arcadia_microscopy_tools_tpu_torch.parallel.multiprocess import (
        initialize_distributed,
        run_plate_multiprocess,
    )

    wells = data["wells"]
    ids = [f"C{k + 1:02d}" for k in range(len(wells))]
    bad = str(data["bad"])
    decoded = []

    def source(well_id):
        decoded.append(well_id)
        if well_id == bad:
            raise OSError("corrupt file")
        return wells[ids.index(well_id)]

    config = plate.PlateRunConfig(**MULTIPROCESS_CONFIG)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = run_plate_multiprocess(_layout(ids), source, config, device="cpu")
    return {
        "rank": dist.get_rank(),
        "tables": res.tables,
        "failed": res.failed_wells,
        "timings": res.timings,
        "decoded": decoded,
        "warnings": [str(w.message) for w in caught],
        "reinit": _errors(lambda: initialize_distributed("localhost:1", 1, 0)),
    }


SCENARIOS = {"eight_ranks": eight_ranks, "two_ranks": two_ranks,
             "multiprocess_plate": multiprocess_plate}
