"""On-card smoke run of the PyTorch port's classical plate path.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its lines:

1. device - the card's name and `nvidia-smi` name / power limit;
2. build - the CUDA kernels, compiled from `csrc/` with nvcc for sm_90a;
3. kernels against plain - each kernel bit-exact against its plain
   PyTorch version on the card, for connectivity 1 and 2, on the main
   path's 8 x 2048^2 masks, a serpentine that hits the sweep cap, a ragged
   1000 x 1500 mask, and all-background / all-foreground masks;
4. main path - 8 synthetic 2048^2 4-channel wells through
   `PlateRunner.run`, with the kernel launch counts of that run, and the
   card's outputs for well 0 held against the plain path on the CPU;
5. timing - steady-state well throughput of the device program, per-stage
   milliseconds, and each kernel's time beside its bound and its plain
   version's time;
6. the `kernels` JSON line, then the card's name and power limit, then the
   final `{"ok": true, ...}` line.

Any failure exits non-zero before the final line. Without a CUDA device the
script exits non-zero at once. `--cpu-rehearsal` runs every phase at a
tiny size on the CPU with the plain versions (a check of the script's own
control flow); it prints no device result and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
NON_TENSOR_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
KERNEL_SOURCE = "arcadia_microscopy_tools_tpu_torch/csrc/cc_local.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_host(fn, reps: int, sync) -> float:
    """Mean milliseconds per call by the host clock around a synchronize."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / reps


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--cpu-rehearsal",
        action="store_true",
        help="tiny sizes on the CPU with the plain versions; prints no device result",
    )
    args = parser.parse_args(argv)
    rehearsal = args.cpu_rehearsal

    def say(msg: str) -> None:
        log(("[cpu rehearsal: no device numbers] " if rehearsal else "") + msg)

    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1

    from arcadia_microscopy_tools_tpu_torch import MicroplateLayout, PlateRunConfig, PlateRunner
    from arcadia_microscopy_tools_tpu_torch._build import load_kernel_library
    from arcadia_microscopy_tools_tpu_torch.core.microplate import Well
    from arcadia_microscopy_tools_tpu_torch.ops import cc_cuda
    from arcadia_microscopy_tools_tpu_torch.ops.compaction import compact_by_root
    from arcadia_microscopy_tools_tpu_torch.ops.fused import fused_classical_mask
    from arcadia_microscopy_tools_tpu_torch.ops.labeling import component_roots, resweep_seeds
    from arcadia_microscopy_tools_tpu_torch.ops.regionprops import measure_compacted
    from arcadia_microscopy_tools_tpu_torch.parallel.plate import (
        _build_well_program,
        foreground_capacity,
    )
    from arcadia_microscopy_tools_tpu_torch.testing import serpentine, synthetic_wells

    n_wells, n_ch = 8, 4
    size, blobs, ragged = (2048, 300, (1000, 1500)) if not rehearsal else (256, 10, (200, 300))
    dev = torch.device("cpu" if rehearsal else "cuda")
    sync = torch.cuda.synchronize if not rehearsal else (lambda: None)
    t_start = time.perf_counter()

    # -- 1. device ----------------------------------------------------------------
    if rehearsal:
        kind, smi = "cpu (rehearsal)", "cpu rehearsal: nvidia-smi not queried"
    else:
        kind, smi = torch.cuda.get_device_name(0), nvidia_smi_line()
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {kind}")
    say(f"[device] nvidia-smi: {smi}")

    # -- 2. build -----------------------------------------------------------------
    if not rehearsal:
        built = load_kernel_library("cc_local")
        say(f"[build] {built.path.name} in {built.build_seconds:.1f} s")
        # the four template instantiations report alike: each distinct line once
        reports = [line.split(":", 1)[-1].strip() for line in built.ptxas_log.splitlines()
                   if "registers" in line or "spill" in line]
        for report in dict.fromkeys(reports):
            say(f"[build] ptxas: {report}")
        smem = 2 * cc_cuda.CC_BLOCK**2 * 4 + cc_cuda.CC_BLOCK**2
        say(f"[build] dynamic shared memory per CTA: {smem} B (two int32 label tiles + mask)")

    # -- data ---------------------------------------------------------------------
    t0 = time.perf_counter()
    wells = synthetic_wells(n_wells, n_ch, size, size, blobs, seed=0)
    say(f"[data] {n_wells} wells of {n_ch}x{size}x{size} uint16, {blobs} blobs each, "
        f"made in {time.perf_counter() - t0:.1f} s")
    staged = torch.from_numpy(wells).to(dev)
    masks = fused_classical_mask(staged[:, 0])
    say(f"[data] foreground fraction {float(masks.float().mean()):.4f}")

    # -- 3. kernels against their plain versions ------------------------------------
    masks_np = masks.cpu().numpy()
    cases = {
        f"main {n_wells}x{size}^2": masks,
        "serpentine": torch.from_numpy(serpentine(masks_np[0, :512, :512])[None]).to(dev),
        f"ragged {ragged[0]}x{ragged[1]}": masks[:1, : ragged[0], : ragged[1]].contiguous(),
        "empty": torch.zeros((1, 256, 384), dtype=torch.bool, device=dev),
        "full": torch.ones((1, 256, 384), dtype=torch.bool, device=dev),
    }
    max_err = {"local_cc": 0.0, "local_resweep": 0.0}
    for conn in (1, 2):
        for name, fg in cases.items():
            got = cc_cuda.local_cc(fg, conn)
            want = cc_cuda.local_cc_plain(fg, conn)
            err = float((got.long() - want.long()).abs().max()) if got.numel() else 0.0
            max_err["local_cc"] = max(max_err["local_cc"], err)
            seeds = resweep_seeds(fg, conn)
            got = cc_cuda.local_resweep(fg, seeds, conn)
            want = cc_cuda.local_resweep_plain(fg, seeds, conn)
            err2 = float((got.long() - want.long()).abs().max()) if got.numel() else 0.0
            max_err["local_resweep"] = max(max_err["local_resweep"], err2)
            say(f"[kernels] connectivity {conn} {name}: local_cc err {err:g}, "
                f"local_resweep err {err2:g}")
            if err or err2:
                raise RuntimeError(f"kernel disagrees with its plain version on {name}")
    caps = cc_cuda.tile_sweep_counts(cases["serpentine"], 2)
    if int(caps.max()) != 256:
        raise RuntimeError("the serpentine did not reach the 256-sweep cap")
    sync()
    say("[kernels] both kernels equal their plain versions bit for bit")

    # -- 4. main path ---------------------------------------------------------------
    config = PlateRunConfig(max_cells=1024, min_size=20)
    layout = MicroplateLayout([Well(id=f"A{k + 1:02d}") for k in range(n_wells)])
    source = {w.id: wells[k] for k, w in enumerate(layout)}
    runner = PlateRunner(config, device=dev)
    cc_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    results = runner.run(layout, source)
    sync()
    run_s = time.perf_counter() - t0
    launches = dict(cc_cuda.launch_counts)
    say(f"[main] PlateRunner.run: {n_wells} wells in {run_s:.3f} s (first run, "
        f"includes staging and host tables); launches {launches}")
    if results.failed_wells:
        raise RuntimeError(f"failed wells: {results.failed_wells}")
    if results.timings["capacity_retries"]:
        raise RuntimeError("a well needed a capacity retry")
    counts = [len(results.tables[w]) for w in layout.well_ids]
    say(f"[main] cells per well: {counts}")
    lo, hi = (0.5 * blobs, 1.2 * blobs) if not rehearsal else (1, 2 * blobs)
    if not all(lo <= c <= hi for c in counts):
        raise RuntimeError(f"implausible cell counts {counts} for {blobs} blobs per well")
    frame = results.to_dataframe()
    numeric = frame.drop(columns=["well_id"]).to_numpy(float)
    if not np.isfinite(numeric).all():
        raise RuntimeError("non-finite values in the plate tables")
    if not rehearsal and not (launches["local_cc"] > 0 and launches["local_resweep"] > 0):
        raise RuntimeError(f"the main path did not launch both kernels: {launches}")

    program = _build_well_program(config, n_ch)
    packed, health = program(staged)
    health = health.cpu().numpy()
    say(f"[main] health (components, overflow, converged) per well: {health.tolist()}")
    if not ((health[:, 2] == 1).all() and (health[:, 1] == 0).all()
            and (health[:, 0] <= config.max_cells).all()):
        raise RuntimeError("a well is unconverged or over capacity")

    # well 0 on the card against the plain path on the CPU, stage by stage
    cpu_mask = fused_classical_mask(torch.from_numpy(wells[:1, 0]))
    mask_disagree = float((cpu_mask != masks[:1].cpu()).float().mean())
    say(f"[check] well 0 mask: card vs CPU disagree on {mask_disagree:.2e} of pixels")
    if mask_disagree > 1e-4:
        raise RuntimeError("card and CPU masks disagree on more than 1e-4 of pixels")
    fg0 = masks[:1]
    roots_d, conv_d = component_roots(fg0, pair_cap=config.pair_cap)
    roots_c, conv_c = component_roots(fg0.cpu(), pair_cap=config.pair_cap)
    if not (torch.equal(roots_d.cpu(), roots_c) and torch.equal(conv_d.cpu(), conv_c)):
        raise RuntimeError("component roots on the card differ from the CPU")
    cap = foreground_capacity(config, size, size)
    comp_d, comp_c = compact_by_root(roots_d, cap), compact_by_root(roots_c, cap)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(comp_d, comp_c)):
        raise RuntimeError("compaction on the card differs from the CPU")
    props_d, int_d = measure_compacted(
        comp_d.seg, comp_d.idx, roots_d, staged[:1], config.max_cells, size
    )
    props_c, int_c = measure_compacted(
        comp_c.seg, comp_c.idx, roots_c, torch.from_numpy(wells[:1]), config.max_cells, size
    )
    worst = 0.0
    ecc = props_c["eccentricity"]
    for name, a in props_d.items():
        a, b = a.cpu(), props_c[name]
        if a.dtype in (torch.int32, torch.bool):
            if not torch.equal(a, b):
                raise RuntimeError(f"integer column {name} differs from the CPU")
        elif name == "orientation":
            # an axis angle: +-pi/2 are one axis; near-round cells and exact
            # moment ties (+-pi/4) depend on the last bit of the sums
            d = (a - b).abs()
            d = torch.minimum(d, torch.pi - d)
            quarter = (a.abs() - torch.pi / 4).abs() < 1e-4
            ties = quarter & ((b.abs() - torch.pi / 4).abs() < 1e-4)
            held = (ecc > 0.3) & ~ties
            if bool((d[held] > 1e-4).any()):
                raise RuntimeError("orientation differs from the CPU")
        else:
            worst = max(worst, float(((a - b).abs() / (1e-4 + b.abs())).max()))
    for ci in int_d:
        for stat, a in int_d[ci].items():
            a, b = a.cpu(), int_c[ci][stat]
            fin = torch.isfinite(b)
            if not torch.equal(torch.isfinite(a), fin):
                raise RuntimeError(f"intensity {stat} finiteness differs from the CPU")
            rel = (a[fin] - b[fin]).abs() / (1e-4 + b[fin].abs())
            worst = max(worst, float(rel.max()))
    say(f"[check] well 0 roots/compaction/integer columns equal the CPU; worst float "
        f"relative difference {worst:.2e}")
    if worst > 1e-5:
        raise RuntimeError("float columns differ from the CPU beyond 1e-5 relative")

    # -- 5. timing ------------------------------------------------------------------
    reps = 5 if not rehearsal else 1
    program_ms = time_host(lambda: program(staged), reps, sync)
    say(f"[time] device program: {program_ms:.2f} ms per batch of {n_wells} wells, "
        f"{n_wells * 1e3 / program_ms:.2f} wells/s (pre-staged, host clock + synchronize)")

    roots_b, _ = component_roots(masks, pair_cap=config.pair_cap)
    comp_b = compact_by_root(roots_b, cap)
    stages = {
        "mask": lambda: fused_classical_mask(staged[:, 0]),
        "cc": lambda: component_roots(masks, pair_cap=config.pair_cap),
        "compaction": lambda: compact_by_root(roots_b, cap),
        "measure": lambda: measure_compacted(
            comp_b.seg, comp_b.idx, roots_b, staged, config.max_cells, size
        ),
    }
    stage_ms = {k: round(time_host(fn, reps, sync), 3) for k, fn in stages.items()}
    say(f"[time] per-stage ms per batch of {n_wells}: {json.dumps(stage_ms)}")

    mask_b = masks
    seeds_b = resweep_seeds(mask_b, 2, config.pair_cap)
    px = mask_b.numel()
    ops_per_px_sweep = 9  # 8 neighbour minimums + 1 background select
    kernels = []
    timed = (
        # name, Pallas body line, kernel, plain version, extra input B/px, seeds
        ("local_cc", 32, lambda: cc_cuda.local_cc(mask_b),
         lambda: cc_cuda.local_cc_plain(mask_b), 0, None),
        ("local_resweep", 69, lambda: cc_cuda.local_resweep(mask_b, seeds_b),
         lambda: cc_cuda.local_resweep_plain(mask_b, seeds_b), 4, seeds_b),
    )
    for name, line, kernel, plain, extra_in, init in timed:
        sweeps = cc_cuda.tile_sweep_counts(mask_b, 2, init)
        ops = float(sweeps.sum()) * cc_cuda.CC_BLOCK**2 * ops_per_px_sweep
        bytes_moved = px * (1 + extra_in + 4)
        bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        bound_ops = ops / NON_TENSOR_OPS_PER_S * 1e3
        if rehearsal:
            ms = plain_ms = time_host(plain, 1, sync)
        else:
            ms = time_cuda(kernel, reps=20)
            plain_ms = time_cuda(plain, reps=3, warmup=1)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": f"arcadia_microscopy_tools_tpu/ops/cc_pallas.py:{line}",
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None,
        })
        say(f"[time] {name}: {ms:.4f} ms at {tuple(mask_b.shape)}; plain {plain_ms:.4f} ms; "
            f"bound {max(bound_bytes, bound_ops):.4f} ms (bytes {bound_bytes:.4f}, "
            f"operations {bound_ops:.4f}: {int(sweeps.sum())} tile sweeps, "
            f"mean {float(sweeps.float().mean()):.1f}, max {int(sweeps.max())})")

    # -- 6. result ------------------------------------------------------------------
    say(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    say(json.dumps({"kernels": kernels}))
    print(smi)
    if rehearsal:
        print("chip_smoke: CPU rehearsal finished; no device result", file=sys.stderr)
        return 3
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
