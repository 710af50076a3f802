"""Shared settings of the benchmark's CPU tests: tiny traffic, so that a
whole run (set-up, window, reference, comparison) takes seconds on the CPU
with the kernels' plain versions."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def tiny_traffic(name: str, size: int = 128, blobs: int = 6, pool: int = 3) -> dict:
    from benchmark import manifest

    t = manifest.traffic(name)
    # two batches of 8 that hold different wells, and halves that differ
    t.update(plate_rows=2, plate_cols=8, pool_wells=pool)
    t["well"].update(height=size, width=size, blobs=blobs)
    return t


def with_held(bench: dict) -> dict:
    """BENCHMARK.json with the entries of the cells held out of it
    (`benchmark/held/*.json`) added, so that their paths stay tested."""
    import json

    out = {k: list(v) if isinstance(v, list) else v for k, v in bench.items()}
    for path in sorted((REPO / "benchmark" / "held").glob("*.json")):
        held = json.loads(path.read_text())
        for key in ("workloads", "end_to_end", "per_layer"):
            out[key] += held.get(key, [])
    return out
