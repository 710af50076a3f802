"""Finds everything a cell needs by the names in `BENCHMARK.json`.

- a cell is an entry of `workloads`; its `config` names a configuration
  whose `file` holds the sizes and settings, its `traffic` names
  `benchmark/workloads/<traffic>.json`;
- the traffic's `entry` names `benchmark/entries/<entry>.py`, the
  configuration's `reference` maps each entry to the plain reference of
  what that entry returns, `benchmark/references/<reference>.py`;
- every metric is read by `benchmark/metrics/<metric name>.py`.

So a configuration, a traffic mix, a cell or a metric is added with new
files and new entries in `BENCHMARK.json`, never by editing a file here.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
MANIFEST = REPO / "BENCHMARK.json"


def load(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    known = ", ".join(w["name"] for w in manifest["workloads"])
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")


def config(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((REPO / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = HERE) -> dict:
    return json.loads((root / "workloads" / f"{name}.json").read_text())


def metrics(manifest: dict, cell_name: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics that the cell reports: those
    that list it under `workloads`, or list no cells at all."""
    return [m for m in manifest[kind] if cell_name in m.get("workloads", [cell_name])]


def load_module(kind: str, name: str, root: Path = HERE) -> ModuleType:
    """`benchmark/<kind>/<name>.py` as a module (a metric's file name may
    hold dots, so it is loaded by path, not imported by name)."""
    path = root / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing: BENCHMARK.json names {kind[:-1]} {name!r}")
    key = f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module
