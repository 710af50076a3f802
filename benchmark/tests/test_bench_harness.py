"""The harness: found by name from files alone, free of JAX, and refusing
to run without a CUDA card."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, manifest

from conftest import REPO, tiny_traffic


def test_new_config_traffic_and_metric_are_new_files_only(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files under a copy of the benchmark folder, with new manifest entries,
    run without an edit to any file already there."""
    root = tmp_path / "benchmark"
    shutil.copytree(REPO / "benchmark", root, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((root / "configs" / "classical_otsu.json").read_text())
    cfg.update(name="classical_li_like", source="a test")
    cfg["plate"]["min_size"] = 20
    (root / "configs" / "classical_min20.json").write_text(json.dumps(cfg))
    traffic = tiny_traffic("plate_mem")
    (root / "workloads" / "plate_tiny.json").write_text(json.dumps(traffic))
    (root / "metrics" / "plates_run.test.py").write_text(
        "def read(run):\n    return run.attempted / 16\n")
    bench = manifest.load()
    bench["configs"].append({"name": "classical_li_like", "source": "a test",
                             "file": str(root / "configs" / "classical_min20.json"),
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_cell", "config": "classical_li_like",
                               "traffic": "plate_tiny", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "plates_run.test", "unit": "plates", "better": "higher",
                               "source": "program_counter", "layer": "host runner",
                               "moves": "setup_s", "workloads": ["tiny_cell"]})
    line = harness.run_cell("tiny_cell", 3, 0.0, True, torch.device("cpu"), time.perf_counter(),
                            bench=bench, root=root)
    assert line["correct"], line["checks"]
    assert line["metrics"]["plates_run.test"]["value"] == 1.0


RUN_IMPORTS = """
import sys
sys.path.insert(0, {repo!r})
from benchmark import control, harness, manifest
b = manifest.load()
for w in b["workloads"]:
    entry = manifest.traffic(w["traffic"])["entry"]
    manifest.load_module("entries", entry)
    manifest.load_module("references", manifest.config(b, w["config"])["reference"][entry])
for m in b["end_to_end"] + b["per_layer"]:
    manifest.load_module("metrics", m["name"])
import arcadia_microscopy_tools_tpu_torch.parallel.plate
import arcadia_microscopy_tools_tpu_torch.io.nikon
import arcadia_microscopy_tools_tpu_torch.models.segmentation
print("forbidden:" + ",".join(harness.forbidden_modules()))
"""


def test_harness_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", RUN_IMPORTS.format(repo=str(REPO))],
                         capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "forbidden:"


def test_references_import_nothing_of_the_program():
    for path in (REPO / "benchmark" / "references").glob("*.py"):
        assert "arcadia_microscopy_tools_tpu" not in path.read_text(), path


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "arcadia_microscopy_tools_tpu_torch_x", sys)
    assert "arcadia_microscopy_tools_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "arcadia_microscopy_tools_tpu.ops", sys)
    assert harness.forbidden_modules() == ["arcadia_microscopy_tools_tpu"]


def test_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, str(REPO / "benchmark" / "run.py"), "--workload",
                          "classical_plate_mem", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load()["workloads"]])
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, str(REPO / "benchmark" / "run.py"), "--workload", cell,
                          "--seed", "2147483700", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["metrics"]


def test_device_trace_reduction():
    from benchmark import devtrace

    events = [{"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0, "dur": 100},
              {"ph": "X", "cat": "cpu_op", "name": "inner", "ts": 10, "dur": 20},
              {"ph": "X", "cat": "kernel", "name": "k1", "ts": 40, "dur": 10},
              {"ph": "X", "cat": "kernel", "name": "k2", "ts": 45, "dur": 10},
              {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 70, "dur": 5}]
    t = devtrace.reduce_events(events, 1e-4)
    assert abs(t.busy_s - 20e-6) < 1e-12  # the union of the overlapping kernels and the copy
    assert abs(t.op_seconds([r"^k"]) - 20e-6) < 1e-12
    # idle before the first kernel is inside `inner`; the rest inside `outer` only
    assert abs(t.gaps["inner"] - 40e-6) < 1e-12 and abs(t.gaps["outer"] - 40e-6) < 1e-12
    assert t.breakdown()["device_ops"][0][0] in ("k1", "k2")
