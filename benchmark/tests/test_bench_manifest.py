"""BENCHMARK.json against the contract it is held to, and every file it
names present."""

import json
import re

from benchmark import arithmetic, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def bench():
    return manifest.load()


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == KEYS
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128


def test_names_units_and_entry_keys():
    b = bench()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names)), group
        for n in names:
            assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for cell in cells:
        e2e = {m["name"] for m in manifest.metrics(b, cell, "end_to_end")}
        per = manifest.metrics(b, cell, "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and per, cell
        for m in per:  # each per-layer metric moves an end-to-end metric its cells report
            assert m["moves"] in e2e, (cell, m["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_four_chip_cells_are_few():
    cells = bench()["workloads"]
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)


def test_every_named_file_exists():
    b = bench()
    for c in b["configs"]:
        assert manifest.config(b, c["name"])["name"] == c["name"]
    for w in b["workloads"]:
        entry = manifest.traffic(w["traffic"])["entry"]
        manifest.load_module("entries", entry)
        manifest.load_module("references", manifest.config(b, w["config"])["reference"][entry])
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(manifest.load_module("metrics", m["name"]).read)


def test_flop_count_and_conv_bound():
    # 17 3x3 convs at 2 * 9 * C * Co * H * W: ~1.36e12 per 2048^2 image, 432 GF
    # on the way down and 928 GF on the way up; the seven block projections
    # and the head at 2 * C * Co * H * W add 91.8 GF, ~1.452e12 in all
    convs = arithmetic.unet_forward_shapes(2048, 2048)
    assert len(convs) == 17
    down = sum(2 * 9 * c * co * h * w for n, c, co, h, w in convs if n.startswith("down"))
    up = sum(2 * 9 * c * co * h * w for n, c, co, h, w in convs if n.startswith("up"))
    assert abs(down / 1e9 - 432.45) < 0.01 and abs(up / 1e9 - 927.71) < 0.01
    projections = arithmetic.unet_forward_projections(2048, 2048)
    assert len(projections) == 8
    proj = sum(2 * c * co * h * w for _, c, co, h, w in projections)
    assert abs(proj / 1e9 - 91.80) < 0.01
    assert abs(arithmetic.unet_forward_flop(2048, 2048) / 1e12 - 1.45197) < 1e-5
    # chip_smoke.py's bound of the 16 conv kernel calls at 8 x 2048^2: 14.763 ms
    assert len(arithmetic.conv3x3_calls(8, 2048)) == 16
    assert abs(arithmetic.conv3x3_bound_s(8, 2048) * 1e3 - 14.763) < 0.001
