"""PyTorch port: the utility subsystem - twins of tests/test_utils.py
(logging configuration, tqdm selection, the stage timer, the warning
classes), plus the torch.profiler trace and, on the card, the timer's wait
for the device."""

import json

import pytest
import torch

from arcadia_microscopy_tools_tpu_torch.utils import configure_logging, get_tqdm
from arcadia_microscopy_tools_tpu_torch.utils.profiling import StageTimer, device_trace


class TestLogging:
    def test_configure_logging_runs(self):
        configure_logging(verbose=True)
        configure_logging(verbose=False)

    def test_get_tqdm_returns_callable(self):
        tqdm = get_tqdm()
        assert callable(tqdm)
        out = list(tqdm(range(3), disable=True)) if tqdm.__name__ != "_fallback_tqdm" else list(
            tqdm(range(3))
        )
        assert out == [0, 1, 2]


class TestStageTimer:
    def test_accumulates(self):
        timer = StageTimer()
        with timer.stage("a"):
            pass
        with timer.stage("a"):
            pass
        with timer.stage("b"):
            pass
        assert timer.counts["a"] == 2
        assert timer.counts["b"] == 1
        assert "a" in timer.report()

    def test_blocking_arg(self):
        """`block` takes a tensor or a nest of them; CPU tensors need no wait."""
        timer = StageTimer()
        x = torch.ones((8, 8))
        with timer.stage("device", block={"y": [x * 2, (x,)], "n": 3}):
            pass
        assert timer.totals["device"] > 0

    def test_stage_is_a_named_profiler_range(self, tmp_path):
        """Each stage is a `user_annotation` of its name in a profiler trace,
        with a zero-length one that carries `args`; totals and counts are
        kept as without a profiler."""
        timer = StageTimer()
        with device_trace(tmp_path):
            with timer.stage("outer"):
                with timer.stage("inner", args="batch 3"):
                    torch.ones((8, 8)).sum()
        events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
        ranges = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
        assert {"outer", "inner", "inner (batch 3)"} <= set(ranges)
        outer, inner, marker = ranges["outer"], ranges["inner"], ranges["inner (batch 3)"]
        assert outer["ts"] <= inner["ts"] <= marker["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
        assert timer.counts == {"outer": 1, "inner": 1}
        assert set(timer.totals) == {"outer", "inner"}
        assert timer.totals["outer"] >= timer.totals["inner"] > 0

    def test_dump(self, tmp_path):
        timer = StageTimer()
        with timer.stage("x"):
            pass
        timer.dump(tmp_path / "t.json")
        assert json.loads((tmp_path / "t.json").read_text())["counts"] == {"x": 1}


class TestWarningsTaxonomy:
    def test_warning_classes(self):
        from arcadia_microscopy_tools_tpu_torch.exceptions import (
            MetadataWarning,
            SegmentationWarning,
        )

        assert issubclass(MetadataWarning, UserWarning)
        assert issubclass(SegmentationWarning, UserWarning)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(tmp_path / "trace"):
        torch.ones((64, 64)).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.gpu
def test_blocking_arg_waits_for_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    timer = StageTimer()
    x = torch.ones((2048, 2048), device="cuda")
    with timer.stage("card", block=[x]):
        for _ in range(20):
            x = x @ x / 2048
    assert torch.cuda.current_stream().query()
