"""Time the branches of the rank-selection kernel against each other.

`csrc/rank_select.cu` picks its branch by window: a sliding selection over a
4096-key sort of each tile up to window 35, over an 8192-key sort up to
window 74, then the bisection. This script builds the kernel once per
branch with -DAMT_RANK_BRANCH=<n>, which forces that branch, and at each
window of `WINDOWS` times every build that can serve it on the timelapse
configuration's 8 x 2048^2 float32 frames (one batched launch, rank
window^2 // 2) by CUDA events, after checking that its output equals the
shipped build's bit for bit (int32 views). On one CUDA card:

    python3 tools/rank_branch_times.py

It needs nvcc; the builds go to build/rank_branches/.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BRANCHES = {0: "slide-4096", 1: "slide-8192", 2: "bisect-staged"}
# window -> the branches that can serve it (a sliding tile must hold 4 rows)
WINDOWS = {21: (0, 1, 2), 33: (0, 1), 34: (0, 1), 35: (0, 1), 36: (0, 1), 37: (0, 1), 38: (0, 1),
           40: (0, 1), 48: (0, 1, 2), 74: (1, 2)}


def build(out: Path) -> dict[int, ctypes.CDLL]:
    """One nvcc per forced branch, all started together; the loaded builds."""
    from arcadia_microscopy_tools_tpu_torch import _build

    out.mkdir(parents=True, exist_ok=True)
    src = _build._CSRC / "rank_select.cu"
    procs = {
        b: subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DAMT_RANK_BRANCH={b}", "-o",
             str(out / f"branch{b}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for b in BRANCHES
    }
    libs = {}
    for b, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for branch {BRANCHES[b]}:\n{log}")
        libs[b] = ctypes.CDLL(str(out / f"branch{b}.so"))
    return libs


def main() -> int:
    import torch

    import chip_smoke
    from arcadia_microscopy_tools_tpu_torch import testing
    from arcadia_microscopy_tools_tpu_torch.ops import rank_cuda

    if not torch.cuda.is_available():
        print("rank_branch_times: no CUDA device", file=sys.stderr)
        return 1
    shipped = rank_cuda._library()
    libs = build(ROOT / "build" / "rank_branches")
    for lib in libs.values():  # the shipped build's C signature
        lib.amt_rank_select.argtypes = shipped.amt_rank_select.argtypes
        lib.amt_rank_select.restype = shipped.amt_rank_select.restype
    print(chip_smoke.nvidia_smi_line(), flush=True)
    frames = testing.synthetic_timelapse(8, 2048, 120, seed=0)
    x = torch.from_numpy(frames).cuda().to(torch.float32)
    try:
        for window, branches in WINDOWS.items():
            ks = (window * window // 2,)
            rank_cuda._library = lambda: shipped
            want = rank_cuda.rank_select(x, window, ks).view(torch.int32)
            row = []
            for b in branches:
                rank_cuda._library = lambda lib=libs[b]: lib
                got = rank_cuda.rank_select(x, window, ks).view(torch.int32)
                if not torch.equal(got, want):
                    raise RuntimeError(f"{BRANCHES[b]} differs from the shipped build at window {window}")
                slow = b == 2 and window > 21
                ms = chip_smoke.time_cuda(lambda: rank_cuda.rank_select(x, window, ks),
                                          reps=1 if slow else 5, warmup=1)
                row.append(f"{BRANCHES[b]} {ms:.4f} ms")
            print(f"window {window}, {tuple(x.shape)}, rank {ks[0]}: " + ", ".join(row), flush=True)
    finally:
        rank_cuda._library = lambda: shipped
    return 0


if __name__ == "__main__":
    sys.exit(main())
