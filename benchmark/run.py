"""Run one benchmark cell on the CUDA card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` a
`breakdown`, and last the compared numbers beside their limits under
`checks`); the compared numbers are also the last lines of standard error.
Exits non-zero, printing no result, without a CUDA card, with fewer cards
than the cell asks for, or when JAX or the JAX package was loaded.
Before anything large is allocated it sets glibc's malloc to keep freed
memory in the process (`_keep_freed_memory`).
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# glibc's mallopt parameters
M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4


def _keep_freed_memory() -> None:
    """Have glibc's malloc keep the memory the process frees for its next
    allocations, as MALLOC_MMAP_MAX_=0 and a large MALLOC_TRIM_THRESHOLD_
    would: no block gets a mapping of its own, and the heap is never given
    back. The runner stages every batch in a fresh array of hundreds of
    MiB; by default each is mapped, faulted in page by page and unmapped
    again, a cost that swings from run to run with the host. Set before
    anything large is allocated, and on glibc only."""
    libc = ctypes.CDLL(None)
    if not (libc.mallopt(M_MMAP_MAX, 0) == 1 and libc.mallopt(M_TRIM_THRESHOLD, 2**31 - 1) == 1):
        raise OSError("mallopt refused the benchmark's allocator settings")


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    _keep_freed_memory()

    import torch

    from benchmark import harness, manifest

    cell = manifest.cell(manifest.load(), args.workload)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device is available; the benchmark measures the card only "
              "and does not fall back to the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell {args.workload} needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} are visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                            STARTED)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; the benchmark measures the "
              "PyTorch port alone", file=sys.stderr)
        return 3
    line["device"]["power_limit"] = _power_limit()
    checks = line.pop("checks")
    line["checks"] = checks  # the compared numbers come last in the line
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
