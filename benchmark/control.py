"""The readings that a cell's limits are set from, on the card:

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--program]
        [--controls forward,measure]

For each seed it makes the cell's inputs, computes the plain reference, and
prints one JSON line with the compared numbers of each control (the
reference with one stage computed one precision step below what the
configuration states, put in the program's place: the reference module's
`CONTROLS` by default, any of its `LOWERED` by `--controls`) and, with
`--program`, of the program's timed entry run over the same inputs until
it has answered for every well of the pool. Beside each control's and the
program's numbers, `correct` is what the harness's own comparison makes of
them. The program's readings over a dozen seeds give each limit its lower
end, the controls' its upper end. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def readings(cell_name: str, seed: int, program: bool, device, traffic: dict | None = None,
             controls: list[str] | None = None) -> dict:
    from benchmark import harness, manifest
    from benchmark import traffic as gen

    bench = manifest.load()
    cell = manifest.cell(bench, cell_name)
    config = manifest.config(bench, cell["config"])
    traffic = traffic or manifest.traffic(cell["traffic"])
    limits = config["limits"][traffic["entry"]]
    ref = manifest.load_module("references", config["reference"][traffic["entry"]])
    pool = gen.make_pool(traffic, seed, device)
    out = {"workload": cell_name, "seed": seed}
    if program:
        entry_mod = manifest.load_module("entries", traffic["entry"])
        with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
            entry = entry_mod.Entry(config, traffic, pool, device, Path(tmp))
            for _ in range(len(pool)):  # until every pool well has been answered
                entry.step()
                if len({k for k, _ in entry.outputs()}) == len(pool):
                    break
            outputs = entry.outputs()
            entry.close()
    refs = ref.reference_outputs(pool, config, device)
    if program:
        out["program"] = ref.compare(outputs, refs, pool, config, device)
        out["program"]["correct"] = harness.judge(out["program"], limits)
    out["control"] = {}
    for name in controls or list(ref.CONTROLS):
        numbers = ref.compare(ref.control_outputs(pool, config, device, name), refs, pool,
                              config, device)
        out["control"][name] = {**numbers, "correct": harness.judge(numbers, limits)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--controls", default="", help="comma-separated; all by default")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    controls = [c for c in args.controls.split(",") if c] or None
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.program, torch.device("cuda", 0),
                                  controls=controls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
