"""Readings for the limits of a cell's comparison, on the card:

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3 [--precision tf32]

For each seed it puts the reference, computed in ``--precision`` (the
control: one precision below the configuration's), in the program's place
at the cell's own size, and prints the numbers the cell's comparison gives
it, one JSON line a seed.  With ``--program-seconds S`` it also runs the
cell itself for a window of ``S`` seconds on each seed and prints the
program's numbers beside them: the lower and the upper readings that a
limit is set between.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_port import harness, session  # noqa: E402


def control_checks(cell_name: str, seed: int, precision: str, device: str = "cuda",
                   bench: dict | None = None) -> dict:
    """The cell's compared numbers for the reference in ``precision`` put in
    the program's place, on one rank."""
    import torch
    cell = harness.find_cell(cell_name, bench)
    dev = torch.device(device)
    run = session.Run(cell=cell, seed=seed, seconds=0.0, trace=False, device=dev, rank=0,
                      world=1, t_start=time.monotonic())
    loop = harness.load_module("loops", cell.loop)
    answers, matvecs = loop.reference_answers(run, precision)
    return loop.compare(run, answers, matvecs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precision", default="tf32")
    ap.add_argument("--program-seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds:
        row = {"workload": args.workload, "seed": seed}
        if args.program_seconds > 0:
            line, _ = session.run_cell(args.workload, seed, args.program_seconds, False)
            row["program"] = {k: v["value"] for k, v in json.loads(line)["checks"].items()}
        t0 = time.perf_counter()
        checks = control_checks(args.workload, seed, args.precision)
        row[args.precision] = {k: v["value"] for k, v in checks.items()}
        row["control_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
