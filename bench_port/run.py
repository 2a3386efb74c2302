"""The benchmark's one command:

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``lightkrylov_tpu_torch``)
beside ``BENCHMARK.json`` and ``bench_port/``.  It prints the result as the
last line of standard output and the compared numbers with their limits as
the last lines of standard error; with no CUDA device, too few of them, a
missing file or JAX loaded it prints no result and exits 2.
"""

import argparse
import sys
import time
from pathlib import Path

T_MONOTONIC = time.monotonic()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_port import session  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def go():
        line, checks = session.run_cell(args.workload, args.seed, args.seconds,
                                        bool(args.trace))
        print(checks, file=sys.stderr, flush=True)
        print(line, flush=True)
        return 0

    return session.main_exit(go)


if __name__ == "__main__":
    sys.exit(main())
