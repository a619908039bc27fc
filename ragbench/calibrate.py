"""The readings that the limits of ``correct`` are set from, many seeds in
one process (the set-up of the imports and the kernels' load paid once).

    python3 ragbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--rate r]

For each seed, one run of the cell at its own size and load with a short
window, then the check: the program's numbers, and the float8 control's on
the same sample.  One JSON line a seed.  It decides nothing; PERF.md gives
the readings and the limits set from them.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ragbench.run import prepare  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rate", type=float, default=None)
    args = ap.parse_args()
    _, _, cell, config, traffic = prepare(args.workload)
    from ragbench import check, harness
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run_cell(cell, config, traffic, seed=seed,
                               seconds=args.seconds, trace=False,
                               t_start=t0, rate=args.rate, control=True)
        print(json.dumps({
            "seed": seed, "correct": check.correct(res.checks),
            "program": {n: c["value"] for n, c in res.checks.items()},
            "control": res.control, "sample": res.extra["sample"],
            "setup_s": res.run.setup_s,
            "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
