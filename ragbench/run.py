"""Run one cell of the benchmark on the card and print its result line.

    python3 ragbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``workloads/<cell>.json``) names its configuration
(``configs/<name>.json``) and its traffic (``traffic/<name>.json``); the
metrics are BENCHMARK.json's: ``end_to_end`` with ``--trace 0``,
``per_layer`` with ``--trace 1``, each read by ``metrics/<name>.py``.  The
last line of standard output is the result's JSON; the numbers compared for
``correct`` end standard error and the result line.  Without a CUDA card,
or without the port's sources beside the benchmark, it exits non-zero and
prints no result.

Options past the driver's, for defining the cell: ``--rate`` offers another
rate than the cell's (the knee sweep), ``--control`` also reads the float8
control on the run's sample.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "repro")


def fail(msg: str, code: int = 2):
    print(f"[ragbench] {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
        return out.splitlines()[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


def prepare(workload: str):
    """Point the caches into the checkout, find the program beside the
    benchmark and a card for the cell, and load the cell's files."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    # one process with few threads: the runtime's loop is one host thread,
    # and idle BLAS / OpenMP workers spinning beside it slow it unevenly
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "4"
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        fail(f"the program (src/repro_torch) is not beside the benchmark "
             f"in {ROOT}")
    sys.path[:0] = [str(src), str(ROOT)]
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        fail(f"no cell {workload!r} in BENCHMARK.json")
    w = cells[workload]

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card: the benchmark does not run on the CPU")
    if torch.cuda.device_count() < w["chips"]:
        fail(f"the cell needs {w['chips']} cards, "
             f"{torch.cuda.device_count()} visible")
    import repro_torch
    if Path(repro_torch.__file__).resolve().parent != src / "repro_torch":
        fail(f"repro_torch loaded from {repro_torch.__file__}")
    from ragbench import harness

    cell = harness.load("workloads", workload)
    config = harness.load("configs", w["config"])
    traffic = harness.load("traffic", w["traffic"])
    if cell["config"] != w["config"] or cell["traffic"] != w["traffic"]:
        fail(f"{workload}: the cell's file disagrees with BENCHMARK.json")
    return bench, w, cell, config, traffic


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()

    bench, w, cell, config, traffic = prepare(args.workload)
    import torch
    from ragbench import check, harness

    res = harness.run_cell(cell, config, traffic, seed=args.seed,
                           seconds=args.seconds, trace=bool(args.trace),
                           t_start=T0, rate=args.rate, control=args.control)
    kind = "per_layer" if args.trace else "end_to_end"
    names = [m for m in bench[kind]
             if args.workload in m.get("workloads", [args.workload])]
    card = power_limit()
    metrics = harness.metrics_line(res, names, harness.readers())
    found = banned_modules()
    if found:
        fail(f"loaded in this process: {', '.join(found)}")
    n = len(res.run.requests)
    failed = sum(1 for r in res.run.requests if not r.finished)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": w["chips"], "memory_peak_bytes": res.memory_peak,
              "card": card}
    line = {"correct": check.correct(res.checks) and failed == 0,
            "attempted": n, "failed": failed, "metrics": metrics,
            "device": device}
    t = res.run.trace
    if args.trace and t:
        device["busy_s"], device["window_s"] = t["busy_s"], t["window_s"]
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    info = {"rate": args.rate or cell["rate"], "n_blocks": res.n_blocks,
            "warmup_requests": res.n_warmup,
            "open_at_half": res.extra["open_half"],
            "open_at_close": res.extra["open_close"],
            "sample": res.extra["sample"],
            "stages": res.run.spans.get("stages"),
            "decode_batch": res.extra["summary"]["mean_decode_batch"],
            "sweep": res.extra["sweep"], "ttft_ms": res.extra["ttft_ms"],
            "tpot_ms": res.extra["tpot_ms"]}
    if t:
        info["trace"] = {k: t[k] for k in ("window_s", "busy_s", "device_s",
                                           "expert_s", "kernel_s", "bound_s")}
    if res.control is not None:
        info["control"] = res.control
    print("[ragbench] " + json.dumps(info), file=sys.stderr, flush=True)
    for name, c in res.checks.items():
        print(f"[ragbench] check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    line["checks"] = res.checks
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
