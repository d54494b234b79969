"""Readings for the correctness limits of a cell: the program's compared
numbers over many seeds, and the control's (the reference in the
precision below the configuration's, put in the program's place) on the
first few, all at the cell's own size and in one process.

    python benchmark/calibrate.py --workload <name> --seeds 101-112 \
        --control 3 --seconds 30 [--out readings.jsonl]

Each seed is one run of the cell's window (the same code as
``run.py``); one JSON line per seed, with every check's value.  Not run
by the benchmark's own runs.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

harness.process_settings()


def seeds(text: str):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="first-last")
    p.add_argument("--control", type=int, default=3,
                   help="read the control on this many of the first seeds")
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--out", default=None)
    a = p.parse_args()

    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec(ROOT)
    out = open(a.out, "a") if a.out else None
    t0 = T_PROCESS
    for i, seed in enumerate(seeds(a.seeds)):
        cell = harness.load_cell(a.workload, spec, ROOT)
        cell.seed, cell.seconds = seed, a.seconds
        cell.control = i < a.control
        run = harness.mode_runner(cell)(cell, "cuda", t0)
        line = {"workload": a.workload, "seed": seed,
                "window_s": run.window_s, "setup_s": run.setup_s,
                "work": run.work, "spans": run.spans,
                "checks": {k: v["value"] for k, v in run.checks.items()}}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        t0 = time.perf_counter()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
