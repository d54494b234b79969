"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared beside its
limit), and the last lines of standard error repeat the checks.  Exits
non-zero without a result when no CUDA card is present, when the cell
asks for more cards than there are, or when JAX, flax or the JAX package
were loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

harness.process_settings()


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args()

    import torch

    torch.set_num_threads(1)

    spec = harness.load_spec(ROOT)
    cell = harness.load_cell(a.workload, spec, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    cell.seed, cell.seconds, cell.trace = a.seed, a.seconds, bool(a.trace)
    print(f"[card] {card_line()}; host cores {os.cpu_count()}",
          file=sys.stderr)
    run = harness.mode_runner(cell)(cell, "cuda", T_PROCESS)
    run.device_kind = torch.cuda.get_device_name(0)
    run.device_count = cell.chips
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    correct = all(c["value"] <= c["limit"] for k, c in run.checks.items())
    line = harness.result(run, spec, correct)
    for name, c in run.checks.items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
