"""The harness: finds a cell, its configuration, its traffic and its
metrics by name, runs the cell's mode, and assembles the result line.

- ``BENCHMARK.json`` at the checkout's root names each cell's
  configuration and traffic, and every metric;
- ``benchmark/configs/<config>.json`` holds a configuration's sizes (its
  ``hparams`` are the keys of the reference YAML) and its weights;
- ``benchmark/traffic/<traffic>.json`` holds a traffic mix's parameters,
  whose ``mode`` names the module under ``benchmark/`` that runs it;
- ``benchmark/metrics/<metric>.py`` is the reader of one metric: a
  ``read(run)`` that returns its value from the run's record, or None
  where it finds nothing to read.

A cell, configuration, traffic mix or metric is added by adding its
file and its entry, never by editing another.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# modules that may not be loaded in the process that prints a result,
# compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "diffndm_tpu")


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    # also read the correctness control's numbers (calibrate.py)
    control: bool = False
    root: str = ROOT


@dataclass
class Run:
    """What a run hands its metric readers.  Times in seconds."""
    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    work: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    # the traced sub-window (trace.Summary) and what it covered
    trace: Optional[object] = None
    traced_steps: int = 0
    fwd_least_s: Optional[float] = None
    bwd_least_s: Optional[float] = None
    # the untraced part of a traced run: model FLOPs and host clock
    untraced_flops: float = 0.0
    untraced_s: float = 0.0
    peak_flops: Optional[float] = None
    spans: Dict[str, float] = field(default_factory=dict)
    checks: Dict[str, dict] = field(default_factory=dict)
    memory_peak_bytes: int = 0
    device_kind: str = ""
    device_count: int = 1


def process_settings() -> None:
    """Before torch is imported: every build and kernel cache at a fixed
    path inside the checkout (the kernels' own ``build/`` is there
    already); one host thread for the CPU's math libraries, as the loop is
    the caller's one thread and idle workers that spin would take its
    cores; no JAX behind a library that could load it."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(ROOT, "build", "benchmark", sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, spec: dict, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``spec`` with its configuration and traffic
    files, read from the ``benchmark/`` folder under ``root``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    here = os.path.join(root, "benchmark")
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                chips=int(w["chips"]),
                config=_json(os.path.join(here, "configs",
                                          w["config"] + ".json")),
                traffic=_json(os.path.join(here, "traffic",
                                           w["traffic"] + ".json")),
                root=root)


def mode_runner(cell: Cell) -> Callable:
    """The ``run(cell, device)`` of the traffic's mode."""
    return importlib.import_module(f"benchmark.{cell.traffic['mode']}").run


def reader(metric: str, root: str = ROOT) -> Callable:
    """The ``read`` of ``benchmark/metrics/<metric>.py`` under ``root``."""
    path = os.path.join(root, "benchmark", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(cell_name: str, spec: dict, trace: bool) -> List[dict]:
    """The end-to-end metrics a cell reports (``trace`` False), or its
    per-layer metrics (True): those that list the cell, or, without a
    list, every cell that reports the end-to-end metric they move."""
    e2e = [m for m in spec["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def result(run: Run, spec: dict, correct: bool) -> dict:
    """The result line's object; the checks come last."""
    metrics = {}
    for m in metrics_of(run.cell.name, spec, run.cell.trace):
        value = reader(m["name"], run.cell.root)(run)
        if value is None:
            if not run.cell.trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   f"nothing")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": run.device_kind,
              "count": run.device_count,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": bool(correct), "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    if run.cell.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = run.checks
    return out


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))
