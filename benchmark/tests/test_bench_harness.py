"""The harness on the CPU: each cell's path at a tiny size, the result
line's keys, cells, configurations and metrics found by name, the import
rule, and the reduction of a trace."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_util import run_tiny, tiny
from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
CELLS = ("cd_sample_b100", "v3b_sweep_b160")
FORBIDDEN = {"jax", "jaxlib", "flax", "diffndm_tpu"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_prints_the_contract_keys(spec, name):
    from benchmark import harness

    cell = tiny(harness.load_cell(name, spec, ROOT), keep_weights=True)
    run = run_tiny(cell, seconds=3.0)
    assert run.window_s >= cell.seconds
    assert run.work["ligands"] > 0
    assert set(run.checks) == {"eps_gap", "state_gap"}
    correct = all(c["value"] <= c["limit"] for c in run.checks.values())
    line = json.loads(json.dumps(harness.result(run, spec, correct)))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    rate = "ligands_per_s" if name == "cd_sample_b100" else \
        "sweep_ligands_per_s"
    assert set(line["metrics"]) == {rate, "setup_s"}
    assert line["metrics"][rate]["unit"] == "ligands/s"
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}


def test_training_cell_runs_and_prints_the_contract_keys(spec):
    from benchmark import harness

    cell = tiny(harness.load_cell("cd_train_b16", spec, ROOT))
    run = run_tiny(cell, seconds=1.0)
    assert run.work["samples"] > 0
    assert set(run.checks) == {p + k for p in ("", "window.")
                               for k in ("loss_gap", "grad_gap",
                                         "change_gap")}
    correct = all(c["value"] <= c["limit"] for c in run.checks.values())
    line = json.loads(json.dumps(harness.result(run, spec, correct)))
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}


def test_spec_names_files_that_exist(spec):
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in spec["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
    for m in spec["per_layer"]:
        moved = next(e for e in spec["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved["workloads"])


def test_new_cell_config_and_metric_are_found_by_name(spec, tmp_path):
    """Files dropped into a copy of the benchmark, and entries appended to
    its BENCHMARK.json, are picked up with no existing file edited."""
    from benchmark import harness

    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    new = json.loads(json.dumps(spec))
    cfg = json.loads((root / "benchmark/configs/crossdock_fullatom_cond.json"
                      ).read_text())
    cfg["hparams"]["egnn_params"]["n_layers"] = 3
    (root / "benchmark/configs/crossdock_three_layers.json").write_text(
        json.dumps(cfg))
    mix = json.loads((root / "benchmark/traffic/synthetic320_b100.json"
                      ).read_text())
    mix["per_pocket"] = 3
    (root / "benchmark/traffic/synthetic320_b3.json").write_text(
        json.dumps(mix))
    (root / "benchmark/metrics/ligands_in_window.py").write_text(
        "def read(run):\n    return run.work['ligands']\n")
    new["configs"].append(dict(new["configs"][0],
                               name="crossdock_three_layers",
                               file="benchmark/configs/"
                                    "crossdock_three_layers.json"))
    new["workloads"].append(dict(new["workloads"][0], name="cd_three_b3",
                                 config="crossdock_three_layers",
                                 traffic="synthetic320_b3"))
    new["end_to_end"][0]["workloads"].append("cd_three_b3")
    new["per_layer"].append(dict(new["per_layer"][0],
                                 name="ligands_in_window",
                                 workloads=["cd_three_b3"]))
    (root / "BENCHMARK.json").write_text(json.dumps(new))

    spec2 = harness.load_spec(str(root))
    cell = harness.load_cell("cd_three_b3", spec2, str(root))
    assert cell.config["hparams"]["egnn_params"]["n_layers"] == 3
    assert cell.traffic["per_pocket"] == 3
    names = [m["name"] for m in harness.metrics_of("cd_three_b3", spec2,
                                                   True)]
    assert "ligands_in_window" in names
    run = harness.Run(cell=cell, work={"ligands": 7.0})
    assert harness.reader("ligands_in_window", str(root))(run) == 7.0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(folder):
    for base, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        found = set(_top_level_imports(path)) & FORBIDDEN
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_program():
    """The reference imports PyTorch, NumPy and itself, nothing else of
    the benchmark and nothing of the program."""
    for path in _sources(os.path.join(BENCH, "reference")):
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top in {"__future__", "typing", "math", "numpy",
                               "torch"} or name.startswith(
                    "benchmark.reference"), (path, name)


def test_a_run_loads_no_jax(tmp_path):
    """A tiny cell in a fresh process: no module of JAX, flax or the JAX
    package is loaded when the window has closed."""
    code = (
        "import sys, time; sys.path.insert(0, %r); "
        "sys.path.insert(0, %r); "
        "from benchmark import harness; from bench_util import tiny; "
        "spec = harness.load_spec(%r); "
        "cell = tiny(harness.load_cell('cd_sample_b100', spec, %r)); "
        "cell.seconds = 1.0; "
        "harness.mode_runner(cell)(cell, 'cpu', time.perf_counter()); "
        "print(harness.forbidden_modules())"
        % (ROOT, os.path.join(BENCH, "tests"), ROOT, ROOT))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST", "JAX"))}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_exits_nonzero_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "cd_sample_b100", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_trace_summary_reduces_a_chrome_trace():
    from benchmark.trace import BEGIN, END, Summary

    def x(name, cat, ts, dur, tid=1):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "tid": tid}

    events = [
        x(BEGIN, "user_annotation", 0.0, 0.0),
        x("aten::mm", "cpu_op", 1.0, 30.0),
        x("cudaLaunchKernel", "cuda_runtime", 2.0, 3.0),
        x("void edge_chain_mma<256, false>(EdgeArgs)", "kernel", 10.0, 40.0,
          tid=7),
        x("aten::cat", "cpu_op", 55.0, 20.0),
        x("cudaLaunchKernel", "cuda_runtime", 60.0, 3.0),
        x("cudaGraphLaunch", "cuda_runtime", 64.0, 3.0),
        x("void edge_chain_bwd_mma<256, false>(Args)", "kernel", 70.0, 20.0,
          tid=7),
        x("Memcpy DtoH", "gpu_memcpy", 85.0, 10.0, tid=7),
        x(END, "user_annotation", 100.0, 0.0),
    ]
    s = Summary(events)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(65e-6)       # 10-50 and 70-95
    assert s.launches() == 3
    assert s.kernel_seconds(r"\bedge_chain_(mma|wgmma)\b") == \
        pytest.approx(40e-6)
    assert s.kernel_seconds(r"\bedge_chain_bwd_") == pytest.approx(20e-6)
    gaps = dict(s.idle_gaps())
    assert gaps["aten::cat"] == pytest.approx(20e-6)     # 50-70
    assert gaps["(no host op)"] == pytest.approx(5e-6)   # 95-100
    assert gaps["aten::mm"] == pytest.approx(10e-6)      # 0-10 (from 1)
    assert s.device_ops()[0][0].startswith("void edge_chain_mma")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    """One short run of the cell through ``run.py`` on the card."""
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", name,
         "--seed", "7", "--seconds", "10", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
