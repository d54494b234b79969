"""Helpers of the benchmark's CPU tests."""

import copy
import time


def tiny(cell, steps: int = 8, keep_weights: bool = False):
    """A cell cut to a CPU test's size: hidden 32, 2 layers, seeded
    weights (with ``keep_weights`` an npz configuration keeps its weights
    and widths, T = 4), T = steps, a 40-atom pocket or two test pockets,
    a few rows."""
    cell = copy.deepcopy(cell)
    hp = cell.config["hparams"]
    tr = cell.traffic
    if tr["mode"] == "train":
        hp["egnn_params"].update(hidden_nf=32, joint_nf=16, n_layers=2)
        tr["pairs"]["pool"] = 8
        tr["pairs"]["pocket"]["atoms"] = 40
        tr["pairs"]["ligand"]["atoms"] = 8
        tr["rows"] = 4
        tr["trace"]["first_step"] = 1
        tr["check"]["window_groups"] = 2
        tr["check"]["limits"] = {
            k + g: v for g, v in (("loss_gap", 1e-4), ("grad_gap", 1e-4),
                                  ("change_gap", 0.1))
            for k in ("", "window.")}
        return cell
    tr["timesteps"] = steps
    if keep_weights and cell.config["weights"]["kind"] == "npz":
        tr["timesteps"] = 4
    else:
        hp["egnn_params"].update(hidden_nf=32, joint_nf=16, n_layers=2)
        cell.config["weights"] = {"kind": "seeded", "kernel_gain": 0.5,
                                  "out_gain": 0.5, "bias_std": 0.1,
                                  "coord_out_mean": 0.3, "seed": 0}
    hp["diffusion_params"]["diffusion_steps"] = tr["timesteps"]
    if tr["pocket"]["kind"] == "synthetic":
        tr["pocket"]["atoms"] = 40
        tr["per_pocket"] = 4
        tr["ligand"]["atoms"] = 8
    else:
        tr["pocket"]["first"] = 2
        tr["per_pocket"] = 1
    tr["check"]["random_steps"] = 2
    # the limits of this size: a few steps, each a large jump, read their
    # sound gaps up to ~1e-5 here (the cells' own limits are set from
    # readings at T = 500 on the card)
    tr["check"]["limits"] = {"eps_gap": 1e-4, "state_gap": 1e-4}
    return cell


def run_tiny(cell, seconds: float = 2.0, seed: int = 3):
    """One run of the cell on the CPU; a cell that kept its full-width
    weights gets the time a finished batch needs here (~10 s)."""
    from benchmark import harness

    if cell.config["weights"]["kind"] == "npz":
        seconds = max(seconds, 12.0)
    cell.seed, cell.seconds = seed, seconds
    return harness.mode_runner(cell)(cell, "cpu", time.perf_counter())
