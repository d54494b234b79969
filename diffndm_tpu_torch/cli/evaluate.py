"""Evaluate generated SDF files: per-file and aggregate QED / SA / LogP /
Lipinski and the valid ratio (the reference's my_new_evaluate.py and,
with ``--per_step``, my_new_evaluate_with_step.py).

Example:
    python -m diffndm_tpu_torch.cli.evaluate sweep_out/ \
        --expected_per_file 16 --out report.txt

The report is the JAX package's, line for line.  ``--receptor R``
appends the mean Vina-style affinity of each file's molecules against R
(`` Vina~=``, chem/scoring.py); with ``--dock``, the mean best affinity
of a batched pose search per molecule (`` dock~=``, chem/dock.py) on
``--device`` (default cuda; the other modes never touch a device).
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("sdf_dir", type=str,
                   help="directory of SDF files (or a single file)")
    p.add_argument("--expected_per_file", type=int, default=20)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--receptor", type=str, default=None,
                   help="receptor PDB: append a native Vina-style "
                        "affinity estimate per file (chem/scoring.py)")
    p.add_argument("--dock", action="store_true",
                   help="with --receptor: run the batched pose search "
                        "(chem/dock.py) instead of rescoring the pose "
                        "as it is; reports the mean best docked affinity "
                        "per file")
    p.add_argument("--dock_restarts", type=int, default=64,
                   help="parallel restarts per molecule for --dock")
    p.add_argument("--per_step", action="store_true",
                   help="group files by the trailing step number in their "
                        "names (e.g. try_100.sdf) and report per-step "
                        "aggregates, sorted by step")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the --dock pose search")
    return p


def check_sdf_file(path: str, props):
    """(qed, sa, logp, lipinski, valid) per record of the file; zeros for
    a record that does not sanitize."""
    from diffndm_tpu_torch.chem.io import read_sdf
    from diffndm_tpu_torch.chem.sanitize import SanitizeError, sanitize

    rows = []
    for mol in read_sdf(path):
        try:
            sanitize(mol)
            rows.append((props.calculate_qed(mol), props.calculate_sa(mol),
                         props.calculate_logp(mol),
                         props.calculate_lipinski(mol), 1))
        except SanitizeError:
            rows.append((0.0, 0.0, 0.0, 0, 0))
    return rows


def per_step_report(paths, props) -> str:
    by_step = {}
    for path in paths:
        m = re.search(r"(\d+)\.sdf$", os.path.basename(path))
        if m:
            by_step.setdefault(int(m.group(1)), []).append(path)
    lines = []
    for step in sorted(by_step):
        rows = [r for path in by_step[step]
                for r in check_sdf_file(path, props) if r[4]]
        if not rows:
            lines.append(f"step {step}: no valid molecules")
            continue
        arr = np.array(rows, dtype=float)
        lines.append(
            f"step {step}: QED: {arr[:, 0].mean():.3f} +/- "
            f"{arr[:, 0].std():.2f}, SA: {arr[:, 1].mean():.3f} +/- "
            f"{arr[:, 1].std():.2f}, LogP: {arr[:, 2].mean():.3f} +/- "
            f"{arr[:, 2].std():.2f}, Lipinski: "
            f"{arr[:, 3].mean():.3f} +/- {arr[:, 3].std():.2f} "
            f"n: {len(rows)}")
    return "\n".join(lines)


def affinity_suffix(path: str, scorer, dock: bool, restarts: int,
                    device) -> str:
    """`` Vina~=m`` (rescoring) or `` dock~=m`` (pose search) over the
    file's molecules, or "" when there is none.  A molecule the search
    rejects (ValueError) skips the file with a message; any other error
    ends the run."""
    from diffndm_tpu_torch.chem.io import read_sdf

    if not dock:
        vs = [scorer.score(m) for m in read_sdf(path)]
        return f" Vina~={float(np.mean(vs)):.2f}" if vs else ""
    from diffndm_tpu_torch.chem.dock import dock_molecules

    try:
        batch = dock_molecules(read_sdf(path), scorer, n_restarts=restarts,
                               device=device)
    except ValueError as e:
        print(f"[evaluate] --dock failed on {path} "
              f"({type(e).__name__}: {e})")
        return ""
    vs = [r.affinity for r in batch
          if r is not None and np.isfinite(r.affinity)]
    return f" dock~={float(np.mean(vs)):.2f}" if vs else ""


def file_report(paths, props, expected_per_file: int, scorer=None,
                dock: bool = False, restarts: int = 64,
                device=None) -> str:
    all_rows, lines = [], []
    for path in paths:
        rows = check_sdf_file(path, props)
        valid = [r for r in rows if r[4]]
        ratio = len(valid) / max(expected_per_file, 1)
        name = os.path.basename(path)
        affinity = ("" if scorer is None else
                    affinity_suffix(path, scorer, dock, restarts, device))
        if valid:
            arr = np.array(valid, dtype=float)
            lines.append(
                f"{name}: n={len(rows)} valid_ratio={ratio:.2f} "
                f"QED={arr[:, 0].mean():.3f} SA={arr[:, 1].mean():.3f} "
                f"LogP={arr[:, 2].mean():.3f} "
                f"Lipinski={arr[:, 3].mean():.3f}" + affinity)
        else:
            lines.append(f"{name}: n={len(rows)} valid_ratio=0.00")
        all_rows += valid
    if all_rows:
        arr = np.array(all_rows, dtype=float)
        lines.append(
            f"AGGREGATE over {len(all_rows)} valid molecules: "
            f"QED={arr[:, 0].mean():.3f}+-{arr[:, 0].std():.2f} "
            f"SA={arr[:, 1].mean():.3f}+-{arr[:, 1].std():.2f} "
            f"LogP={arr[:, 2].mean():.3f}+-{arr[:, 2].std():.2f} "
            f"Lipinski={arr[:, 3].mean():.3f}+-{arr[:, 3].std():.2f}")
    return "\n".join(lines)


def main(argv=None):
    """Print the report (and write it to ``--out``); returns its text."""
    args = build_parser().parse_args(argv)
    from diffndm_tpu_torch.chem.metrics import MoleculeProperties

    props = MoleculeProperties()
    paths = ([args.sdf_dir] if args.sdf_dir.endswith(".sdf") else
             sorted(os.path.join(args.sdf_dir, f)
                    for f in os.listdir(args.sdf_dir) if f.endswith(".sdf")))
    scorer = device = None
    if args.receptor and not args.per_step:
        from diffndm_tpu_torch.chem.scoring import VinaScorer

        if args.dock:
            from diffndm_tpu_torch.device import resolve_device

            device = resolve_device(args.device)
        scorer = VinaScorer.from_pdb(args.receptor)
        print("[evaluate] native Vina-style rescoring (Trott-Olson "
              "published weights, UNCALIBRATED vs smina — run "
              "chem.scoring.calibrate_against_smina on a machine with "
              "the binaries to fit per-term scales)")
    report = (per_step_report(paths, props) if args.per_step else
              file_report(paths, props, args.expected_per_file, scorer,
                          args.dock, args.dock_restarts, device))
    print(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report + "\n")
    return report


if __name__ == "__main__":
    main()
