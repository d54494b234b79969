"""Evaluate generated SDF files: per-file and aggregate QED / SA / LogP /
Lipinski and the valid ratio (the reference's my_new_evaluate.py and,
with ``--per_step``, my_new_evaluate_with_step.py).

Example:
    python -m diffndm_tpu_torch.cli.evaluate sweep_out/ \
        --expected_per_file 16 --out report.txt

The report is the JAX package's, line for line.  ``--receptor`` and
``--dock`` need the docking scorer, which this package does not have
yet: they raise.
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
                   help="receptor PDB for an affinity estimate per file; "
                        "needs the docking scorer, which this package "
                        "does not have yet")
    p.add_argument("--dock", action="store_true",
                   help="with --receptor: a pose search per molecule; "
                        "not in this package yet")
    p.add_argument("--dock_restarts", type=int, default=64,
                   help="parallel restarts per molecule for --dock")
    p.add_argument("--per_step", action="store_true",
                   help="group files by the trailing step number in their "
                        "names (e.g. try_100.sdf) and report per-step "
                        "aggregates, sorted by step")
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


def file_report(paths, props, expected_per_file: int) -> str:
    all_rows, lines = [], []
    for path in paths:
        rows = check_sdf_file(path, props)
        valid = [r for r in rows if r[4]]
        ratio = len(valid) / max(expected_per_file, 1)
        name = os.path.basename(path)
        if valid:
            arr = np.array(valid, dtype=float)
            lines.append(
                f"{name}: n={len(rows)} valid_ratio={ratio:.2f} "
                f"QED={arr[:, 0].mean():.3f} SA={arr[:, 1].mean():.3f} "
                f"LogP={arr[:, 2].mean():.3f} "
                f"Lipinski={arr[:, 3].mean():.3f}")
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
    if args.receptor or args.dock:
        raise NotImplementedError(
            "--receptor / --dock need the docking scorer and pose search "
            "(chem/scoring, chem/dock), which this package does not have "
            "yet: ROADMAP Queue A, docking search")
    from diffndm_tpu_torch.chem.metrics import MoleculeProperties

    props = MoleculeProperties()
    paths = ([args.sdf_dir] if args.sdf_dir.endswith(".sdf") else
             sorted(os.path.join(args.sdf_dir, f)
                    for f in os.listdir(args.sdf_dir) if f.endswith(".sdf")))
    report = (per_step_report(paths, props) if args.per_step else
              file_report(paths, props, args.expected_per_file))
    print(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report + "\n")
    return report


if __name__ == "__main__":
    main()
