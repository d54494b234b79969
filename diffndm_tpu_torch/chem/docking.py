"""Docking-score wrappers (smina / qvina2) and the batch docking CLI.

The binaries are external tools; every entry point probes for them and
raises DockingUnavailable when they are absent, so that callers can gate
docking metrics.  ``--engine native`` docks with this package's batched
pose search (chem/dock.py) instead, on the GPU unless ``--device cpu``:

    python -m diffndm_tpu_torch.chem.docking --engine native \
        --pdbqt_dir receptors/ --sdf_dir ligands/ --out_dir out/ \
        --write_csv --write_dict
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from typing import List, Sequence

import numpy as np


class DockingUnavailable(RuntimeError):
    pass


def _require(binary: str) -> str:
    path = shutil.which(binary)
    if path is None:
        raise DockingUnavailable(
            f"{binary} binary not found on PATH; binary-parity docking "
            f"is disabled in this environment (chem/scoring.py provides "
            f"native Vina-style rescoring and chem/dock.py a native "
            f"batched pose search — the qvina2 analogue)")
    return path


def smina_score(rdmol_sdf_paths: Sequence[str], receptor_file: str
                ) -> List[float]:
    """smina --score_only affinity per ligand."""
    smina = _require("smina")
    scores = []
    for sdf in rdmol_sdf_paths:
        out = subprocess.run(
            [smina, "-l", sdf, "-r", receptor_file, "--score_only"],
            capture_output=True, text=True, check=False)
        matches = re.findall(r"Affinity:\s*(-?\d+(?:\.\d+)?)", out.stdout)
        scores.append(float(matches[0]) if matches else float("nan"))
    return scores


def sdf_to_pdbqt(sdf_file: str, pdbqt_outfile: str) -> str:
    """obabel conversion."""
    obabel = _require("obabel")
    subprocess.run([obabel, sdf_file, "-O", pdbqt_outfile,
                    "-f", "1", "-l", "1"], check=True,
                   capture_output=True)
    return pdbqt_outfile


def calculate_qvina2_score(receptor_file: str, sdf_file: str, out_dir: str,
                           size: int = 20, exhaustiveness: int = 16,
                           return_rdmol: bool = False) -> List[float]:
    """Full qvina2 docking run: receptor pdbqt + ligand pdbqt, box centred
    at the ligand COM."""
    qvina = _require("qvina2.1") if shutil.which("qvina2.1") else \
        _require("qvina2")
    os.makedirs(out_dir, exist_ok=True)

    receptor_pdbqt = receptor_file
    if not receptor_file.endswith(".pdbqt"):
        receptor_pdbqt = os.path.join(
            out_dir, os.path.basename(receptor_file) + "qt")
        if not os.path.exists(receptor_pdbqt):
            _require("obabel")
            subprocess.run(["obabel", receptor_file, "-O", receptor_pdbqt,
                            "-xr"], check=True, capture_output=True)

    from diffndm_tpu_torch.chem.io import read_sdf

    scores = []
    for i, mol in enumerate(read_sdf(sdf_file)):
        center = np.asarray(mol.coords).mean(0)
        lig_pdbqt = os.path.join(out_dir, f"lig_{i}.pdbqt")
        one_sdf = os.path.join(out_dir, f"lig_{i}.sdf")
        from diffndm_tpu_torch.chem.io import write_sdf

        write_sdf(one_sdf, [mol])
        sdf_to_pdbqt(one_sdf, lig_pdbqt)
        out = subprocess.run(
            [qvina, "--receptor", receptor_pdbqt, "--ligand", lig_pdbqt,
             "--center_x", str(center[0]), "--center_y", str(center[1]),
             "--center_z", str(center[2]), "--size_x", str(size),
             "--size_y", str(size), "--size_z", str(size),
             "--exhaustiveness", str(exhaustiveness)],
            capture_output=True, text=True, check=False)
        m = re.findall(r"^\s*1\s+(-?\d+\.\d+)", out.stdout, re.MULTILINE)
        scores.append(float(m[0]) if m else float("nan"))
    return scores


def docking_available() -> bool:
    return shutil.which("smina") is not None or \
        shutil.which("qvina2") is not None


def _main(argv=None):
    """Batch docking scorer over an SDF directory: ligand file names map
    to receptors by the moad (``<receptor>_<pocket>_*.sdf``) or
    crossdocked (stem minus 4 chars) convention; scores written to
    ``qvina2_scores.csv``.  ``--engine native`` (the default when no
    binaries exist) uses the batched pose search (chem/dock.py) against
    receptor .pdb files, on ``--device``, instead of qvina2 against
    .pdbqt."""
    import argparse
    import csv
    import glob
    import json

    ap = argparse.ArgumentParser(description="QuickVina evaluation")
    ap.add_argument("--pdbqt_dir", type=str, required=True,
                    help="receptor dir (.pdbqt for qvina2, .pdb for "
                         "the native engine)")
    ap.add_argument("--sdf_dir", type=str, default=None)
    ap.add_argument("--sdf_files", type=str, nargs="+", default=None)
    ap.add_argument("--out_dir", type=str, required=True)
    ap.add_argument("--write_csv", action="store_true")
    ap.add_argument("--write_dict", action="store_true",
                    help="also write qvina2_scores.json (the reference "
                         "pickles a torch dict; JSON here)")
    ap.add_argument("--dataset", choices=("moad", "crossdocked"),
                    default="moad")
    ap.add_argument("--engine", choices=("qvina2", "native"),
                    default="qvina2" if docking_available() else "native")
    ap.add_argument("--restarts", type=int, default=64)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the native engine; cpu runs "
                         "the search on the CPU")
    args = ap.parse_args(argv)

    assert (args.sdf_dir is None) ^ (args.sdf_files is None), \
        "exactly one of --sdf_dir / --sdf_files"
    os.makedirs(args.out_dir, exist_ok=True)
    sdf_files = sorted(
        p for p in glob.glob(os.path.join(args.sdf_dir, "*.sdf"))
        if not os.path.basename(p).startswith(".")) \
        if args.sdf_dir else list(args.sdf_files)

    rows, as_dict = [], {}
    for sdf in sdf_files:
        stem = os.path.splitext(os.path.basename(sdf))[0]
        if args.dataset == "moad":
            receptor_name = stem.split("_")[0]
        else:
            receptor_name = stem[:-4]
        ext = ".pdbqt" if args.engine == "qvina2" else ".pdb"
        receptor = os.path.join(args.pdbqt_dir, receptor_name + ext)
        try:
            if args.engine == "qvina2":
                scores = calculate_qvina2_score(receptor, sdf,
                                                args.out_dir)
            else:
                from diffndm_tpu_torch.chem.dock import \
                    calculate_native_dock_score

                # out_dir passthrough: the native engine writes docked
                # poses next to the CSV, matching the qvina2 branch
                scores = calculate_native_dock_score(
                    receptor, sdf, out_dir=args.out_dir,
                    n_restarts=args.restarts, device=args.device)
        except (DockingUnavailable, FileNotFoundError) as e:
            print(f"{stem}: skipped ({e})")
            continue
        print(f"{stem}: {['%.2f' % s for s in scores]}")
        rows.append((receptor, sdf, scores))
        as_dict[stem] = {"receptor": receptor, "ligand": sdf,
                         "scores": scores}
    if args.write_csv:
        with open(os.path.join(args.out_dir, "qvina2_scores.csv"),
                  "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["receptor", "ligand", "scores"])
            w.writerows(rows)
    if args.write_dict:
        with open(os.path.join(args.out_dir, "qvina2_scores.json"),
                  "w") as f:
            json.dump(as_dict, f, indent=1)


if __name__ == "__main__":
    _main()
