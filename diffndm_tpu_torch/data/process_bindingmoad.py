"""Binding MOAD ETL: the ``every.csv`` label file -> ligands filtered by
validity, drug-likeness and occurrence -> complexes split by EC class ->
pockets by the 8 A rule -> the processed npz splits and the size
histogram, step for step the JAX package's ``data/process_bindingmoad.py``.
Host work in numpy.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


def read_label_file(csv_path: str) -> Dict[str, list]:
    """``every.csv`` -> {pdb_id: [(ligand_name, validity, ec_number,
    smiles), ...]}.  The file interleaves class/EC rows, PDB rows and
    ligand rows; column 9 of a ligand row is its SMILES."""
    ligand_dict: Dict[str, list] = defaultdict(list)
    pdb_id = None
    ec = None
    with open(csv_path) as f:
        for line in f:
            row = line.strip().split(",")
            if len(row) < 2:
                continue
            if row[0].strip():
                ec = row[0].strip()
            if len(row) > 2 and row[2].strip():
                pdb_id = row[2].strip().lower()
            if len(row) > 3 and row[3].strip() and pdb_id:
                name = row[3].strip()
                validity = row[4].strip() if len(row) > 4 else ""
                smiles = row[9].strip() if len(row) > 9 else ""
                ligand_dict[pdb_id].append((name, validity, ec, smiles))
    return dict(ligand_dict)


def compute_druglikeness(ligand_dict: Dict[str, list]) -> Dict[str, list]:
    """Each ligand entry with its QED appended, from its SMILES (None, with
    a warning, where the SMILES does not parse or score)."""
    import warnings

    from diffndm_tpu_torch.chem.properties import qed
    from diffndm_tpu_torch.chem.smiles import parse_smiles

    out: Dict[str, list] = {}
    for pdb, ligands in ligand_dict.items():
        rows = []
        for entry in ligands:
            name, validity, ec = entry[0], entry[1], entry[2]
            smiles = entry[3] if len(entry) > 3 else ""
            try:
                q = qed(parse_smiles(smiles)) if smiles else None
            except Exception as e:
                warnings.warn(
                    f"could not score ligand {pdb}:{name} from SMILES "
                    f"{smiles!r}: {e}")
                q = None
            rows.append((name, validity, ec, smiles, q))
        out[pdb] = rows
    return out


def filter_and_split(ligand_dict: Dict[str, list],
                     val_fraction: float = 0.05,
                     test_fraction: float = 0.05, seed: int = 0,
                     qed_thresh: float = 0.0,
                     max_occurrences: Optional[int] = None):
    """Keep the 'valid' ligands with QED above ``qed_thresh`` (when > 0),
    at most ``max_occurrences`` per ligand name; then split the complexes
    by EC class, the classes shuffled by ``np.random.default_rng(seed)``,
    so that no enzyme family spans two splits.  Returns (valid, splits)."""
    occ: Dict[str, int] = defaultdict(int)
    valid = {}
    for pdb, ligands in ligand_dict.items():
        keep = []
        for lig in ligands:
            if lig[1].lower() != "valid":
                continue
            if qed_thresh > 0:
                q = lig[4] if len(lig) > 4 else None
                if q is None or q <= qed_thresh:
                    continue
            name = lig[0].split(":")[0]
            if max_occurrences is not None:
                if occ[name] >= max_occurrences:
                    continue
                occ[name] += 1
            keep.append(lig)
        if keep:
            valid[pdb] = keep

    by_ec: Dict[str, List[str]] = defaultdict(list)
    for pdb, ligands in valid.items():
        ec = ligands[0][2] or "unknown"
        by_ec[ec.split(".")[0] if "." in ec else ec].append(pdb)

    groups = list(by_ec.values())
    np.random.default_rng(seed).shuffle(groups)
    n_total = sum(len(g) for g in groups)
    splits = {"train": [], "val": [], "test": []}
    for g in groups:
        if len(splits["test"]) < test_fraction * n_total:
            splits["test"] += g
        elif len(splits["val"]) < val_fraction * n_total:
            splits["val"] += g
        else:
            splits["train"] += g
    return valid, splits


def process_bindingmoad(data_dir: str, every_csv: str, outdir: str,
                        dataset_info: Optional[dict] = None,
                        dist_cutoff: float = 8.0, ca_only: bool = False,
                        qed_thresh: float = 0.3,
                        max_occurrences: Optional[int] = 50):
    """The whole pipeline over ``<data_dir>/<pdb_id>.bio1`` (or ``.pdb``)
    files.  A ligand is the first non-standard residue named by its label
    (first three letters); its pocket, the standard residues with an atom
    within ``dist_cutoff`` of it.  Writes ``<split>.npz`` and
    ``size_distribution.npy`` to ``outdir``; returns {split: pairs}."""
    from diffndm_tpu_torch.constants import dataset_params
    from diffndm_tpu_torch.data.dataset import (LigandPocketPair,
                                                save_npz_split)
    from diffndm_tpu_torch.data.pdb import parse_pdb
    from diffndm_tpu_torch.data.process_crossdock import pocket_residues
    from diffndm_tpu_torch.diffusion.node_distribution import \
        smoothed_histogram

    di = dataset_info or dataset_params["bindingmoad"]
    atom_enc = di["atom_encoder"]
    aa_enc = di["aa_encoder"] if ca_only else di["atom_encoder"]

    ligand_dict = read_label_file(every_csv)
    if qed_thresh > 0:
        ligand_dict = compute_druglikeness(ligand_dict)
    valid, splits = filter_and_split(ligand_dict, qed_thresh=qed_thresh,
                                     max_occurrences=max_occurrences)
    os.makedirs(outdir, exist_ok=True)

    def process_pdb(pdb_id):
        path = os.path.join(data_dir, f"{pdb_id}.bio1")
        if not os.path.exists(path):
            path = os.path.join(data_dir, f"{pdb_id}.pdb")
        if not os.path.exists(path):
            return []
        structure = parse_pdb(path)
        out = []
        for entry in valid.get(pdb_id, []):
            resname = entry[0].split(":")[0][:3]
            lig = next((r for r in structure.residues
                        if r.resname == resname and not r.is_standard_aa),
                       None)
            if lig is None:
                continue
            heavy = [a for a in lig.atoms if a.element != "H"]
            types = [atom_enc.get(a.element) for a in heavy]
            if None in types or len(heavy) < 2:
                continue
            coords = np.array([a.coord for a in heavy], np.float32)
            pocket_res = pocket_residues(structure, coords, dist_cutoff)
            if not pocket_res:
                continue
            if ca_only:
                with_ca = [r for r in pocket_res if r.ca is not None]
                pc = np.array([r.ca.coord for r in with_ca], np.float32)
                pt = [aa_enc[r.one_letter] for r in with_ca]
            else:
                atoms = [a for r in pocket_res for a in r.atoms
                         if a.element != "H" and a.element in aa_enc]
                pc = np.array([a.coord for a in atoms], np.float32)
                pt = [aa_enc[a.element] for a in atoms]
            out.append(LigandPocketPair(
                coords,
                np.eye(len(atom_enc), dtype=np.float32)[np.array(types)],
                pc,
                np.eye(len(aa_enc), dtype=np.float32)[np.array(pt)],
                name=f"{pdb_id}_{resname}"))
        return out

    split_pairs = {}
    for split, pdbs in splits.items():
        pairs = [p for pdb in pdbs for p in process_pdb(pdb)]
        split_pairs[split] = pairs
        if pairs:
            save_npz_split(os.path.join(outdir, f"{split}.npz"), pairs)

    train = split_pairs.get("train") or sum(split_pairs.values(), [])
    if train:
        hist = smoothed_histogram([len(p.lig_coords) for p in train],
                                  [len(p.pocket_coords) for p in train])
        np.save(os.path.join(outdir, "size_distribution.npy"), hist)
    return split_pairs
