"""CrossDocked ETL: (receptor PDB, ligand SDF) pairs -> the processed npz
splits the trainer reads, plus the dataset's statistics.

Host work in numpy on the port's PDB and SDF parsers, step for step the
JAX package's ``data/process_crossdock.py``:

- the pocket is every standard residue with an atom closer than
  ``dist_cutoff`` (8 A, strict) to a ligand atom, the distances taken in
  float64 (the PDB coordinates are float64, the ligand's float32), then
  full-atom or CA-only one-hot encodings;
- the smoothed joint (N_lig, N_pocket) size histogram (sigma 1);
- the atom and amino-acid type histograms;
- the training set's molecular identity keys (``train_smiles.npy``) for
  the novelty metric;
- optional training subsampling (``train_subsample``);
- a fixed-name split (``split_by_name.pt`` or ``.json``) whose val split
  is ``val_from_train`` training pairs, or a seeded fraction split;
- the val/test export: each receptor PDB and ligand SDF copied beside the
  npz with the pocket-residue txt.

``python -m diffndm_tpu_torch.data.process_crossdock <basedir> --outdir
<out>`` reads ``<basedir>/split_by_name.pt`` and the
``<basedir>/crossdocked_pocket10`` tree.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from diffndm_tpu_torch.chem.io import read_sdf
from diffndm_tpu_torch.data.dataset import LigandPocketPair, save_npz_split
from diffndm_tpu_torch.data.pdb import parse_pdb


def pocket_residues(structure, lig_coords: np.ndarray,
                    dist_cutoff: float) -> list:
    """Standard residues with an atom closer than ``dist_cutoff`` to the
    ligand (float64 distances)."""
    out = []
    for res in structure.residues:
        if not res.is_standard_aa:
            continue
        d = np.linalg.norm(res.coords()[:, None] - lig_coords[None], axis=-1)
        if d.min() < dist_cutoff:
            out.append(res)
    return out


def process_ligand_and_pocket(pdbfile: str, sdffile: str,
                              atom_encoder: dict, pocket_encoder: dict,
                              dist_cutoff: float = 8.0,
                              ca_only: bool = False,
                              ) -> Optional[LigandPocketPair]:
    """One (receptor, ligand) pair -> coordinate and one-hot arrays; None
    for an unknown ligand element or an empty pocket."""
    mol = read_sdf(sdffile)[0]
    keep = [i for i, s in enumerate(mol.symbols) if s != "H"]
    lig_coords = np.asarray(mol.coords)[keep].astype(np.float32)
    lig_types = []
    for i in keep:
        t = atom_encoder.get(mol.symbols[i], atom_encoder.get("others"))
        if t is None:
            return None
        lig_types.append(t)
    lig_one_hot = np.eye(len(atom_encoder),
                         dtype=np.float32)[np.asarray(lig_types)]

    pocket_res = pocket_residues(parse_pdb(pdbfile), lig_coords,
                                 dist_cutoff)
    if not pocket_res:
        return None
    coords, types = [], []
    if ca_only:
        for res in pocket_res:
            if res.ca is None:
                continue
            coords.append(res.ca.coord)
            types.append(pocket_encoder[res.one_letter])
    else:
        for res in pocket_res:
            for a in res.atoms:
                if a.element == "H":
                    continue
                t = pocket_encoder.get(a.element,
                                       pocket_encoder.get("others"))
                if t is None:
                    continue
                coords.append(a.coord)
                types.append(t)
    pocket_coords = np.asarray(coords, np.float32)
    pocket_one_hot = np.eye(len(pocket_encoder),
                            dtype=np.float32)[np.asarray(types)]
    name = os.path.basename(pdbfile).replace(".pdb", "") + "_" + \
        os.path.basename(sdffile).replace(".sdf", "")
    return LigandPocketPair(lig_coords, lig_one_hot, pocket_coords,
                            pocket_one_hot, name)


def pocket_residue_ids(pdbfile: str, lig_coords: np.ndarray,
                       dist_cutoff: float = 8.0) -> List[str]:
    """'<chain>:<resi>' of each pocket residue: the per-complex txt of the
    val/test export."""
    return [f"{res.chain}:{res.resi}" for res in
            pocket_residues(parse_pdb(pdbfile), lig_coords, dist_cutoff)]


def load_split_file(path: str) -> Dict[str, List[Tuple[str, str]]]:
    """A fixed-name split, {'train'|'test'[|'val']: [(pocket_fn, ligand_fn),
    ...]}: a torch pickle (``split_by_name.pt``) or the same as JSON."""
    if path.endswith(".pt"):
        import torch

        return torch.load(path, map_location="cpu", weights_only=False)
    import json

    with open(path) as f:
        return {k: [tuple(x) for x in v] for k, v in json.load(f).items()}


@dataclass
class ProcessedSplits:
    outdir: str
    histogram: np.ndarray
    atom_hist: Dict[str, int]
    aa_hist: Dict[str, int]


def process_dataset(pairs: Sequence[Tuple[str, str]], outdir: str,
                    atom_encoder: dict, pocket_encoder: dict,
                    split_fractions=(0.9, 0.05, 0.05),
                    dist_cutoff: float = 8.0, ca_only: bool = False,
                    train_subsample: float = 1.0, seed: int = 0,
                    dataset_info: Optional[dict] = None,
                    split_names: Optional[dict] = None,
                    basedir: Optional[str] = None,
                    val_from_train: int = 300,
                    export_test_data: bool = True) -> ProcessedSplits:
    """(pdb, sdf) path pairs -> train/val/test npz and the statistics files
    in ``outdir``.

    split_names: a fixed-name split (see ``load_split_file``), its paths
    relative to ``basedir`` when given; ``pairs`` and ``split_fractions``
    are then ignored, and without a 'val' entry the val split is
    ``val_from_train`` training pairs drawn with ``random.Random(seed)``.
    Otherwise the processed pairs are permuted by
    ``np.random.default_rng(seed)`` and cut by ``split_fractions``.
    export_test_data: copy each val/test receptor PDB and ligand SDF and
    write its pocket-residue txt beside the npz.  A pair that fails to
    parse or has no pocket is dropped.
    """
    import random as _random
    import shutil

    from diffndm_tpu_torch.chem.bonds import build_molecule
    from diffndm_tpu_torch.diffusion.node_distribution import \
        smoothed_histogram

    os.makedirs(outdir, exist_ok=True)

    def process_list(pair_list):
        out = []
        for pdbfile, sdffile in pair_list:
            if basedir is not None:
                pdbfile = os.path.join(basedir, pdbfile)
                sdffile = os.path.join(basedir, sdffile)
            try:
                pair = process_ligand_and_pocket(
                    pdbfile, sdffile, atom_encoder, pocket_encoder,
                    dist_cutoff, ca_only)
            except Exception:
                pair = None
            if pair is not None:
                out.append((pair, pdbfile, sdffile))
        return out

    if split_names is not None:
        rnd = _random.Random(seed)
        named = dict(split_names)
        if "val" not in named and named.get("train"):
            named["val"] = rnd.sample(
                list(named["train"]),
                min(val_from_train, len(named["train"])))
        split_items = {k: process_list(v) for k, v in named.items()}
    else:
        processed = process_list(pairs)
        order = np.random.default_rng(seed).permutation(len(processed))
        n = len(processed)
        n_train = int(split_fractions[0] * n)
        n_val = int(split_fractions[1] * n)
        split_items = {
            "train": [processed[i] for i in order[:n_train]],
            "val": [processed[i] for i in order[n_train:n_train + n_val]],
            "test": [processed[i] for i in order[n_train + n_val:]],
        }
    if train_subsample < 1.0 and split_items["train"]:
        k = max(1, int(len(split_items["train"]) * train_subsample))
        split_items["train"] = split_items["train"][:k]

    if export_test_data:
        for split in ("val", "test"):
            items = split_items.get(split, [])
            if not items:
                continue
            pdb_sdf_dir = os.path.join(outdir, split)
            os.makedirs(pdb_sdf_dir, exist_ok=True)
            for pair, pdbfile, sdffile in items:
                rec = os.path.basename(pdbfile)[:-4].replace("_", "-")
                shutil.copy(pdbfile,
                            os.path.join(pdb_sdf_dir, rec + ".pdb"))
                lig = rec + "_" + \
                    os.path.basename(sdffile)[:-4].replace("_", "-")
                shutil.copy(sdffile,
                            os.path.join(pdb_sdf_dir, lig + ".sdf"))
                ids = pocket_residue_ids(pdbfile, pair.lig_coords,
                                         dist_cutoff)
                with open(os.path.join(pdb_sdf_dir, lig + ".txt"),
                          "w") as f:
                    f.write(" ".join(ids))

    splits = {k: [it[0] for it in v] for k, v in split_items.items()}
    for name, ps in splits.items():
        if ps:
            save_npz_split(os.path.join(outdir, f"{name}.npz"), ps)

    # statistics of the train split (of every split when it is empty)
    train = splits["train"] or [p for ps in splits.values() for p in ps]
    hist = smoothed_histogram([len(p.lig_coords) for p in train],
                              [len(p.pocket_coords) for p in train])
    np.save(os.path.join(outdir, "size_distribution.npy"), hist)

    atom_list = list(atom_encoder)
    atom_hist = {a: 0 for a in atom_list}
    for p in train:
        for t in p.lig_one_hot.argmax(-1):
            atom_hist[atom_list[int(t)]] += 1
    aa_list = list(pocket_encoder)
    aa_hist = {a: 0 for a in aa_list}
    for p in train:
        for t in p.pocket_one_hot.argmax(-1):
            aa_hist[aa_list[int(t)]] += 1

    # the training molecules' identity keys, for the novelty metric
    if dataset_info is not None:
        keys = []
        for p in train:
            try:
                mol = build_molecule(p.lig_coords,
                                     p.lig_one_hot.argmax(-1), dataset_info)
                keys.append(mol.canonical_smiles_like())
            except Exception:
                continue
        np.save(os.path.join(outdir, "train_smiles.npy"), np.array(keys))

    # the bond-length tables and Lennard-Jones r_m of the atom encoding, in
    # the summary.txt layout of a dataset_params entry
    from diffndm_tpu_torch.constants import (BONDS1, BONDS2, BONDS3,
                                             _lj_table, _sym_table)

    with open(os.path.join(outdir, "summary.txt"), "w") as f:
        f.write("# SUMMARY\n\n# After processing\n")
        for name, ps in splits.items():
            f.write(f"num_samples {name}: {len(ps)}\n")
        f.write("\n# Info\n")
        f.write(f"'atom_encoder': {dict(atom_encoder)}\n")
        f.write(f"'atom_decoder': {atom_list}\n")
        f.write(f"'aa_encoder': {dict(pocket_encoder)}\n")
        f.write(f"'aa_decoder': {aa_list}\n")
        f.write(f"'bonds1': {_sym_table(BONDS1, atom_list).tolist()}\n")
        f.write(f"'bonds2': {_sym_table(BONDS2, atom_list).tolist()}\n")
        f.write(f"'bonds3': {_sym_table(BONDS3, atom_list).tolist()}\n")
        f.write(f"'lennard_jones_rm': {_lj_table(atom_list).tolist()}\n")
        f.write(f"'atom_hist': {atom_hist}\n")
        f.write(f"'aa_hist': {aa_hist}\n")

    return ProcessedSplits(outdir, hist, atom_hist, aa_hist)


def main(argv=None):
    """<basedir> holds split_by_name.pt (or pass --split_file) and the
    crossdocked_pocket10 tree the split's paths are relative to."""
    import argparse

    from diffndm_tpu_torch.constants import dataset_params

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("basedir", type=str)
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--split_file", type=str, default=None,
                   help="split_by_name.pt / .json; default "
                        "<basedir>/split_by_name.pt")
    p.add_argument("--no_H", action="store_true", default=True)
    p.add_argument("--ca_only", action="store_true")
    p.add_argument("--dist_cutoff", type=float, default=8.0)
    p.add_argument("--random_seed", type=int, default=42)
    p.add_argument("--train_subsample", type=float, default=1.0,
                   help="keep this fraction of the train complexes")
    p.add_argument("--no_export", action="store_true",
                   help="skip the per-pocket val/test pdb/sdf/txt export")
    args = p.parse_args(argv)

    split_path = args.split_file or os.path.join(args.basedir,
                                                 "split_by_name.pt")
    split_names = load_split_file(split_path)
    di = dataset_params["crossdock" if args.ca_only else "crossdock_full"]
    enc = di["atom_encoder"]
    pocket_enc = di["aa_encoder"] if args.ca_only else di["atom_encoder"]
    return process_dataset(None, args.outdir, enc, pocket_enc,
                           dist_cutoff=args.dist_cutoff,
                           ca_only=args.ca_only,
                           train_subsample=args.train_subsample,
                           seed=args.random_seed, dataset_info=di,
                           split_names=split_names,
                           basedir=os.path.join(args.basedir,
                                                "crossdocked_pocket10"),
                           export_test_data=not args.no_export)


if __name__ == "__main__":
    main()
