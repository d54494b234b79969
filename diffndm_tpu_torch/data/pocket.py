"""Pocket extraction from a PDB structure and the padded pocket batch.

The pocket is every standard-amino-acid residue with an atom closer than
the cutoff to the reference ligand (an SDF file, or ``<chain>:<resi>`` of
a residue of the structure itself, which is then left out).  Its atoms
(full-atom: every heavy atom whose element the encoder knows; CA: one
node per residue, typed by amino acid) become a ``NodeBatch`` repeated
once per sample and padded to a multiple of ``pad_multiple`` rows.  A
single ligand becomes a padded one-sample batch the same way (the inputs
of inpainting and of the evolutionary optimizer).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from diffndm_tpu_torch.data.pdb import PDBStructure, Residue
from diffndm_tpu_torch.structs import NodeBatch, pad_to


def ligand_coords_from_ref(structure: PDBStructure, ref_ligand: str
                           ) -> Tuple[np.ndarray, Optional[int]]:
    """The reference ligand's coordinates and, for ``<chain>:<resi>``, its
    residue number (None for an SDF path)."""
    if ref_ligand.endswith(".sdf"):
        from diffndm_tpu_torch.chem.io import read_sdf

        return np.asarray(read_sdf(ref_ligand)[0].coords), None
    chain, resi = ref_ligand.split(":")
    return structure.get_residue(chain, int(resi)).coords(), int(resi)


def get_pocket_from_ligand(structure: PDBStructure, ref_ligand: str,
                           dist_cutoff: float = 8.0) -> List[Residue]:
    """Standard-AA residues with any atom within ``dist_cutoff`` of the
    ligand.  A ``<chain>:<resi>`` reference skips every residue with that
    number, in any chain."""
    lig_coords, resi = ligand_coords_from_ref(structure, ref_ligand)
    pocket = []
    for res in structure.residues:
        if resi is not None and res.resi == resi:
            continue
        if not res.is_standard_aa:
            continue
        d = np.linalg.norm(res.coords()[:, None, :] - lig_coords[None, :, :],
                           axis=-1)
        if d.min() < dist_cutoff:
            pocket.append(res)
    return pocket


def prepare_pocket(residues: Sequence[Residue], type_encoder: dict,
                   representation: str = "full-atom", repeats: int = 1,
                   pad_multiple: int = 32, device="cpu") -> NodeBatch:
    """Residues -> a float32 NodeBatch [repeats, N, len(type_encoder)].

    Full-atom: hydrogens are dropped, an element the encoder lacks takes
    its "others" type, or is dropped when it has none.  CA: residues
    without a CA atom are dropped."""
    coords, types = [], []
    if representation == "CA":
        for res in residues:
            ca = res.ca
            if ca is None:
                continue
            coords.append(ca.coord)
            types.append(type_encoder[res.one_letter])
    else:
        for res in residues:
            for a in res.atoms:
                if a.element == "H":
                    continue
                t = type_encoder.get(a.element, type_encoder.get("others"))
                if t is None:
                    continue
                coords.append(a.coord)
                types.append(t)
    return _typed_batch(coords, types, len(type_encoder), repeats,
                        pad_to(len(coords), pad_multiple), device)


def ligand_node_batch(coords: np.ndarray, types: np.ndarray,
                      type_encoder: dict, pad_multiple: int = 8,
                      n_total: Optional[int] = None,
                      device="cpu") -> NodeBatch:
    """One ligand -> a padded 1-sample float32 NodeBatch [1, N, F] with
    F = len(type_encoder); N is ``n_total`` if given, else the atom count
    rounded up to ``pad_multiple``."""
    n_pad = n_total if n_total is not None else pad_to(len(coords),
                                                       pad_multiple)
    return _typed_batch(coords, types, len(type_encoder), 1, n_pad, device)


def _typed_batch(coords, types, n_feat: int, repeats: int, n_pad: int,
                 device) -> NodeBatch:
    """n atoms (coordinates, type indices) -> a float32 NodeBatch
    [repeats, n_pad, n_feat], one-hot types, zeros in the padding."""
    coords = np.asarray(coords, np.float32)
    types = np.asarray(types, np.int64)
    n = len(coords)
    x = np.zeros((repeats, n_pad, 3), np.float32)
    h = np.zeros((repeats, n_pad, n_feat), np.float32)
    mask = np.zeros((repeats, n_pad), np.float32)
    x[:, :n] = coords[None]
    h[:, :n] = np.eye(n_feat, dtype=np.float32)[types][None]
    mask[:, :n] = 1.0
    return NodeBatch(torch.from_numpy(x), torch.from_numpy(h),
                     torch.from_numpy(mask)).to(device)
